"""RoaringBitmapWriter: the builder wizard and its two appenders.

The port's own copy of ``roaringbitmap_tpu.core.writer`` (the reference's
``RoaringBitmapWriter``): a fluent ``Wizard`` and two appender strategies,
the buffered one (values gathered in NumPy arrays and flushed through the
vectorized bulk constructor) and ``constant_memory()`` (one fixed 8 KiB
dense scratch chunk reused for every key).  The wizard's knobs are kept:
optimise_for_arrays / optimise_for_runs / constant_memory /
initial_capacity / expected_range / expected_container_size /
expected_density / partially_sort_values / do_partial_radix_sort /
run_compress / fast_rank.
"""

from __future__ import annotations

import numpy as np

from . import containers as C
from .bitmap import RoaringBitmap


class RoaringBitmapWriter:
    """Buffered, out-of-order-tolerant bitmap builder.

    ``wizard()`` returns a Wizard; ``Wizard.get()`` returns a writer.
    """

    def __init__(self, constant_memory: bool = False,
                 initial_capacity: int = 16,
                 expected_container_size: int = 16,
                 optimize_for_runs: bool = False,
                 partially_sort: bool = False,
                 run_compress: bool = True,
                 expected_range: tuple[int, int] | None = None,
                 result_cls=None):
        self.result_cls = result_cls or RoaringBitmap
        self.constant_memory = constant_memory
        self.optimize_for_runs = optimize_for_runs
        self.partially_sort = partially_sort
        self.run_compress = run_compress
        self.expected_container_size = expected_container_size
        self.initial_capacity = initial_capacity
        self.expected_range = expected_range
        # constant memory keeps one fixed dense scratch chunk; the buffered
        # appender grows a value list per flush
        self._scratch = (np.zeros(C.WORDS_PER_CONTAINER, dtype=np.uint64)
                         if constant_memory else None)
        self._scratch_key: int | None = None
        self._scratch_dirty = False
        self._pending: list[np.ndarray] = []
        self._result = self.result_cls()

    @staticmethod
    def wizard() -> "Wizard":
        return Wizard()

    # the writer() / bufferWriter() entry points
    @staticmethod
    def writer() -> "Wizard":
        return Wizard()

    # ------------------------------------------------------------------ adds
    def add(self, value: int) -> None:
        if self._scratch is not None:
            hb = value >> 16
            if hb != self._scratch_key:
                self._flush_scratch()
                self._scratch_key = hb
            self._scratch[(value & 0xFFFF) >> 6] |= np.uint64(
                1 << (value & 63))
            self._scratch_dirty = True
        else:
            self._pending.append(np.array([value], dtype=np.uint32))

    def add_many(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.uint32)
        if self._scratch is not None:
            for x in v:  # the constant-memory contract: no buffering
                self.add(int(x))
        else:
            self._pending.append(v)

    def add_range(self, start: int, stop: int) -> None:
        self.flush()
        self._result.add_range(start, stop)

    # ----------------------------------------------------------------- flush
    def _flush_scratch(self) -> None:
        if self._scratch is None or not self._scratch_dirty:
            return
        card = C.popcount_words(self._scratch)
        cont = C.from_words(self._scratch.copy(), card)
        if self.run_compress:
            cont = cont.run_optimize()
        tmp = RoaringBitmap(np.array([self._scratch_key], dtype=np.uint16),
                            [cont])
        self._result.ior(tmp)
        self._scratch[:] = 0
        self._scratch_dirty = False

    def flush(self) -> None:
        """Drain the buffered values into the result (the appenders'
        flush)."""
        if self._scratch is not None:
            self._flush_scratch()
            return
        if not self._pending:
            return
        vals = np.concatenate(self._pending)
        self._pending = []
        chunk = RoaringBitmap.from_values(vals)
        # run_compress (default on) governs the flush-time run optimize of
        # both appenders; optimise_for_runs only biases the starting
        # container type in the reference
        if self.run_compress:
            chunk.run_optimize()
        self._result.ior(chunk)  # O(delta): touches only the chunk's keys

    def get(self) -> RoaringBitmap:
        """Flush and return the built bitmap."""
        self.flush()
        if self.run_compress:
            self._result.run_optimize()
        return self._result

    def get_underlying(self) -> RoaringBitmap:
        """The underlying bitmap without a flush (getUnderlying: buffered
        adds are not visible until ``flush()``)."""
        return self._result

    def reset(self) -> None:
        self._pending = []
        self._result = self.result_cls()
        if self._scratch is not None:
            self._scratch[:] = 0
            self._scratch_dirty = False
            self._scratch_key = None


class Wizard:
    """Fluent configuration of a RoaringBitmapWriter."""

    def __init__(self):
        self._result_cls = None
        self._constant_memory = False
        self._optimize_for_runs = False
        self._partially_sort = False
        self._run_compress = True
        self._initial_capacity = 16
        self._expected_container_size = 16
        self._expected_range: tuple[int, int] | None = None

    def optimise_for_arrays(self) -> "Wizard":
        self._optimize_for_runs = False
        return self

    def optimise_for_runs(self) -> "Wizard":
        self._optimize_for_runs = True
        return self

    def constant_memory(self) -> "Wizard":
        self._constant_memory = True
        return self

    def initial_capacity(self, n: int) -> "Wizard":
        self._initial_capacity = n
        return self

    def expected_container_size(self, n: int) -> "Wizard":
        self._expected_container_size = n
        return self

    def expected_range(self, lo: int, hi: int) -> "Wizard":
        self._expected_range = (lo, hi)
        return self

    def expected_density(self, d: float) -> "Wizard":
        self._expected_container_size = max(1, int(d * 65536))
        return self

    def partially_sort_values(self) -> "Wizard":
        self._partially_sort = True
        return self

    def do_partial_radix_sort(self) -> "Wizard":
        return self.partially_sort_values()

    def run_compress(self, enabled: bool) -> "Wizard":
        self._run_compress = enabled
        return self

    def fast_rank(self) -> "Wizard":
        """fastRank(): the built bitmap is a FastRankRoaringBitmap (one
        writer serves both tiers here; the reference's buffer wizard
        throws)."""
        from .fastrank import FastRankRoaringBitmap

        self._result_cls = FastRankRoaringBitmap
        return self

    def get(self) -> RoaringBitmapWriter:
        return RoaringBitmapWriter(
            constant_memory=self._constant_memory,
            initial_capacity=self._initial_capacity,
            expected_container_size=self._expected_container_size,
            optimize_for_runs=self._optimize_for_runs,
            partially_sort=self._partially_sort,
            run_compress=self._run_compress,
            expected_range=self._expected_range,
            result_cls=self._result_cls)
