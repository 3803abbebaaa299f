"""The entry a traffic mix drives, as a measured closed loop.

``aggregate_device``: ``DeviceBitmapSet.aggregate_device`` over the whole
resident set, ``in_flight`` ops enqueued ahead: op ``i + in_flight`` is
enqueued before op ``i``'s cardinality is read back.  The result words stay
on the card; an op completes when its exact cardinality (the sum of its
per-key cardinalities, summed on the card) is on the host.

The loop runs ``seconds`` of window from its first timed call; what
completes in it is counted, what is in flight at its close is waited for
and kept for the check, but not counted.

The harness's own host work an op is its cardinality sum, one copy and
one event record (from a ring made before the window); its host ranges,
for charging a traced run's idle gaps, open only while tracing.  Each
costs tens of microseconds, and an op of a sparse set costs the card
under 0.2 ms: more would pace the loop by the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

from . import gen

#: a host range the profiler shows, for charging idle gaps
from torch.profiler import record_function as _range


@dataclasses.dataclass
class Outcome:
    seconds: float
    completed: int                 # ops done in the window
    units: int                     # ops run, window and drain
    work_bytes: int                # frozen count of everything run
    host_ms: list                  # harness span around each call
    answers: dict                  # what the check compares


def _sample_positions(n_ops: int, ops: list, k0: int) -> dict:
    """The first op of each kind at or after ``k0``: whose heads are kept."""
    out = {}
    for i in range(k0, n_ops):
        out.setdefault(ops[i], i)
        if len(out) == len(set(ops)):
            break
    return {i: op for op, i in out.items()}


def _no_range(name: str):
    return contextlib.nullcontext()


def wide(ds, mix: dict, seed: int, seconds: float, op_bytes: int,
         torch, warmup: bool = False, trace: bool = False) -> Outcome:
    """The closed loop of wide ops (see the module docstring).  With
    ``warmup`` it runs ``mix["warmup_ops"]`` ops of every kind and
    returns; with ``trace`` it opens its host ranges."""
    depth = int(mix["in_flight"])
    cuda = ds.device.type == "cuda"
    if warmup:
        for op in sorted(mix["ops"]) * int(mix["warmup_ops"]):
            words, cards = ds.aggregate_device(op)
            int(cards.sum(dtype=torch.int64))
        if cuda:
            torch.cuda.synchronize(ds.device)
        return None
    n_max = int(mix["max_ops"])
    ops = gen.wide_ops(mix, seed, n_max)
    rng = gen._rng(seed, 0x5A3)
    keep = _sample_positions(n_max, ops, int(rng.integers(0, 64)))
    cards_host = torch.zeros(n_max, dtype=torch.int64,
                             pin_memory=cuda)
    # at most ``depth`` ops in flight: op i's slot was op i - depth - 1's
    events = [torch.cuda.Event() if cuda else None
              for _ in range(depth + 1)]
    span = _range if trace else _no_range
    inflight: collections.deque = collections.deque()
    host_ms, answers_card = [], []
    heads = {}
    last = None
    done_in_window = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i, stop = 0, False
    with span("cardbench.window"):
        while True:
            while not stop and len(inflight) < depth and i < n_max:
                ts = time.perf_counter()
                with span("cardbench.submit"):
                    words, cards = ds.aggregate_device(ops[i])
                    total = cards.sum(dtype=torch.int64)
                    cards_host[i].copy_(total, non_blocking=cuda)
                    ev = events[i % (depth + 1)]
                    if ev is not None:
                        ev.record()
                host_ms.append((time.perf_counter() - ts) * 1e3)
                inflight.append((i, ev, words, cards))
                i += 1
            if not inflight:
                break
            j, ev, words, cards = inflight.popleft()
            if ev is not None:
                with span("cardbench.wait"):
                    ev.synchronize()
            t = time.perf_counter()
            answers_card.append(int(cards_host[j]))
            if t <= deadline:
                done_in_window += 1
            if j in keep:
                heads[j] = (words, cards)
            last = (j, words, cards)
            if t >= deadline or i >= n_max:
                stop = True
    if last is not None and last[0] not in heads:
        heads[last[0]] = last[1:]
    return Outcome(
        seconds=seconds, completed=done_in_window,
        units=i, work_bytes=i * op_bytes, host_ms=host_ms,
        answers={"ops": ops[:i], "cards": answers_card, "heads": heads})
