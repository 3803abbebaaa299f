"""One-kernel expression pipeline: the instruction-stream megakernel (B5).

Replaces ``roaringbitmap_tpu/ops/megakernel.py`` (``_kernel`` :140, reached
through ``_raw_call`` :911).  The plan-time **assembler** (:func:`build_full`)
flattens a bucketed batch plan plus its fused expression sections
(``parallel.expr.ExprSection``) into an instruction stream of eight int32
arrays (opcode / dst slot / src slot / row / bank / out row / card row /
immediate).  The kernel runs the stream over accumulator slots, one 2048-word
container row each:

- **reduce** = LOAD_ROW for a segment's first row, then OR/AND/XOR_ROW for
  the rest, over real rows only (padding and masking fold into plan-time
  ZEROs);
- **combine** = slot-to-slot bitwise ops; key-unaligned children resolve at
  plan time into per-key slot/row sources, absent keys fold to the identity;
- **outputs**: OUT writes a slot to an output row (bitmap-form results only),
  CARD writes its popcount to a card row.

Three banks feed row ops: bank 0 is the resident row image, bank 1 the
ad-hoc leaf rows, bank 2 the attached columns' slice planes and existence
rows, per (section, column slot), built once per plan
(:meth:`MegaPlan.device_arrays`).  The mesh composition assembles a
**combine-mode** stream (:func:`build_combines`, evaluated by
:func:`eval_combines`): the reduces ran per shard on B1 before the
butterfly, so bank 0 holds the combined head tensors, bank 1 the gathered
resident leaves ahead of the ad-hoc rows, and the stream holds only the
combine steps and root outputs.  The kernel is the same.  Every step reads ``acc[dst]`` and
``acc[src]`` and writes ``acc[dst]``; OUT/CARD steps point dst at the dead
slot ``slots_pad``, and steps that write no output point orow/crow at the
dead rows ``out_pad`` / ``card_pad``, which the kernel never stores.

Value steps (the analytics opcodes): a predicate's O'Neil scan is one
(VSCAN_HI | VSCAN_LO, AND_ROW | ANDNOT_ROW) pair per (slice, key) and
bound, the predicate's bits choosing the opcodes but never the step count;
a sum is one VAGG_CARD per (slice, key), whose card row takes
``popcount(found & plane)``, the 2^i weighting done on the host; a top-k
is the branch-free Kaser scan, per slice an ACC_POP contraction of the
candidates into a counter slot and one TAKE broadcasting ``sum < k`` (k in
``imm``) as a mask.

On the card (``csrc/megakernel.cu``) every opcode but TAKE is word-wise, so
the 2048-word row is cut into :data:`SLICES` slices of :data:`SLICE_WORDS`
words: block ``c`` of a cooperative launch runs the whole stream over slice
``c``, its slots in shared memory, and a card row holds one popcount partial
per slice (``int32[card_pad, SLICES]``; :func:`_slice_outputs` sums them).
The kernel stages the step-major device stream of
:meth:`MegaPlan.device_arrays` in shared memory and brings each step's row
:data:`PREFETCH_DEPTH` steps ahead, both by ``cp.async``.

Capacity (:meth:`MegaPlan.fits`): a block's slots and the prefetch rings
(:data:`RING_BYTES`, 6 KiB) must fit the H100's 227 KB of shared memory,
so ``MAX_SLOTS = (232448 - 6144) // (SLICE_WORDS * 4) = 3536`` slots,
which admits ``slots_pad`` up to 2048 (the TPU's VMEM held 1024).  The
stream lives in device memory and has no size limit on the card;
``MAX_STEPS = 2**14`` is kept only so that the port picks the same rung as
the JAX package for the same batch.  Whether a longer stream would still
beat the multi-op rung is not measured.  A plan past either bound,
or with no fused section, resolves to the multi-op "cuda" rung, counted in
``rb_mega_capacity_demotions_total{site,reason}`` (:func:`note_capacity_demotion`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime import lattice as rt_lattice
from . import build, kernels, packing
from .words import WORDS32, fold_u32, upload

#: word slices of a row: one block of the cooperative launch per slice
SLICES = 128
SLICE_WORDS = WORDS32 // SLICES
#: bytes of one accumulator slot (and of one row-ring stage) in a block's
#: shared memory
SLOT_BYTES = SLICE_WORDS * 4
#: bytes of one step record of the step-major device stream
RECORD_BYTES = 32
#: the records the kernel stages in shared memory (kRecs), and the steps
#: ahead of the running one whose rows it prefetches (kDepth): the sizes
#: the kernel is compiled with
RECORD_RING = build.DEFINES["megakernel.cu"]["RB_RECORD_RING"]
PREFETCH_DEPTH = build.DEFINES["megakernel.cu"]["RB_PREFETCH_DEPTH"]
#: shared memory of the kernel's prefetch rings: PREFETCH_DEPTH row stages
#: and RECORD_RING step records (6 KiB)
RING_BYTES = PREFETCH_DEPTH * SLOT_BYTES + RECORD_RING * RECORD_BYTES
#: shared memory a block may use on the H100 (232,448 bytes)
SMEM_BYTES = 232448
#: accumulator slots (the dead slot included) one block can hold beside the
#: rings
MAX_SLOTS = (SMEM_BYTES - RING_BYTES) // SLOT_BYTES
#: longest instruction stream the megakernel rung takes: the JAX package's
#: cap, kept for parity of rung choice (see module doc)
MAX_STEPS = 1 << 14

# --------------------------------------------------------------- opcodes

(NOP, LOAD_ROW, OR_ROW, AND_ROW, XOR_ROW, ANDNOT_ROW_REV, ZERO,
 COPY_SLOT, OR_SLOT, AND_SLOT, XOR_SLOT, ANDNOT_SLOT, ANDNOT_ROW,
 OUT, CARD, VSCAN_HI, VSCAN_LO, VAGG_CARD, ACC_POP, TAKE) = range(20)
N_OPCODES = 20

#: opcodes whose accumulator write is the dead slot (their payload leaves
#: through the out/card rows instead)
_DEAD_DST = (OUT, CARD, VAGG_CARD)
#: opcodes that read a bank row
ROW_OPS = frozenset((LOAD_ROW, OR_ROW, AND_ROW, XOR_ROW, ANDNOT_ROW_REV,
                     ANDNOT_ROW, VSCAN_HI, VSCAN_LO, VAGG_CARD))

_OP_ROW = {"or": OR_ROW, "and": AND_ROW, "xor": XOR_ROW}
_OP_SLOT = {"or": OR_SLOT, "and": AND_SLOT, "xor": XOR_SLOT}

#: the eight stream arrays, in the order the kernel reads them
STREAM_KEYS = ("opc", "dst", "src", "row", "bank", "orow", "crow", "imm")

class StreamIndexError(IndexError):
    """An instruction stream indexes outside its slots, rows or banks."""


class _Emitter:
    """Instruction-stream emitter: one append per micro-op, padded to a
    power of two at ``finish()``."""

    def __init__(self):
        self.ops: list = []  # (opc, dst, src, row, bank, orow, crow, imm)

    def emit(self, opc, dst=0, src=0, row=0, bank=0, orow=None,
             crow=None, imm=0):
        self.ops.append((opc, dst, src, row, bank, orow, crow, imm))

    def finish(self, n_slots: int, out_pad: int, card_pad: int) -> dict:
        n = len(self.ops)
        n_pad = packing.next_pow2(max(1, n))
        host = {
            "opc": np.zeros(n_pad, np.int32),
            "dst": np.full(n_pad, n_slots, np.int32),
            "src": np.zeros(n_pad, np.int32),
            "row": np.zeros(n_pad, np.int32),
            "bank": np.zeros(n_pad, np.int32),
            "orow": np.full(n_pad, out_pad, np.int32),
            "crow": np.full(n_pad, card_pad, np.int32),
            "imm": np.zeros(n_pad, np.int32),
        }
        if n:
            a = np.array([(o, d, s, r, b,
                           -1 if orow is None else orow,
                           -1 if crow is None else crow, imm)
                          for o, d, s, r, b, orow, crow, imm in self.ops],
                         np.int64)
            for j, k in enumerate(STREAM_KEYS):
                host[k][:n] = a[:, j]
            host["dst"][:n] = np.where(np.isin(a[:, 0], _DEAD_DST),
                                       n_slots, a[:, 1])
            host["orow"][:n] = np.where(a[:, 5] < 0, out_pad, a[:, 5])
            host["crow"][:n] = np.where(a[:, 6] < 0, card_pad, a[:, 6])
        return host


@dataclasses.dataclass
class MegaPlan:
    """One assembled megakernel program: the host instruction stream, the
    kernel's shape, and the output layout :func:`_slice_outputs` reads."""

    mode: str                 # "full" or "combine"
    n_steps: int              # real instruction count (pre-pad)
    steps_pad: int
    n_slots: int              # real accumulator slots (pre-pad)
    slots_pad: int
    out_pad: int              # pow2-padded OUT rows (0 = none)
    card_pad: int
    host: dict                # the eight stream arrays + "extra" (bank 1:
    #                           an array, or a list of parts when cached
    #                           device rows are among them)
    #: per bucket: (card_base, out_base | None, n_real, k_pad)
    bucket_out: tuple = ()
    #: per fused section: (card_base, out_base | None, k_root, None)
    expr_out: tuple = ()
    extra_rows: int = 1
    leaf_rows: int = 0
    #: bank-2 rows: the columns' slice planes and existence rows
    col_rows: int = 0
    #: value steps assembled: predicate scans and aggregate roots
    n_vscan: int = 0
    n_vagg: int = 0
    #: the columns bank 2 is built from, in its (section, slot) order
    cols: tuple = ()
    #: combine mode: each op group's first bank-0 row (-1: no heads)
    group_base: tuple = ()
    _arrays: dict = dataclasses.field(default_factory=dict, repr=False)
    _checked: set = dataclasses.field(default_factory=set, repr=False)

    @property
    def signature(self) -> tuple:
        return (self.mode, self.steps_pad, self.slots_pad, self.out_pad,
                self.card_pad, self.extra_rows, self.leaf_rows,
                self.col_rows, self.bucket_out, self.expr_out)

    def fits(self) -> bool:
        return capacity_reason(self) is None

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one block: the slots and the prefetch rings."""
        return (self.slots_pad + 1) * SLOT_BYTES + RING_BYTES

    def stats_event(self) -> dict:
        """The ``expr.megakernel`` span-event payload (the JAX package's
        fields: ``vmem_bytes`` is a block's shared memory here)."""
        return {"mode": self.mode, "steps": int(self.n_steps),
                "slots": int(self.n_slots),
                "vmem_bytes": int(self.smem_bytes),
                "out_rows": int(self.out_pad),
                "card_rows": int(self.card_pad),
                "sections": len(self.expr_out),
                "vscan_steps": int(self.n_vscan),
                "vagg_steps": int(self.n_vagg),
                "col_rows": int(self.col_rows)}

    def device_arrays(self, device) -> dict:
        """{"stream": int32[steps_pad, 8], "extra": int32[rows, 2048],
        "cols": int32[col_rows, 2048]} on ``device``, built once per device.
        The stream is step-major, one 32-byte record per step with the
        fields in STREAM_KEYS order, so the kernel fetches a step with two
        16-byte copies.  "cols" is bank 2: each column's slice planes
        (slice-major) and then its existence rows, in :func:`_col_layout`'s
        order (one zero row when the plan reads no column)."""
        key = str(device)
        if key not in self._arrays:
            extra = self.host["extra"]
            extra = (torch.cat([upload(p, device) for p in extra])
                     if isinstance(extra, list) else upload(extra, device))
            self._arrays[key] = {"stream": upload(self.stream_host(), device),
                                 "extra": extra,
                                 "cols": self.col_bank(device)}
        return self._arrays[key]

    def stream_host(self) -> np.ndarray:
        """The step-major stream int32[steps_pad, 8] on the host."""
        return np.stack([self.host[k] for k in STREAM_KEYS], axis=1)

    def col_bank(self, device) -> torch.Tensor:
        """Bank 2 on ``device``: each column's slice planes and existence
        rows in (section, slot) order, or one zero row."""
        parts = []
        for col in self.cols:
            slices, ebm = col.device_operands()
            parts += [slices.reshape(-1, WORDS32), ebm]
        return (torch.cat(parts).to(device) if parts else
                torch.zeros((1, WORDS32), dtype=torch.int32, device=device))

    def operands(self, device) -> dict:
        """The operand tree of a captured launch (``runtime.programs``):
        the stream and bank 1 as host arrays where they are, bank 2 and
        cached bank-1 rows as device tensors, and the step count."""
        extra = self.host["extra"]
        if isinstance(extra, list):
            extra = torch.cat([upload(p, device) for p in extra])
        return {"stream": self.stream_host(), "extra": extra,
                "cols": self.col_bank(device),
                "steps": np.array([self.n_steps], np.int32)}

    def check(self, bank_rows: tuple) -> None:
        """Raise StreamIndexError unless every step indexes inside the
        slots, the out/card rows and its bank (checked once per bank shape)."""
        if bank_rows in self._checked:
            return
        h = self.host
        opc, bank, row = h["opc"], h["bank"], h["row"]
        limit = np.asarray(bank_rows, np.int64)[np.clip(bank, 0, 2)]
        bad = {
            "opcode": (opc < 0) | (opc >= N_OPCODES),
            "slot": ((h["dst"] < 0) | (h["dst"] > self.slots_pad)
                     | (h["src"] < 0) | (h["src"] > self.slots_pad)),
            "bank": (bank < 0) | (bank > 2),
            "row": (row < 0) | (row >= limit),
            "out row": (h["orow"] < 0) | (h["orow"] > self.out_pad),
            "card row": (h["crow"] < 0) | (h["crow"] > self.card_pad),
        }
        for what, mask in bad.items():
            if mask.any():
                i = int(np.flatnonzero(mask)[0])
                raise StreamIndexError(
                    f"megakernel step {i}: {what} out of range (opc "
                    f"{int(opc[i])}, dst {int(h['dst'][i])}, src "
                    f"{int(h['src'][i])}, bank {int(bank[i])}, row "
                    f"{int(row[i])}; banks hold {bank_rows} rows, "
                    f"{self.slots_pad + 1} slots)")
        self._checked.add(bank_rows)


def capacity_reason(mega: MegaPlan) -> str | None:
    """Which budget a non-fitting plan blew: "slots" (a block's shared
    memory) or "steps" (the stream cap); None when the plan fits."""
    if mega.slots_pad + 1 > MAX_SLOTS:
        return "slots"
    if mega.steps_pad > MAX_STEPS:
        return "steps"
    return None


def note_capacity_demotion(site: str, mega: MegaPlan | None) -> str:
    """Count a demotion off the megakernel rung by reason in
    ``rb_mega_capacity_demotions_total{site,reason}`` ("no_fused" for a
    plan without fused sections) and return the reason; a plan that
    assembled but does not fit also gets the JAX package's
    ``mega.capacity_demotion`` span event."""
    reason = ("no_fused" if mega is None
              else capacity_reason(mega) or "unknown")
    obs_metrics.counter("rb_mega_capacity_demotions_total", site=site,
                        reason=reason).inc()
    if mega is not None:
        obs_trace.current().event(
            "mega.capacity_demotion", site=site, reason=reason,
            steps=int(mega.steps_pad), slots=int(mega.slots_pad),
            vmem_bytes=int(mega.smem_bytes))
    return reason


# ------------------------------------------------------------- assembler

def _emit_bucket(em: _Emitter, b, base: int, card_base: int,
                 out_base) -> None:
    """One shape bucket's pipeline: per-(query, key) segmented reduce over
    real rows only, plan-time masking (heads_ok / workShyAnd key_keep /
    andnot head pass), per-slot CARD rows, and OUT rows when the bucket's
    own needs_words asks for them."""
    host = b.host
    n_real, k_pad = len(b.qids), b.k_pad
    red = OR_ROW if b.op in ("or", "andnot") else _OP_ROW[b.op]
    for qi in range(n_real):
        valid = host["valid"][qi]
        rows = host["gather"][qi][valid]
        segs = host["seg_local"][qi][valid]
        for k in range(k_pad):
            slot = base + qi * k_pad + k
            ok = bool(host["heads_ok"][qi, k])
            if b.op == "and" and not bool(host["key_keep"][qi, k]):
                ok = False
            seg_rows = rows[segs == k] if ok else rows[:0]
            if b.op == "andnot":
                if not bool(host["head_ok"][qi, k]):
                    em.emit(ZERO, dst=slot)
                elif seg_rows.size == 0:
                    # no rest rows: head & ~0 == the head row itself
                    em.emit(LOAD_ROW, dst=slot,
                            row=int(host["head_gather"][qi, k]))
                else:
                    em.emit(LOAD_ROW, dst=slot, row=int(seg_rows[0]))
                    for r in seg_rows[1:]:
                        em.emit(OR_ROW, dst=slot, row=int(r))
                    em.emit(ANDNOT_ROW_REV, dst=slot,
                            row=int(host["head_gather"][qi, k]))
            elif not ok or seg_rows.size == 0:
                em.emit(ZERO, dst=slot)
            else:
                em.emit(LOAD_ROW, dst=slot, row=int(seg_rows[0]))
                for r in seg_rows[1:]:
                    em.emit(red, dst=slot, row=int(r))
    for qi in range(n_real):
        for k in range(k_pad):
            slot = base + qi * k_pad + k
            em.emit(CARD, src=slot, crow=card_base + qi * k_pad + k)
            if out_base is not None:
                em.emit(OUT, src=slot, orow=out_base + qi * k_pad + k)


class _SectionCtx:
    """Per-section assembly state: maps compiled steps to (slot | row)
    sources for each of the node's keys."""

    def __init__(self, sec, slot_of_reduce, extra_base, leaf_row,
                 col_base=None):
        self.sec = sec
        self.slot_of_reduce = slot_of_reduce
        self.extra_base = extra_base
        self.leaf_row = leaf_row
        self.combine_base: dict = {}
        #: column slot -> (bank-2 row base, depth_pad, K)
        self.col_base: dict = col_base or {}
        #: vscan step -> per-key sources (result slots, or existence rows
        #: for "col:all")
        self.vscan_src: dict = {}

    def ebm_row(self, col_slot: int, j: int) -> int:
        base, s, k = self.col_base[col_slot]
        return base + s * k + j

    def slice_row(self, col_slot: int, s_i: int, j: int) -> int:
        base, _s, k = self.col_base[col_slot]
        return base + s_i * k + j

    def source(self, ci: int, j: int):
        """("slot", s) | ("row", bank, r) for step ``ci``'s key ``j``."""
        st = self.sec.steps[ci]
        kind = st[0]
        if kind == "leaf":
            bank, row = self.leaf_row(self.sec, ci, j)
            return ("row", bank, row)
        if kind == "adhoc":
            return ("row", 1, self.extra_base[ci] + j)
        if kind == "reduce":
            _, bi, slot, _kq = st
            return self.slot_of_reduce(bi, slot, j)
        if kind == "vscan":
            return self.vscan_src[ci][j]
        return ("slot", self.combine_base[ci] + j)


def _emit_combine(em: _Emitter, ctx: _SectionCtx, si: int) -> None:
    """One interior combine node: per key, resolve each child through the
    plan-time alignment arrays into a slot/row source, fold absent keys to
    the op identity, and chain the bitwise micro-ops."""
    sec = ctx.sec
    _, op, children, kq = sec.steps[si]
    base = ctx.combine_base[si]
    host = sec.host
    for j in range(kq):
        dst = base + j
        parts = []
        for k, (ci, aligned) in enumerate(children):
            if aligned:
                jj, ok = j, True
            else:
                jj = int(host[f"i{si}_{k}"][j])
                ok = bool(host[f"o{si}_{k}"][j])
            parts.append((ok, ctx.source(ci, jj) if ok else None))
        if op == "andnot":
            # the head is key-aligned by construction; absent rest
            # children contribute ~0 == all-ones
            _, head = parts[0]
            _emit_set(em, dst, head)
            for ok, srcp in parts[1:]:
                if ok:
                    _emit_op(em, dst, srcp, ANDNOT_SLOT, ANDNOT_ROW)
        elif op == "and":
            if not all(ok for ok, _ in parts):
                em.emit(ZERO, dst=dst)
                continue
            _emit_set(em, dst, parts[0][1])
            for _, srcp in parts[1:]:
                _emit_op(em, dst, srcp, AND_SLOT, AND_ROW)
        else:
            live = [srcp for ok, srcp in parts if ok]
            if not live:
                em.emit(ZERO, dst=dst)
                continue
            _emit_set(em, dst, live[0])
            for srcp in live[1:]:
                _emit_op(em, dst, srcp, _OP_SLOT[op], _OP_ROW[op])


def _emit_set(em: _Emitter, dst: int, srcp) -> None:
    if srcp[0] == "slot":
        em.emit(COPY_SLOT, dst=dst, src=srcp[1])
    else:
        em.emit(LOAD_ROW, dst=dst, row=srcp[2], bank=srcp[1])


def _emit_op(em: _Emitter, dst: int, srcp, slot_op: int,
             row_op: int) -> None:
    if srcp[0] == "slot":
        em.emit(slot_op, dst=dst, src=srcp[1])
    else:
        em.emit(row_op, dst=dst, row=srcp[2], bank=srcp[1])


def _col_layout(sections) -> tuple:
    """Bank-2 row layout: per (section, column slot), sorted, the column's
    padded slice planes (``S * K`` rows, slice-major) and then its ``K``
    existence rows.  Returns ({(sid, slot): (base, S, K)}, total rows)."""
    shapes: dict = {}
    for sid, sec in enumerate(sections):
        for st in sec.steps:
            if st[0] == "vscan":
                shapes[(sid, st[1])] = (int(st[3]), int(st[4]))
            elif st[0] == "vagg":
                shapes[(sid, st[4])] = (int(st[5]), int(st[6]))
    bases, off = {}, 0
    for key in sorted(shapes):
        s, k = shapes[key]
        bases[key] = (off, s, k)
        off += s * k + k
    return bases, off


def _emit_vscan(em: _Emitter, ctx: _SectionCtx, si: int,
                n_slots: int) -> int:
    """One value-predicate step: the descending O'Neil pass as one
    (VSCAN_HI | VSCAN_LO, AND_ROW | ANDNOT_ROW) pair per (slice, key) and
    bound, a NOP where a bound's bit needs no accumulation, so every
    predicate value at one (tag, depth, K) gives the same step count.
    Returns the slots in use after it."""
    sec = ctx.sec
    _, ci, tag, depth, kq = sec.steps[si]
    _kind, _, op = tag.partition(":")
    if op == "all":
        ctx.vscan_src[si] = [("row", 2, ctx.ebm_row(ci, j))
                             for j in range(kq)]
        return n_slots
    bits = np.asarray(sec.host[f"b{si}"])
    bits2 = np.asarray(sec.host[f"b2{si}"])
    srcs: list = []
    for j in range(kq):
        erow = ctx.ebm_row(ci, j)
        if op in ("RANGE", "between"):
            g1, e1, l2, e2 = range(n_slots, n_slots + 4)
            n_slots += 4
            em.emit(ZERO, dst=g1)
            em.emit(LOAD_ROW, dst=e1, row=erow, bank=2)
            em.emit(ZERO, dst=l2)
            em.emit(LOAD_ROW, dst=e2, row=erow, bank=2)
            for t in range(depth):
                w = ctx.slice_row(ci, depth - 1 - t, j)
                if int(bits[t]):
                    em.emit(NOP)
                    em.emit(AND_ROW, dst=e1, row=w, bank=2)
                else:
                    em.emit(VSCAN_LO, dst=g1, src=e1, row=w, bank=2)
                    em.emit(ANDNOT_ROW, dst=e1, row=w, bank=2)
                if int(bits2[t]):
                    em.emit(VSCAN_HI, dst=l2, src=e2, row=w, bank=2)
                    em.emit(AND_ROW, dst=e2, row=w, bank=2)
                else:
                    em.emit(NOP)
                    em.emit(ANDNOT_ROW, dst=e2, row=w, bank=2)
            # (gt1 | eq1) & (lt2 | eq2): every state already lies inside
            # the existence plane
            em.emit(OR_SLOT, dst=g1, src=e1)
            em.emit(OR_SLOT, dst=l2, src=e2)
            em.emit(AND_SLOT, dst=g1, src=l2)
            srcs.append(("slot", g1))
            continue
        gt, lt, eq = range(n_slots, n_slots + 3)
        n_slots += 3
        em.emit(ZERO, dst=gt)
        em.emit(ZERO, dst=lt)
        em.emit(LOAD_ROW, dst=eq, row=erow, bank=2)
        for t in range(depth):
            w = ctx.slice_row(ci, depth - 1 - t, j)
            if int(bits[t]):
                em.emit(VSCAN_HI, dst=lt, src=eq, row=w, bank=2)
                em.emit(AND_ROW, dst=eq, row=w, bank=2)
            else:
                em.emit(VSCAN_LO, dst=gt, src=eq, row=w, bank=2)
                em.emit(ANDNOT_ROW, dst=eq, row=w, bank=2)
        if op in ("EQ", "eq"):
            res = eq
        elif op in ("NEQ", "neq"):
            # ebm & ~eq, in gt's slot
            em.emit(LOAD_ROW, dst=gt, row=erow, bank=2)
            em.emit(ANDNOT_SLOT, dst=gt, src=eq)
            res = gt
        elif op == "GT":
            res = gt
        elif op == "LT":
            res = lt
        elif op in ("LE", "lte"):
            em.emit(OR_SLOT, dst=lt, src=eq)
            res = lt
        elif op in ("GE", "gte"):
            em.emit(OR_SLOT, dst=gt, src=eq)
            res = gt
        else:
            raise ValueError(f"unknown scan tag {tag!r}")
        srcs.append(("slot", res))
    ctx.vscan_src[si] = srcs
    return n_slots


def _emit_vagg(em: _Emitter, ctx: _SectionCtx, si: int, n_slots: int,
               n_card: int, n_out: int) -> tuple:
    """One aggregate root.  The found step is aligned onto the column's
    keys (plan-time masks, as a combine).  ``sum``: one VAGG_CARD per
    (slice, key) into the card rows, then the found step's own per-key
    cards.  ``top_k``: the Kaser scan; per slice, candidates
    ``x = g | (e & w)``, an ACC_POP contraction into a counter slot, one
    TAKE broadcasting ``sum < k`` as a mask F, then ``g |= x & F`` and
    ``e &= w ^ F``.  Returns (n_slots, n_card, n_out, expr_out entry)."""
    sec = ctx.sec
    _, akind, fi, aligned, ci, _depth, kq = sec.steps[si]
    host = sec.host
    _base, s_depth, _k = ctx.col_base[ci]
    k_found = int(sec.steps[fi][-1])
    idx = host.get(f"i{si}")
    okm = host.get(f"o{si}")
    fc = list(range(n_slots, n_slots + kq))
    n_slots += kq
    for k in range(kq):
        ok, jj = (True, k) if aligned else (bool(okm[k]), int(idx[k]))
        if ok:
            _emit_set(em, fc[k], ctx.source(fi, jj))
        else:
            em.emit(ZERO, dst=fc[k])
    if akind == "sum":
        cb = n_card
        for s_i in range(s_depth):
            for k in range(kq):
                em.emit(VAGG_CARD, src=fc[k],
                        row=ctx.slice_row(ci, s_i, k), bank=2,
                        crow=cb + s_i * kq + k)
        # the found set's own cards, from its value before the alignment
        tmp = n_slots
        n_slots += 1
        for j in range(k_found):
            srcp = ctx.source(fi, j)
            if srcp[0] == "slot":
                em.emit(CARD, src=srcp[1], crow=cb + s_depth * kq + j)
            else:
                _emit_set(em, tmp, srcp)
                em.emit(CARD, src=tmp, crow=cb + s_depth * kq + j)
        n_card += s_depth * kq + k_found
        return (n_slots, n_card, n_out,
                (cb, None, kq, ("sum", s_depth, kq, k_found)))
    kk = int(host[f"k{si}"])
    e = fc                      # found ∩ existence
    for k in range(kq):
        em.emit(AND_ROW, dst=e[k], row=ctx.ebm_row(ci, k), bank=2)
    g = list(range(n_slots, n_slots + kq))
    x = list(range(n_slots + kq, n_slots + 2 * kq))
    counter, flag, t2 = range(n_slots + 2 * kq, n_slots + 2 * kq + 3)
    n_slots += 2 * kq + 3
    for k in range(kq):
        em.emit(ZERO, dst=g[k])
    for s_i in range(s_depth - 1, -1, -1):
        for k in range(kq):
            em.emit(COPY_SLOT, dst=x[k], src=e[k])
            em.emit(AND_ROW, dst=x[k], row=ctx.slice_row(ci, s_i, k),
                    bank=2)
            em.emit(OR_SLOT, dst=x[k], src=g[k])
        em.emit(ZERO, dst=counter)
        for k in range(kq):
            em.emit(ACC_POP, dst=counter, src=x[k])
        em.emit(TAKE, dst=flag, src=counter, imm=kk)
        for k in range(kq):
            # where(take, x, g) == g | (x & F), since g ⊆ x
            em.emit(AND_SLOT, dst=x[k], src=flag)
            em.emit(OR_SLOT, dst=g[k], src=x[k])
        for k in range(kq):
            # where(take, e & ~w, e & w) == e & (w ^ F)
            em.emit(COPY_SLOT, dst=t2, src=flag)
            em.emit(XOR_ROW, dst=t2, row=ctx.slice_row(ci, s_i, k),
                    bank=2)
            em.emit(AND_SLOT, dst=e[k], src=t2)
    cb, ob = n_card, n_out
    for k in range(kq):
        em.emit(OR_SLOT, dst=g[k], src=e[k])
        em.emit(CARD, src=g[k], crow=cb + k)
        em.emit(OUT, src=g[k], orow=ob + k)
    n_card += kq
    n_out += kq
    return n_slots, n_card, n_out, (cb, ob, kq, ("topk",))


def _pack_extra(sections) -> tuple:
    """Bank-1 rows: every ad-hoc operand's container rows, concatenated,
    and per-(section id, step) base offsets.  An operand injected from the
    result cache is a device tensor: then the bank stays a list of parts,
    joined on the device by :meth:`MegaPlan.device_arrays` (a copy, so the
    cached rows are never an operand the kernel could write, and nothing
    goes through the host)."""
    rows, bases = [], {}
    off = 0
    for sid, sec in enumerate(sections):
        for ci, st in enumerate(sec.steps):
            if st[0] == "adhoc":
                w = sec.host[f"w{ci}"]
                bases[(sid, ci)] = off
                rows.append(w if isinstance(w, torch.Tensor)
                            else np.asarray(w, np.uint32))
                off += int(w.shape[0])
    if not rows:
        return np.zeros((1, WORDS32), np.uint32), bases
    if any(isinstance(w, torch.Tensor) for w in rows):
        return rows, bases
    return np.concatenate(rows, axis=0), bases


def _assemble(mode: str, buckets, sections, slot_of_reduce, leaf_row,
              extra, extra_bases, emit_buckets: bool) -> MegaPlan:
    """The assembly tail of :func:`build_full` and :func:`build_combines`:
    allocate slots and output rows, walk the buckets (full mode), then
    every section's combine steps in topological order, and close with the
    sections' CARD/OUT outputs."""
    n_slots = 0
    bucket_base: list = []
    n_card = n_out = 0
    bucket_out: list = []
    if emit_buckets:
        for b in buckets:
            bucket_base.append(n_slots)
            n_slots += len(b.qids) * b.k_pad
        for b in buckets:
            ob = n_out if b.needs_words else None
            bucket_out.append((n_card, ob, len(b.qids), b.k_pad))
            n_card += len(b.qids) * b.k_pad
            if ob is not None:
                n_out += len(b.qids) * b.k_pad

    em = _Emitter()
    for b, base, (cb, ob, _n, _k) in zip(buckets, bucket_base, bucket_out):
        _emit_bucket(em, b, base, cb, ob)

    col_bases, col_rows = _col_layout(sections)
    n_vscan = n_vagg = 0
    ctxs: list = []
    for sid, sec in enumerate(sections):
        ctx = _SectionCtx(
            sec, slot_of_reduce=slot_of_reduce(bucket_base),
            extra_base={ci: extra_bases.get((sid, ci), 0)
                        for ci, st in enumerate(sec.steps)
                        if st[0] == "adhoc"},
            leaf_row=leaf_row,
            col_base={ci: v for (s, ci), v in col_bases.items()
                      if s == sid})
        for si, st in enumerate(sec.steps):
            if st[0] == "combine":
                ctx.combine_base[si] = n_slots
                n_slots += int(st[3])
        ctxs.append(ctx)
    for ctx in ctxs:
        for si, st in enumerate(ctx.sec.steps):
            if st[0] == "vscan":
                n_vscan += 1
                n_slots = _emit_vscan(em, ctx, si, n_slots)
            elif st[0] == "combine":
                _emit_combine(em, ctx, si)

    expr_out: list = []
    for ctx in ctxs:
        sec = ctx.sec
        if sec.steps[sec.root][0] == "vagg":
            n_vagg += 1
            n_slots, n_card, n_out, entry = _emit_vagg(
                em, ctx, sec.root, n_slots, n_card, n_out)
            expr_out.append(entry)
            continue
        k_root = int(sec.root_keys.size)
        root_srcs = [ctx.source(sec.root, j) for j in range(k_root)]
        if any(s[0] == "row" for s in root_srcs):
            # a bare leaf/ad-hoc root (or, in combine mode, a reduce root,
            # whose value is a bank row): give it its own slots so OUT/CARD
            # have a slot source
            base = n_slots
            n_slots += k_root
            for j, s in enumerate(root_srcs):
                _emit_set(em, base + j, s)
            root_slots = [base + j for j in range(k_root)]
        else:
            root_slots = [s[1] for s in root_srcs]
        ob = n_out if sec.form == "bitmap" else None
        expr_out.append((n_card, ob, k_root, None))
        for j in range(k_root):
            em.emit(CARD, src=root_slots[j], crow=n_card + j)
            if ob is not None:
                em.emit(OUT, src=root_slots[j], orow=n_out + j)
        n_card += k_root
        if ob is not None:
            n_out += k_root

    slots_pad = packing.next_pow2(max(1, n_slots))
    out_pad = packing.next_pow2(n_out) if n_out else 0
    card_pad = packing.next_pow2(max(1, n_card))
    n_real = len(em.ops)
    if rt_lattice.active() is not None:
        # the lattice snap at the stream level (the JAX package's
        # megakernel.py:795-806): floor-quantizing the small end makes
        # near-identical DAG variants share one stream shape; padded steps
        # are NOPs on the dead slot, padded slots are unread shared memory
        slots_pad = max(slots_pad, 4)
        card_pad = max(card_pad, 8)
        if out_pad:
            out_pad = max(out_pad, 8)
        while len(em.ops) < 16:
            em.emit(NOP)
    host = em.finish(slots_pad, out_pad, card_pad)
    host["extra"] = extra
    return MegaPlan(
        mode=mode, n_steps=n_real,
        steps_pad=int(host["opc"].shape[0]),
        n_slots=n_slots, slots_pad=slots_pad,
        out_pad=out_pad, card_pad=card_pad, host=host,
        bucket_out=tuple(bucket_out), expr_out=tuple(expr_out),
        extra_rows=(sum(int(p.shape[0]) for p in extra)
                    if isinstance(extra, list) else int(extra.shape[0])),
        col_rows=int(col_rows),
        n_vscan=n_vscan, n_vagg=n_vagg,
        cols=tuple(c for sec in sections for c in sec.cols))


def build_full(buckets, sections) -> MegaPlan:
    """Assemble the full-pipeline megakernel for a bucketed plan with fused
    expression sections: every bucket's segmented reduce and post passes,
    and every section's combine/output steps, in one stream.  Row indices
    are the plan's image rows (bank 0)."""
    fused = [s for s in sections if s.kind == "fused"]
    extra, extra_bases = _pack_extra(fused)

    def slot_of_reduce(bucket_base):
        def fn(bi, slot, j):
            return ("slot", bucket_base[bi] + slot * buckets[bi].k_pad + j)
        return fn

    def leaf_row(sec, ci, j):
        # resident leaves stream straight from the row image (bank 0)
        return 0, int(sec.host[f"g{ci}"][j])

    return _assemble("full", buckets, fused, slot_of_reduce, leaf_row,
                     extra, extra_bases, emit_buckets=True)


def build_combines(buckets, op_groups, sections, expr_bis) -> MegaPlan:
    """Assemble the combine-only program of the mesh composition
    (``parallel.sharded_engine``): the reduces ran per shard on B1 and the
    butterfly combined them, so B5 runs only the sections' combine steps
    and root outputs.  The banks:

    - bank 0: the concatenated flat head tensors of the op groups that
      produce heads (a query returns words, or a combine step reads them),
      in the padded ``q * (k_pad + 1)`` layout of
      ``expr.traced_bucket_heads``: a reduce node's value is a row there;
    - bank 1: the resident leaves' rows, gathered before the launch in the
      order of ``host["leafidx"]``, then the ad-hoc rows;
    - bank 2: the columns, as in full mode.

    ``mega.group_base`` holds each group's first bank-0 row (-1 for a group
    that produces no heads) and ``mega.leaf_rows`` the gathered leaf rows."""
    fused = [s for s in sections if s.kind == "fused"]
    extra, extra_bases = _pack_extra(fused)
    produces = [g.needs_words or any(bi in expr_bis for bi in g.bucket_idx)
                for g in op_groups]
    group_base, off = [], 0
    for g, p in zip(op_groups, produces):
        group_base.append(off if p else -1)
        if p:
            off += int(g.nseg)
    bucket_row0 = {}
    for g, gb in zip(op_groups, group_base):
        for bi, s0 in zip(g.bucket_idx, g.seg_offs):
            bucket_row0[bi] = (gb + s0) if gb >= 0 else -1

    def slot_of_reduce(_bucket_base):
        def fn(bi, slot, j):
            r0 = bucket_row0[bi]
            if r0 < 0:
                raise AssertionError(
                    f"expr-feeding bucket {bi} in a headless op group")
            return ("row", 0, r0 + slot * (buckets[bi].k_pad + 1) + j)
        return fn

    leaf_parts, leaf_bases = [], {}
    off = 0
    for sid, sec in enumerate(fused):
        for ci, st in enumerate(sec.steps):
            if st[0] == "leaf":
                g = np.asarray(sec.host[f"g{ci}"], np.int64)
                leaf_bases[(sid, ci)] = off
                leaf_parts.append(g)
                off += int(g.size)
    leaf_idx = (np.concatenate(leaf_parts) if leaf_parts
                else np.zeros(0, np.int64)).astype(np.int32)
    n_leaf = int(leaf_idx.size)
    sec_id = {id(sec): sid for sid, sec in enumerate(fused)}

    def leaf_row(sec, ci, j):
        # combine mode reads the leaves gathered into bank 1, before the
        # ad-hoc rows
        return 1, leaf_bases[(sec_id[id(sec)], ci)] + j

    extra_bases = {k: v + n_leaf for k, v in extra_bases.items()}
    mega = _assemble("combine", buckets, fused, slot_of_reduce, leaf_row,
                     extra, extra_bases, emit_buckets=False)
    mega.host["leafidx"] = leaf_idx
    mega.group_base = tuple(group_base)
    mega.leaf_rows = n_leaf
    return mega


# --------------------------------------------------------------- B5

def _popcount_each(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 words, as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 >> 24) & 0xFF


def _slice_cards(v: torch.Tensor) -> torch.Tensor:
    """Popcount of each of a row's SLICES word slices -> int32[SLICES]."""
    return _popcount_each(v).view(SLICES, SLICE_WORDS).sum(1).to(torch.int32)


def _outputs(mega: MegaPlan, device):
    out = torch.zeros((mega.out_pad, WORDS32), dtype=torch.int32,
                      device=device)
    cards = torch.zeros((mega.card_pad, SLICES), dtype=torch.int32,
                        device=device)
    return out, cards


def raw_call_plain(mega: MegaPlan, bank_a: torch.Tensor, bank_b: torch.Tensor,
                   bank_c: torch.Tensor, stream: torch.Tensor | None = None,
                   steps_dev: torch.Tensor | None = None):
    """Plain version of B5: the plan's stream (or ``stream``, its first
    ``steps_dev`` records, as ``raw_call`` takes them) as a Python loop of
    tensor ops, in order.  Returns (out int32[out_pad, 2048], card partials
    int32[card_pad, SLICES]).  TAKE sums its counter slot as int32 with
    wrap-around (mod 2^32, compared signed), ACC_POP is a u32 add."""
    mega.check((bank_a.shape[0], bank_b.shape[0], bank_c.shape[0]))
    dev = bank_a.device
    acc = torch.zeros((mega.slots_pad + 1, WORDS32), dtype=torch.int32,
                      device=dev)
    out, cards = _outputs(mega, dev)
    banks = (bank_a, bank_b, bank_c)
    # the steps past n_steps are the power-of-two padding: NOPs on the
    # dead slot and dead rows
    if stream is None:
        cols = [mega.host[k][:mega.n_steps].tolist() for k in STREAM_KEYS]
    else:
        n = mega.n_steps if steps_dev is None else int(steps_dev[0])
        cols = stream[:n].T.tolist()
    for opc, dst, src, row, bank, orow, crow, imm in zip(*cols):
        cur = acc[dst]
        srcv = acc[src]
        if dst == src and (orow < mega.out_pad or crow < mega.card_pad):
            srcv = srcv.clone()     # the outputs take the pre-step value
        w = banks[bank][row] if opc in ROW_OPS else None
        if opc == LOAD_ROW:
            res = w
        elif opc == OR_ROW:
            res = cur | w
        elif opc == AND_ROW:
            res = cur & w
        elif opc == XOR_ROW:
            res = cur ^ w
        elif opc == ANDNOT_ROW_REV:
            res = w & ~cur
        elif opc == ZERO:
            res = torch.zeros_like(cur)
        elif opc == COPY_SLOT:
            res = srcv
        elif opc == OR_SLOT:
            res = cur | srcv
        elif opc == AND_SLOT:
            res = cur & srcv
        elif opc == XOR_SLOT:
            res = cur ^ srcv
        elif opc == ANDNOT_SLOT:
            res = cur & ~srcv
        elif opc == ANDNOT_ROW:
            res = cur & ~w
        elif opc == VSCAN_HI:
            res = cur | (srcv & ~w)
        elif opc == VSCAN_LO:
            res = cur | (srcv & w)
        elif opc == ACC_POP:
            res = fold_u32((cur.to(torch.int64) + _popcount_each(srcv))
                           & 0xFFFFFFFF)
        elif opc == TAKE:
            s = int(srcv.sum(dtype=torch.int64)) & 0xFFFFFFFF
            s = s - (1 << 32) if s >= (1 << 31) else s
            res = torch.full_like(cur, -1 if s < imm else 0)
        else:           # NOP, OUT, CARD, VAGG_CARD: acc[dst] keeps cur
            res = None
        if res is not None:
            acc[dst] = res
        if orow < mega.out_pad:
            out[orow] = srcv
        if crow < mega.card_pad:
            cards[crow] = _slice_cards(srcv & w if opc == VAGG_CARD
                                       else srcv)
    return out, cards


def _check_bank(name: str, t: torch.Tensor) -> None:
    kernels._check(name, t, 2, WORDS32)
    if t.shape[0] < 1:
        raise ValueError(f"{name}: a bank needs at least one row")


def raw_call(mega: MegaPlan, bank_a: torch.Tensor, bank_b: torch.Tensor,
             bank_c: torch.Tensor, stream: torch.Tensor | None = None,
             steps_dev: torch.Tensor | None = None):
    """B5: run the plan's instruction stream over the three row banks
    (int32[rows, 2048] each) -> (out int32[out_pad, 2048], card partials
    int32[card_pad, SLICES]).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (one cooperative launch of SLICES blocks) or
    raise.  The kernel runs the ``n_steps`` real steps of the stream and
    skips its NOP padding.  Every index of the stream is checked against
    the banks once per plan and bank shape; the kernel never reads out of
    range.

    A captured launch (``runtime.programs``) replays other plans of the
    same stream shape: it passes its static ``stream`` (int32[steps_pad,
    8]) and ``steps_dev`` (a device int32[1] holding the step count, read
    by the kernel), which the replay refills, so no plan's scalar is baked
    into the graph."""
    for name, t in (("bank_a", bank_a), ("bank_b", bank_b),
                    ("bank_c", bank_c)):
        _check_bank(name, t)
    if not kernels._on_cuda(bank_a, bank_b, bank_c):
        return raw_call_plain(mega, bank_a, bank_b, bank_c, stream,
                              steps_dev)
    mega.check((bank_a.shape[0], bank_b.shape[0], bank_c.shape[0]))
    if mega.slots_pad + 1 > MAX_SLOTS:
        raise ValueError(
            f"megakernel plan needs {mega.slots_pad + 1} slots; one block "
            f"holds {MAX_SLOTS}")
    dev = bank_a.device
    if stream is None:
        stream = mega.device_arrays(dev)["stream"]
    out, cards = _outputs(mega, dev)
    take = torch.zeros(2 * SLICES, dtype=torch.int32, device=dev)
    kernels.B5.launch(
        stream.data_ptr(),
        mega.n_steps if steps_dev is None else mega.steps_pad,
        None if steps_dev is None else steps_dev.data_ptr(),
        bank_a.data_ptr(), bank_b.data_ptr(), bank_c.data_ptr(),
        out.data_ptr(),
        cards.data_ptr(), take.data_ptr(), mega.slots_pad, mega.out_pad,
        mega.card_pad, kernels._stream(),
        nbytes=lambda: stream_bytes(mega), variant=mega.mode)
    return out, cards


def _slice_outputs(mega: MegaPlan, out_rows, card_rows):
    """Kernel outputs -> (per-bucket outs, per-section expr outs): buckets
    get (heads int32[n, k_pad, 2048] | None, cards int32[n, k_pad]), fused
    sections get (heads int32[K, 2048] | None, cards int32[K]); a sum root
    gets (int32[S, K] per-(slice, key) cards, int32[K_found] found cards),
    read from its ("sum", S, K, K_found) card block."""
    cards = card_rows.sum(1, dtype=torch.int32)
    outs = []
    for cb, ob, n, k_pad in mega.bucket_out:
        c = cards[cb:cb + n * k_pad].view(n, k_pad)
        h = (out_rows[ob:ob + n * k_pad].view(n, k_pad, WORDS32)
             if ob is not None else None)
        outs.append((h, c))
    expr_outs = []
    for cb, ob, k_root, agg in mega.expr_out:
        if agg is not None and agg[0] == "sum":
            _, s_depth, kq, k_found = agg
            n = s_depth * kq
            expr_outs.append((cards[cb:cb + n].view(s_depth, kq),
                              cards[cb + n:cb + n + k_found]))
            continue
        h = out_rows[ob:ob + k_root] if ob is not None else None
        expr_outs.append((h, cards[cb:cb + k_root]))
    return outs, expr_outs


def eval_full(mega: MegaPlan, words: torch.Tensor, arrs: dict | None = None):
    """Full-mode evaluation over the resident row image ``words`` (bank 0),
    the ad-hoc rows (bank 1) and the column planes (bank 2): one B5
    launch, then the outputs sliced per bucket and section.  ``arrs``
    defaults to the plan's own device arrays; a captured program passes
    its static ones (with ``"steps"``, the device step count)."""
    if arrs is None:
        arrs = mega.device_arrays(words.device)
    out_rows, card_rows = raw_call(mega, words, arrs["extra"], arrs["cols"],
                                   stream=arrs["stream"],
                                   steps_dev=arrs.get("steps"))
    return _slice_outputs(mega, out_rows, card_rows)


def eval_combines(mega: MegaPlan, bank_a: torch.Tensor | None,
                  leaf_rows: torch.Tensor | None, arrs: dict | None = None
                  ) -> list:
    """Combine-mode evaluation (the sharded engine's replicated side, after
    the butterfly): ``bank_a`` the producing groups' flat head tensors,
    concatenated (None: one zero row), ``leaf_rows`` the gathered resident
    leaves (bank 1 before the ad-hoc rows).  One B5 launch; returns the
    per-section expr outs (the buckets' outputs stay with the groups)."""
    dev = (bank_a if bank_a is not None else leaf_rows).device \
        if (bank_a is not None or leaf_rows is not None) else None
    if arrs is None:
        arrs = mega.device_arrays(dev)
    if bank_a is None:
        bank_a = torch.zeros((1, WORDS32), dtype=torch.int32,
                             device=arrs["extra"].device)
    bank_b = arrs["extra"]
    if leaf_rows is not None and leaf_rows.shape[0]:
        bank_b = torch.cat([leaf_rows, bank_b])
    out_rows, card_rows = raw_call(mega, bank_a, bank_b, arrs["cols"],
                                   stream=arrs["stream"],
                                   steps_dev=arrs.get("steps"))
    return _slice_outputs(mega, out_rows, card_rows)[1]


# ------------------------------------------------- test and smoke streams

def random_plan(seed: int, n_steps: int = 256, slots_pad: int = 16,
                out_pad: int = 8, card_pad: int = 16,
                bank_rows=(8, 4, 4)):
    """A seeded random stream over all 20 opcodes, for holding B5 against
    its plain version: every slot (the dead one included) is set first, each
    real out and card row is written by exactly one step, OUT/CARD/VAGG_CARD
    target the dead slot, other steps the dead out/card rows, and TAKE
    sums slots of random words (so the int32 sum wraps).
    Returns (MegaPlan, [three uint32 banks])."""
    rng = np.random.default_rng(seed)
    banks = [rng.integers(0, 1 << 32, (r, WORDS32), dtype=np.uint64)
             .astype(np.uint32) for r in bank_rows]
    banks[0][0] = 0xFFFFFFFF          # an all-ones row: TAKE sums of -1s
    em = _Emitter()

    def row_op(opc, dst, src=0, crow=None):
        b = int(rng.integers(3))
        em.emit(opc, dst=dst, src=src, bank=b,
                row=int(rng.integers(bank_rows[b])), crow=crow)

    for s in range(slots_pad + 1):
        if s % 3:
            row_op(LOAD_ROW, s)
        else:
            em.emit(ZERO, dst=s)
    outs = list(rng.permutation(out_pad))
    cards = list(rng.permutation(card_pad))
    slot = lambda: int(rng.integers(slots_pad + 1))   # noqa: E731
    n_body = max(n_steps - len(em.ops), len(outs) + len(cards) + N_OPCODES)
    body = list(range(N_OPCODES)) + list(rng.integers(0, N_OPCODES,
                                                      n_body - N_OPCODES))
    for opc in rng.permutation(body):
        opc = int(opc)
        if opc == OUT:
            if len(outs) > 1:       # the last out row is written below
                em.emit(OUT, src=slot(), orow=int(outs.pop()))
        elif opc in (CARD, VAGG_CARD):
            if len(cards) > 2:      # the last two card rows are below
                crow = int(cards.pop())
                if opc == CARD:
                    em.emit(CARD, src=slot(), crow=crow)
                else:
                    row_op(VAGG_CARD, 0, slot(), crow)
        elif opc == TAKE:
            imm = int(rng.integers(-(1 << 31), 1 << 31))
            em.emit(TAKE, dst=slot(), src=slot(), imm=imm)
        elif opc in ROW_OPS:
            row_op(opc, slot(), slot())
        else:
            em.emit(opc, dst=slot(), src=slot())
    for r in outs:
        em.emit(OUT, src=slot(), orow=int(r))
    row_op(VAGG_CARD, 0, slot(), int(cards.pop()))
    for r in cards:
        em.emit(CARD, src=slot(), crow=int(r))
    host = em.finish(slots_pad, out_pad, card_pad)
    host["extra"] = banks[1]
    mega = MegaPlan(mode="full", n_steps=len(em.ops),
                    steps_pad=int(host["opc"].shape[0]), n_slots=slots_pad,
                    slots_pad=slots_pad, out_pad=out_pad, card_pad=card_pad,
                    host=host, extra_rows=bank_rows[1])
    return mega, banks


def stream_bytes(mega: MegaPlan) -> int:
    """Bytes B5 must move at least: each distinct bank row that a step
    reads (8 KiB), each real out row written (8 KiB) and each real card row
    written (its SLICES partials), once; and the 32 B of each real step.
    The stream's padding and the dead rows move nothing."""
    h = {k: mega.host[k][:mega.n_steps] for k in STREAM_KEYS}
    reads = np.isin(h["opc"], list(ROW_OPS))
    n_rows = np.unique(np.stack([h["bank"][reads], h["row"][reads]]),
                       axis=1).shape[1]
    n_out = np.unique(h["orow"][h["orow"] < mega.out_pad]).size
    n_card = np.unique(h["crow"][h["crow"] < mega.card_pad]).size
    return ((n_rows + n_out) * WORDS32 * 4 + n_card * SLICES * 4
            + mega.n_steps * 32)

