#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's wide-aggregation path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--bitmaps N]

Phases (each timed; any mismatch raises, so the script exits non-zero):

1. print the card's name and power limit, build the CUDA kernels with nvcc;
2. dense resident set: ``synthetic_bitmaps(N=4096, universe=2^24,
   density=0.0025)``; or/xor/and on the "cuda" engine are bit-equal to the
   "torch" engine, or/xor one B7 launch (the set records the streams
   path), and a set of the first 512 bitmaps equals the host fold;
3. counts set (uscensus2000-shaped: 2N = 8,192 bitmaps of 4 containers of
   4 values on uniform keys): ``layout="auto"`` must choose counts and
   record B7's path; or/xor checked as in 2; a counts set forced over 64
   bitmaps of bitmap containers on 512 keys must keep B4, its or/xor equal
   to the host fold;
4. compact set over the first 1,024 bitmaps of 2; or/xor/and checked as in 2;
   one ``or`` traced with ``torch.profiler``: its host time beside its
   kernels' device time;
5. ad-hoc calls over 1,024 bitmaps: ``or_``, ``xor``, ``or_cardinality``,
   ``xor_cardinality``, and ``and_`` over bitmaps that share keys;
7. batch and expression queries (``BatchEngine.execute``), run before 6:
   a. 64 flat queries (``random_query_pool``, bitmap form) over the set of 2:
      "auto" is the "cuda" rung (gather + B1); equal to the "torch" rung,
      and the first 8 to the host fold;
   b. a search-shard-shaped set, ``synthetic_bitmaps(4096, universe=2^20,
      density=1/64)``: the largest power-of-two Q <= 64 of depth-2
      ``random_expr_pool`` queries (plus two fixed depth-2/3 shapes) whose
      megakernel plan fits; "auto" is the megakernel (one B5 launch), equal
      to the "cuda" and "torch" rungs and to ``expr.evaluate_host``; then
      one batch on a compact set of its first 1,024 bitmaps (B3 + B5);
   c. capacity at K = 256 (the set of 2): an 8-query expression batch must
      be demoted on "slots" and counted, and the depth-2 query
      ``(0 | 1) & ~2`` must fit and run on the megakernel;
8. the compact nibble engine, the probes, DeviceBitmap and pairwise, run
   after 7 and before 6, on the sets of 2-4:
   a. the bitmaps of 2, every 16th ORed with a 1/8-density block over its
      first 8 keys (bitmap containers, so the dense-wire stream is not
      empty), as a compact set: or/xor on "cuda-nibble" (one B6 launch
      each) bit-equal to "cuda" (B3 + B2) and "torch"; on the first 512,
      equal to the host fold; device time, unpack and peak memory;
   b. ``chained_wide_or(8)`` and ``chained_aggregate(op, 8)`` on the dense
      set of 2 (or/xor/and), the counts set of 3 (or/xor) and the set of 8a
      ("cuda" and "cuda-nibble"; or/xor/and): each total equals
      (8 * cardinality) % 2^32; per-iteration device time beside the single
      query's;
   c. ``aggregate_range_cardinality`` on the dense set over a range across
      key boundaries, [0, 2^32) and an empty range, against the host's
      ``range_cardinality``; ``DeviceBitmap.aggregate(dense, "or") -
      DeviceBitmap.aggregate(compact of 4, "xor")`` against the host
      difference of the torch engine's aggregates; ``contains_batch`` over
      2^20 probes (half members) against the host;
   d. a ``DevicePairSet`` of the 2,048 consecutive pairs of 2's bitmaps in
      the dense and compact layouts: or/and/xor/andnot cardinalities equal
      to the host's, ``pairwise`` on the first 64 pairs equal to the host,
      ``chained_cardinality(op, 4)`` and ``chained_pairwise_cardinality``
      equal to (4 * sum) % 2^32;
9. value columns, run after 8 and before 6:
   a. the search-shard set of 7b with two columns over its 2^20 row ids: a
      ``BsiColumn("price")`` (one value per row, uniform in [0, 2^31 - 1),
      depth 31 padded to 32) and a ``RangeColumn("ts")`` (40-bit values,
      padded depth 64); every predicate op on both kinds, composed with
      set algebra, and ``sum_`` / ``top_k(k=100)`` roots over both, cut
      into the fewest batches that fit B5: each batch on "auto" is ONE B5
      launch, equal to the "cuda" and "torch" rungs and to the host
      oracles; then four ``top_k`` roots over "ts", a plan past
      ``MAX_STEPS``, demoted to "cuda" (counted under "steps") and still
      exact;
   b. ``two_phase_execute`` on the aggregate roots of 9a equals the fused
      answers; both times;
   c. ``DeviceBSI`` over phase 2's 2^24-row universe (K = 256, depth 31)
      and ``DeviceRangeBitmap`` over "ts": every op's compare and
      cardinality, the sum and ``top_k(1000)`` against the host
      ``RoaringBitmapSliceIndex`` / ``RangeBitmap``; the chained probes
      for 8 reps with their time per iteration;
10. the 64-bit tier, the guard and native ingest, run after 9 and before 6;
    every set holds Roaring64Bitmaps, bitmap i in the high-32 bucket
    [0, 1, 2^31, 2^32 - 1][i % 4], so the u48 keys cross 2^32 and 2^63:
    a. phase 2's bitmaps lifted (their containers reused): a dense set of
       K = 4 x phase 2's keys over the same rows; or/xor/and on "cuda"
       (B2) bit-equal to "torch", and on the first 512 to the host fold of
       Roaring64Bitmaps; device and unpack ms beside phase 2's; the compact
       set of the first 1,024 (B3 + B2);
    b. ``or64`` / ``xor64`` over the first 1,024 (cuda == torch, and on the
       first 512 the host fold), ``and64`` over phase 5's AND inputs at
       2^63; a flat ``random_query_pool(N, 64)`` batch on the 64-bit set
       (gather + B1) and an expression batch on the lifted search-shard set
       of 7b (one B5 launch); ``contains_batch`` of 2^20 u64 probes (half
       members, about half >= 2^63) and the same bits as int64 probes;
    c. the guard: no demotion and no sequential landing in phases 2-10b;
       then faults through ``faults.inject``: a transient on "aggregation"
       is retried once, equal; ``lowering@cuda`` on one ``or_`` raises
       ``EngineLoweringError`` (on the card no call demotes to the plain
       version or the host, and nothing launches); ``oom@megakernel``
       halves a 2-query batch and lands each half on the "cuda" kernels,
       counted and equal; shadow rate 1.0 passes on a clean
       batch and raises ``ShadowMismatch`` under ``silent@batch_engine``;
    d. phase 5's bitmaps as serialized bytes: ``pack_blocked_compact`` on
       the native engine equal to the NumPy path array for array, both
       timed on the host; the set of the native pack's ``or`` on the card;
11. the pooled multi-tenant engine, run after 10 and before 6:
    a. phase 2's first 4,096 bitmaps dealt into 16 tenants of 256
       (tenants 0-11 dense, 12-15 compact, rebuilt by B3 inside each pooled
       launch); ``random_multiset_pool([256] * 16, Q, seed=0xACE)``: the
       Q 64 pool in bitmap form on pooled "cuda" equals the per-set loop
       (16 ``BatchEngine.execute`` calls), pooled "torch" and the host fold
       of every query, with one B1 launch per op group; at Q 64 and Q 256
       (cardinality form) the pooled wall time against the per-set loop's,
       with Q/s, the B1/B3 launches of each, and one traced run of each
       (host time, device busy time, idle share);
    b. 7b's search-shard bitmaps dealt into 16 tenants of 256, each with
       depth-2 ``random_expr_pool`` queries, tenants 0-3 carrying phase 9's
       ``price`` column with a ``range_`` and a ``sum_`` query: the pool
       whose plan fits B5 runs in ONE B5 launch, equal to pooled "cuda",
       the per-set loop and the host oracles; plan, device, unpack ms;
    c. eight Q 64 pools through ``execute_pipelined`` at depth 1, 2, 4
       (equal to ``execute``; host and overlap ms); the Q 256 pool under
       a budget of a quarter of its prediction: proactive splits, every
       launch's prediction within the budget and its measured peak
       (``max_memory_allocated``) within its prediction, equal results;
       then no demotion or host landing at site multiset, a drain-time
       transient re-run, an OOM halving with each half on "cuda", and
       ``lowering@cuda`` raising ``EngineLoweringError`` with no launch;
    d. the first 1,024 bitmaps of 2 lifted as in 10a, 4 dense tenants: the
       Q 64 bitmap pool on pooled "cuda" equals the per-set loop, with
       ``Roaring64Bitmap`` results;
13. the compile vocabulary (``runtime.lattice``), run after 11 and before
    12, on data the earlier phases built: each engine's traffic needs read
    off its exact plans, a one-rung profile covering them printed, then
    ``warmup(profile=...)`` (points, programs, captured graphs, wall, the
    graph pool's bytes against the budget) and the sealed traffic as one
    main-path call: no escape, no capture, every batch the replay of a
    warmed graph, equal to the eager rung with no lattice, on samples to
    the "torch" rung and the host; per engine one batch timed, graph
    against eager (wall, host dispatch, device; medians of 5, warm; the
    traced kernels; the padding); one batch past the vocabulary counted
    as one escape and exact:
    a. the set of 2: ``random_query_pool(4096, 64)`` at seeds 1-8 in both
       forms (gather + B1 in graphs); then a set of its first 256 bitmaps
       patched in place and replayed (equal to "torch"), and repacked (its
       graphs retired, the pool's bytes released);
    b. 7b's shard with 9's columns: two expression pools (prepared with
       ``warmup(queries=...)`` before the seal: a novel DAG is a new
       program) and 9a's value batches at new predicate values (warmed at
       9a's), B5 in graphs; 7b's compact set: two pools, B3 + B5 in graphs;
    c. 11a's 16 tenants: eight Q 64 pools at seeds 200-207 through
       ``execute`` and ``execute_pipelined`` at depth 2 (pooled B1 and
       the compact tenants' B3 in graphs);
12. mutable tenants, run after 13 and before 6:
    a. 64 seeded deltas of ~100 adds and ~100 removes over 1-64 existing
       rows each (16 keys of the set of 2), patched in place: every 8th,
       or/xor (B2) and a flat batch (B1) equal to the "torch" engine; at
       the end the touched keys' or/xor and the batch equal the host fold
       of the smoke's own rows, the row and source versions stamp exactly
       the touched ones; the patch's median ms;
    b. a set of 2's first 256 bitmaps: a structural, a drift and a
       maintenance-worker repack (the queued one serving the pre-delta
       image at the old version until ``drain``), ``repack="never"``
       raising with nothing mutated; the compact set of 4 takes the layout
       repack; each repack's wall time;
    c. 7b's shard with a ``ResultCache``: its expression pool replayed in
       bitmap and cardinality form (hit rate; all-hit against all-miss
       ms), a query over a cached subtree (``n_cached`` >= 1) in one B5
       launch with the entry's rows unchanged, a source delta dropping
       exactly the entries that read it, a ``BsiColumn`` delta and 9a's
       first value batch on B5 against the host oracles;
    d. phase 11's 16 tenants sharing one cache: the Q 64 pool filled, then
       served without a launch (``count_cache_hits`` = the hits); a delta
       to tenant 3 dropping only its entries; a structural repack of
       tenant 5, after which the pool equals the per-set loop;
14. the serving stack (``serving``, ``wire``, ``mutation.durability``), run
    after 12 and before 6, over phase 11's 16 tenants (the two phase 12
    mutated rebuilt), each with a ``BsiColumn("v")`` drawn as
    ``replay.build_dataset`` draws one (ids from 2^24, values in [1,
    2^16)); the traffic is ``replay.generate(ReplayProfile(sets=16,
    sources=256, tenants=64, users=2^24, requests=2048, duration_s=4.0,
    seed))`` under ``ServingPolicy(pool_target=64)``:
    a. the query-only stream through ``run_inproc`` at the profile's rate,
       then a ladder at 1/4 and 1/16 of it over the stream's first
       eighth (``replay.sustained``): every served ticket equal to the
       host oracle, typed outcomes only, no pump error; counts, p50/p99 on
       the fault clock, Q/s, attainment, pools, launches, a pool's host
       ms in the loop beside the engine's wall, admission ms; one traced
       pump;
    c. the resident ring lane: 32 pools of [expression, flat] from two
       tenants, each pool's graph captured, ``warmup(profile=...)`` and the
       seal, then every pool ring-served (the dispatch count flat, no
       capture, no escape), equal to the one-shot dispatch and 14a; a pool
       past the vocabulary and a wedged ring demote typed
       ("vocabulary", "wedged") and are served exactly; host ms a pool,
       ring against one-shot;
    e. a ``WireServer`` over 14a's loop at the sustained rate (results
       equal 14a's; p50/p99 wall, Q/s), ``wire@slow_peer`` and a malformed
       submit answered typed on a live connection, a tenant outside its
       grant ``AuthRejected``, tenant 1's captured state as ``mig_*``
       frames committed onto the card with its source CRCs, and a
       ``bootstrap --device cuda`` child serving the port's client exactly
       and exiting 0 when its pipe closes;
    b. the default mix's first eighth with its deltas (an escalating delta
       repacks on a ``MaintenanceWorker`` under the loop's lock): typed
       only; after the drain every tenant's host twin equals a host copy
       with the deltas applied in order, and a pool equals the host oracle;
    d. a ``DurableTenant`` over a copy of tenant 0 (journal ``always``),
       64 deltas of the generator's shape inside its containers, a
       snapshot after 32, crashes at ``pre_append``, ``pre_apply``,
       ``pre_apply@torn`` and ``post_apply``, each recovered onto the card
       equal to a never-crashed twin (image words, host twin,
       cardinality); group commit over 4 tenants; append, snapshot and
       recovery ms;
15. observability (``obs``), run after 14 and before 6, over 14's tenants:
    a. the first 256 requests of 14a's stream at 1/16 of its rate through a
       ``ServingLoop`` traced with ``obs.enable(path)``: every served
       ticket equal to the host oracle; ``tools/check_trace.py`` (plain
       mode, a subprocess) accepts the dump; B1, B3 and B5 each launched
       inside the loop's dispatch (the ``serving.dispatch`` span); the
       host ms by span (``serving.admit`` / ``assemble`` / ``shed`` /
       ``dispatch``, and within each the planner spans, ``expr.compile``
       and the B5 stream builds) beside the engine's wall and the cost
       events' ``device_ms``;
    b. traced: 11a's Q 64 pool, 7b's expression batch and a 64-operand
       ``or`` over the set of 2 (K 256), plus an ad-hoc ``or_`` (B2) under
       ``aggregation.wide``: each dispatch span's cost event has
       ``device_ms`` > 0, ``bytes_accessed`` equal to the plan's
       prediction and a roofline fraction in (0, 1] against the H100 row;
       its memory event's measured peak is within the prediction; the
       fractions are printed after 6 beside each kernel's share of its
       bound;
    c. an SLO deadline no pool can meet (an ``slo`` event whose phases sum
       to its wall) and a served request past its deadline (a flight dump
       that parses and validates); ``transient@multiset.drain=0.5``, after
       which the registry's guard counters equal ``dispatch_stats()``;
       ``obs.statusz`` with the serving, ring, journal and lattice
       sections; every line of ``render_prometheus()`` parsed; one pump
       under ``torch.profiler`` with the spans as profiler ranges
       (``ROARING_TPU_TRACE_XPROF``): the device-busy share of each range;
    d. the Q 64 pool's wall, median of 5 warm, tracing off and on;
16. mesh and pod (``parallel.sharding``, ``sharded_engine``,
    ``multihost``, ``podmesh``; ``serving.frontdoor``, ``migration``), run
    after 15 and before 6, over logical shards of the one card (they
    measure the combine's cost, not scaling):
    a. ``wide_aggregate_sharded`` or/xor (both ingests) and and over
       phase 5's 1,024 bitmaps and AND inputs on ("rows", "lanes") meshes
       1x1, 4x1, 2x2, 8x1 (and or on 2x4, 1x8): each equal to the
       single-device ``or_`` / ``xor`` / ``and_`` and the host fold, B1
       launched at width 2048 / lanes; 10a's lifted u48 bitmaps over 4x1
       against ``or64`` / ``xor64`` / ``and64``; 8,969 keys, chunked;
    b. ``ShardedBSI`` over 9c's 2^24 rows and ``ShardedRangeBitmap`` over
       9a's ``ts`` on a 4x2 mesh, equal to ``DeviceBSI`` /
       ``DeviceRangeBitmap``;
    c. ``ShardedBatchEngine`` over 15's 16 tenants (12 dense, 4 compact,
       placed by B3 from their resident words): 4x1 sharded and 2x2
       replicated, the Q 64 and Q 256 pools in both forms equal to
       ``MultiSetBatchEngine`` (and samples to the host fold), walls
       beside it; the Q 256 pool under a quarter of its per-shard
       prediction (split counts beside the pooled engine's); faults
       ``transient@mesh`` and ``lowering@mesh`` demoting to ``single``
       only; ``warmup(profile=...)`` and the sealed Q 64 pool as a graph
       replay with zero escapes; 11b's expression pool as ONE B5
       combine-mode launch;
    e. ``multihost.initialize`` at world size 1 on NCCL: 16c's Q 64 pool
       over ``global_mesh()`` equal to 16c's, a ``ShardedBSI`` sum through
       an NCCL ``all_reduce``; two gloo ranks sharing the card (this script
       run as ``--gloo-rank R``) run the Q 64 pool's tenants 0-2 over a
       pod-spanning mesh, equal, with the bytes staged through pinned host
       memory counted; an unreachable coordinator raises
       ``CoordinatorTimeout`` within its budget;
    d. ``PodMesh.simulate(2, devices=["cuda:0"] * 8)``: ``place`` with a
       budget and rates that yield all three regimes; a ``PodFrontDoor``
       replays 14a's first 256 requests at 1/16 with ``fail_host(1)``
       midway (every served ticket equal to the host oracle, reroutes and
       single-host demotions counted); ``migrate_tenant`` with a delta in
       flight, ``host_join``, ``host_leave``; ``migrate_tenant_wire`` to a
       ``bootstrap --frontdoor 2 --device cuda`` child, CRCs equal;
17. the engine leftovers of queues A2-A8, run after 16 and before 6:
    a. ``models.flagship.forward`` over phase 5's 1,024 bitmaps (K 256):
       one B1 launch, equal to B1's plain version and to ``or_``;
    b. ``DeviceBitmapSet.evaluate`` over 7b's shard, every 7b expression
       in both forms: one B5 launch a call, equal to ``execute``, plan
       cache hits on repeat; 7b's compact set: B3 + B5 a call;
    c. ``BatchEngine.chained_cardinality`` over 7a's batch at 8 reps (and
       a Q 16 batch on 7b's compact set, B3 + B1 a rep): total == 8 x the
       sum mod 2^32; ms a rep beside one ``execute``;
    d. the "torch-vmap" rung asked for by name over 7a's batch and 11a's
       Q 64 pool, bit-equal to "cuda"; the card's chain stays
       megakernel -> cuda with zero demotions;
    e. ``expr.execute_node_at_a_time`` over 7b's 32 expressions (B1 a
       reduce node, host combines) equal to the fused B5 batch; both walls;
    g. ``explain`` of 7a's and 7b's batches and ``explain_wide`` of 5's
       ``or_``: engine chains, predicted bytes beside the measured peak of
       the call that follows; ``hbm_bytes`` of the engines against their
       sets';
    f. (last: it moves the set's version) ``warmup_delta(64)`` on phase
       2's dense set captures one CUDA graph a rung; 12a's 64 deltas
       replayed through them leave the image as the eager patches did (a
       value's fate is set by the last delta naming it); patch ms graph
       against eager with the host planning share; on two sets of 2's
       first 256 bitmaps, 16 deltas through graphs with the host twin
       riding leave image and twin equal to the eager set's, and a repack
       drops the warmed set's graphs;
18. the rest of the host tier, run after 16 and before 17: phase 2's 4,096
    bitmaps and phase 5's 1,024 (and its AND inputs) serialized once and
    wrapped as ``ImmutableRoaringBitmap``s over one memoryview each; every
    arm runs beside its heap-source twin (both walls printed) and is
    bit-equal to it:
    a. ``or_`` / ``xor`` / ``and_`` / ``or_cardinality`` over the 1,024
       immutables (B2, B1);
    b. ``DeviceBitmapSet`` of the 4,096 in the dense, compact and counts
       layouts (row sources and bytes equal; or/xor/and through B2, B3 + B2,
       B4), and the "auto" layout's choice the same over both sources;
    c. 7b's expression batch over a dense set of the shard's immutables (one
       B5 launch), and a query with an immutable ``AdHoc`` leaf;
    d. phase 9's ``price`` column re-attached as a ``BsiColumn`` over an
       ``ImmutableBitSliceIndex`` of its serialized bytes and ``ts`` as a
       ``RangeColumn`` over ``RangeBitmap.map`` of its bytes: 9a's value
       batches, one B5 launch each;
    e. 10a's lifted bitmaps as ``Roaring64NavigableMap``s through ``or64``
       (B2) and ``and64``;
    f. bitmaps built by ``RoaringBitmapWriter`` (the first 256) and
       ``RoaringBitSet``s (all 1,024) through ``or_``;
    B1-B5 must each launch in the phase;
6. each kernel against its plain PyTorch version on the card, at the shapes
   of 2-5 and 8a and, for B5, of 7b and of 9a's longest plan, plus a
   random stream over all 20 opcodes: bit-equal words and cards,
   CUDA-event median times, the bound; B5's time per step; B1 at 1,024,
   512 and 256 words (16a's shard shapes), B1 at the largest op group of
   11a's Q 64 pooled launch (2-8 rows a segment) and B5 on 16c's
   combine-mode plan, each its own row of the kernels line (launches by
   variant; the pooled row's are 11a's pooled B1 launches); B1's and B2's
   rows print the port's PR 14 times beside their own, and B1's rows the
   time of the same call's device part alone (one CUDA graph replay) at
   the wrapper's chunk rows and at half and twice its blocks an SM, and
   the host's microseconds a call; B7 at the uscensus2000_like cell's
   shape, and B7 against B4, each alone, over that set and over 3's
   bitmap-container set, where the rule keeps B4.  Phase 1 prints
   ``ptxas -v``'s registers, shared memory and spills of every kernel
   entry of B1's chunked kernel.
19. B8 at the dense cells' full builds, run last: the compact streams of
    the benchmark's ``census1881_srt_like`` and ``census1881_like`` sets
    (``cardbench/gen.py``, 128 segments each, the dense layout's pack with
    its run stream) on the card; B8 (``kernels.row_build``) bit-equal to
    its plain version; B8 alone (one graph replay) and the plain version's
    time beside its bound from the bytes the build needs
    (``b8_launch_bytes``, the count of ``row_build_roofline.setup``) and
    from the bytes the kernel reads (each value as an int32, and its plan);
    each a row of the kernels line; then B7's run variant, as a dense set
    of that shape runs its or/xor, bit-equal to the plain reduce and to B2
    over B8's image, alone (one graph replay) beside its bound from the
    bytes the op needs (2 bytes a value) and beside B2 alone, the slower of
    or and xor a row each.

Kernel launch counts are set to 0 just before each main-path call and read
just after it; the ``kernels`` line reports their sums.  Each phase prints
its time.  The span dumps of 13 and 15 go to ``smoke_out/``
beside the script (``ROARING_TPU_TRACE=<path>`` traces the whole run as
well).  The last line is the device JSON.  Needs one CUDA device; without
one it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

#: H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and the INT32 rate of
#: the kernels' word operations: 64 INT32 lanes per SM (Hopper architecture
#: white paper) x 132 SMs x 1.98 GHz boost = 16.7e12 ops/s.  (67e12 is the
#: FP32 FMA rate counting two flops per FMA; it does not apply.)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 132 * 64 * 1.98e9
#: bitmaps whose host fold checks each layout
HOST_CHECK_N = 512
#: repetitions of a resident query split into device time and host unpack
#: (fewer once they have taken 2 s)
SPLIT_REPS = 5
#: values of the BSI columns of phase 9: uniform in [0, PRICE_MAX)
PRICE_MAX = 2**31 - 1
#: high-32 buckets of phase 10's 64-bit bitmaps (bitmap i in i % 4): the
#: u48 keys cross 2^32 and 2^63
BUCKETS = (0, 1, 2**31, 2**32 - 1)


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch_mod, kernels_mod):
        self.torch = torch_mod
        self.kernels = kernels_mod
        self.launches = {k.name: 0 for k in kernels_mod.KERNELS}
        #: launches by (kernel, variant): B1's row width, B5's stream mode
        self.variants: dict = {}
        #: the launch counts of the latest main-path call
        self.last = dict(self.launches)

    def main_path(self, label: str, fn):
        """Run one main-path call with the launch counts set to 0 just
        before it and read just after it."""
        self.kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k.name: k.launches for k in self.kernels.KERNELS}
        self.last = counts
        for name, c in counts.items():
            self.launches[name] += c
        for k in self.kernels.KERNELS:
            for v, c in k.variants.items():
                self.variants[(k.name, v)] = \
                    self.variants.get((k.name, v), 0) + c
        used = ", ".join(f"{n}={c}" for n, c in counts.items() if c) or "none"
        log(f"  [{label}] {dt:.3f} s, launches: {used}")
        return out


def host_fold(op: str, bitmaps):
    acc = bitmaps[0]
    for b in bitmaps[1:]:
        acc = acc | b if op == "or" else acc ^ b if op == "xor" else acc & b
    return acc


def host_query(q, bitmaps):
    """A flat BatchQuery over the input bitmaps, folded on the host."""
    if q.op == "andnot":
        acc = bitmaps[q.operands[0]]
        for i in sorted(set(q.operands[1:])):
            acc = acc - bitmaps[i]
        return acc
    return host_fold(q.op, [bitmaps[i] for i in sorted(set(q.operands))])


def same_results(got, want) -> bool:
    """Batch results equal: cardinalities, sums, and bitmaps where
    present."""
    return len(got) == len(want) and all(
        (g.cardinality, g.value) == (w.cardinality, w.value)
        and g.bitmap == w.bitmap for g, w in zip(got, want))


def value_pool(expr, price, ts, srcs, alt: int = 0) -> list:
    """Every predicate op on both column kinds, each composed with set
    algebra, then sum_ and top_k(k=100) roots over both columns (top_k in
    both result forms).  eq/neq compare with the stored value of a row of
    source 0, and those queries keep source 0 in their found set.  ``alt``
    > 0 gives the same queries at other predicate values: thresholds
    scaled by (10 - alt) / 10, another row's stored value, k 100 - 7 alt."""
    row = int(srcs[0].to_array()[len(srcs[0]) // (2 + alt)])
    p_at, t_at = int(price.host.get_value(row)[0]), int(ts.values[row])
    pm = PRICE_MAX * (10 - alt) // 10
    tm = ts.max_value * (10 - alt) // 10
    k = 100 - 7 * alt
    preds = ([("price", op, v) for op, v in (
                 ("eq", p_at), ("neq", p_at), ("lt", pm // 3),
                 ("le", pm // 3), ("gt", pm // 2), ("ge", 2 * pm // 3),
                 ("range", (pm // 4, pm // 2)))]
             + [("ts", op, v) for op, v in (
                 ("eq", t_at), ("neq", t_at), ("lt", tm // 3),
                 ("le", tm // 3), ("gt", tm // 2), ("ge", 2 * tm // 3),
                 ("range", (tm // 4, tm // 2)))])
    pool = []
    for i, (col, op, v) in enumerate(preds):
        pred = (expr.range_(col, *v) if op == "range"
                else expr.cmp(col, op, v))
        a, b = (0, 5) if op in ("eq", "neq") else (2 * i + 1, 2 * i + 2)
        e = (expr.and_(expr.or_(a, b), pred) if i % 2 == 0
             else expr.andnot(pred, expr.ref(b)))
        pool.append(expr.ExprQuery(e, form="bitmap" if i % 3 == 0
                                   else "cardinality"))
    in_band = expr.and_(expr.or_(0, 1), expr.range_("price", pm // 4,
                                                    3 * pm // 4))
    pool += [
        expr.ExprQuery(expr.sum_("price", found=in_band)),
        expr.ExprQuery(expr.sum_("ts", found=expr.or_(2, 3))),
        expr.ExprQuery(expr.sum_("price")),
        expr.ExprQuery(expr.top_k("price", k, found=expr.or_(4, 5)),
                       form="bitmap"),
        expr.ExprQuery(expr.top_k("price", k, found=in_band)),
        expr.ExprQuery(expr.top_k("ts", k, found=expr.andnot(
            expr.cmp("ts", "ge", tm // 2), expr.ref(6))), form="bitmap"),
        expr.ExprQuery(expr.top_k("ts", k, found=expr.or_(7, 8)))]
    return pool


def fitting_batches(eng, pool) -> list:
    """``pool`` cut, in order, into batches that each fit B5 (``MAX_STEPS``
    and ``MAX_SLOTS``): each takes queries while its plan fits.  Returns
    [(batch, host ms of its plan)]."""
    batches, cur, cur_ms = [], [], 0.0
    for q in pool:
        t0 = time.perf_counter()
        mega = eng.plan(cur + [q]).mega
        ms = (time.perf_counter() - t0) * 1e3
        if mega is not None and mega.fits():
            cur, cur_ms = cur + [q], ms
            continue
        require(bool(cur), f"one query does not fit B5: {q}")
        batches.append((cur, cur_ms))
        cur = []
        mega = eng.plan([q]).mega
        require(mega is not None and mega.fits(),
                f"one query does not fit B5: {q}")
        cur = [q]
    return batches + [(cur, cur_ms)] if cur else batches


def check_value(expr, label, eng, pool, srcs, cols, got,
                rungs=("cuda", "torch")) -> None:
    """Results equal to the other rungs, each timed on its first (cold)
    and second (warm) execute, and to the host oracles:
    ``evaluate_host`` and ``evaluate_host_agg`` over the columns."""
    rung_ms = {}
    for rung in rungs:
        require(same_results(got, eng.execute(pool, engine=rung)),
                f"{label}: != {rung} rung")
        cold = eng.last_timings["device_ms"]
        eng.execute(pool, engine=rung)
        rung_ms[rung] = (f"{cold:.3f} cold / "
                         f"{eng.last_timings['device_ms']:.3f} warm")
    log(f"    {label}: device ms of the other rungs {rung_ms}")
    t0 = time.perf_counter()
    for i, (q, r) in enumerate(zip(pool, got)):
        if expr.is_agg(q.expr):
            card, value, bm = expr.evaluate_host_agg(q.expr, srcs, cols)
            ok = ((r.cardinality, r.value) == (card, value)
                  and (q.form != "bitmap" or r.bitmap == bm))
        else:
            want = expr.evaluate_host(q.expr, srcs, cols)
            ok = (r.cardinality == want.cardinality
                  and (q.form != "bitmap" or r.bitmap == want))
        require(ok, f"{label}: query {i} != the host oracle")
    log(f"    {label}: equal to the {'/'.join(rungs)} rungs and the host "
        f"oracles (checked in {time.perf_counter() - t0:.1f} s); cards "
        f"{[r.cardinality for r in got[:6]]} ...")


def ctr(name: str, **labels) -> float:
    """The obs registry's counter ``name`` summed over every label set that
    includes ``labels``."""
    from roaringbitmap_tpu_torch.obs import metrics
    return sum(inst.value for n, lab, inst in metrics.REGISTRY.instruments()
               if n == name and inst.kind == "counter"
               and labels.items() <= lab.items())


def delta_modes() -> dict:
    """{mode: deltas} of the registry's ``rb_delta_apply_seconds``."""
    from roaringbitmap_tpu_torch.obs import metrics
    return {lab["mode"]: inst.count
            for n, lab, inst in metrics.REGISTRY.instruments()
            if n == "rb_delta_apply_seconds"}


def by_label(name: str, key: str) -> dict:
    """{label value: summed value} of the registry counter ``name``."""
    from roaringbitmap_tpu_torch.obs import metrics
    out: dict = {}
    for n, lab, inst in metrics.REGISTRY.instruments():
        if n == name and inst.kind == "counter" and key in lab:
            out[lab[key]] = out.get(lab[key], 0) + inst.value
    return out


#: where the smoke writes its span dumps (gitignored)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")


def out_path(name: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    if os.path.exists(path):
        os.remove(path)
    return path


def trace_into(obs, path: str, xprof: bool = False):
    """Trace into ``path`` until ``stop()`` is called, then go back to the
    sink that was enabled before (``ROARING_TPU_TRACE`` of the whole run)
    or to no tracing; returns ``stop``."""
    prev = obs.trace.path()
    obs.enable(path, xprof=xprof)

    def stop():
        obs.enable(path, xprof=False)     # the bridge off, then the sink
        obs.disable()
        if prev:
            obs.enable(prev)

    return stop


def read_spans(path: str) -> list:
    """The span records of a JSONL dump."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_time(name: str, t0: float) -> None:
    log(f"  {name} took {time.perf_counter() - t0:.1f} s")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_set(smoke: Smoke, label: str, ds, ops, unpack) -> dict:
    """Each op through the user entry point on the cuda engine, bit-equal to
    the torch engine's device words and cards.  Then the same query split
    into its device part (to synchronize) and its host unpack; returns
    {op: (device ms, unpack ms)}."""
    torch = smoke.torch
    times = {}
    for op in ops:
        got = smoke.main_path(f"{label} {op}", lambda op=op: ds.aggregate(op))
        words, cards = ds.aggregate_device(op, engine="torch")
        want = unpack(ds.keys, words, cards)
        require(got == want, f"{label} {op}: cuda engine != torch engine")
        split = []
        for _ in range(SPLIT_REPS):
            t0 = time.perf_counter()
            words, cards = ds.aggregate_device(op)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            unpack(ds.keys, words, cards)
            split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            if sum(map(sum, split)) > 2000:
                break       # a seconds-long unpack is timed once
        times[op] = tuple(float(np.median(x)) for x in zip(*split))
        log(f"    {op}: cardinality {got.cardinality} (cuda == torch); "
            f"device {times[op][0]:.3f} ms, host unpack "
            f"{times[op][1]:.3f} ms (medians of {len(split)})")
    return times


def bitmap_container_bitmaps(n: int, keys: int, seed: int) -> list:
    """``n`` RoaringBitmaps, each a bitmap container of random bits at
    density 1/8 (~8,192 values) on every key of [0, keys): a counts set of
    them reads more dense-wire rows than count groups, so it keeps B4."""
    from roaringbitmap_tpu_torch import RoaringBitmap
    from roaringbitmap_tpu_torch.core import containers

    rng = np.random.default_rng(seed)
    key_ids = np.arange(keys, dtype=np.uint16)

    def words():
        return np.frombuffer(rng.bytes(keys * 8192), np.uint64).reshape(
            keys, 1024)

    out = []
    for _ in range(n):
        w = words() & words() & words()
        out.append(RoaringBitmap(key_ids.copy(),
                                 [containers.from_words(r) for r in w]))
    return out


def b7_and_b4_alone(torch, kernels, ds, label: str) -> tuple:
    """B7 off a counts set's value stream and plan, and B4 off its counts
    (xor), bit-equal, then each alone (one graph replay of its wrapper),
    logged beside its bound.  Returns (B7 ms, B4 ms)."""
    k, plan = ds.keys.size, ds._stream_plan

    def run7():
        return kernels.stream_segmented_reduce("xor", *ds._streams,
                                               ds.seg_ids, plan, k)

    def run4():
        return kernels.counts_segmented_reduce("xor", ds.counts,
                                               ds._grp_seg_counts, k)

    require(max_abs_err(torch, run4(), run7()) == 0,
            f"B4 != B7 over {label}")
    b7 = kernels.b7_launch_bytes(plan.values, plan.dense_rows, k)
    b4 = kernels.b4_launch_bytes(ds.counts.shape[0], k)
    alone7, alone4 = graph_ms(torch, run7, 20), graph_ms(torch, run4, 20)
    log(f"  {label} ({ds.reduce_path} path recorded; K {k}, "
        f"{plan.values} values, {plan.dense_rows} dense rows, "
        f"{plan.pieces.shape[0]} pieces, {ds.counts.shape[0]} groups), "
        f"each alone (one graph replay): B7 {alone7:.4f} ms, "
        f"{b7 / PEAK_BYTES_PER_S * 1e3 / alone7:.1%} of its bound ({b7} "
        f"bytes); B4 {alone4:.4f} ms, "
        f"{b4 / PEAK_BYTES_PER_S * 1e3 / alone4:.1%} of its bound ({b4} "
        f"bytes); B4 / B7 {alone4 / alone7:.2f}")
    return alone7, alone4


def b7_runs_alone(torch, kernels, name: str, words, streams, runs, seg_ids,
                  blk_seg, plan, k: int, block: int) -> dict:
    """B7's run variant over a dense cell's streams (or and xor), bit-equal
    to the plain reduce over the image ``words`` (``segmented_reduce_plain``,
    B1's plain version) and to B2 over it, then each alone (one graph
    replay), logged beside its bound from the bytes the op needs (2 bytes a
    value, its u16; the int32 values the kernel reads in parentheses) and
    beside B2 alone.  Returns the kernels line's row: the slower of or and
    xor."""
    b2 = {op: (lambda op=op: kernels.segmented_reduce_blocked(
        op, words, blk_seg, k, block)) for op in ("or", "xor")}
    b7 = {op: (lambda op=op: kernels.stream_segmented_reduce(
        op, *streams, seg_ids, plan, k, runs=runs)) for op in ("or", "xor")}
    plain = {op: (lambda op=op: kernels.segmented_reduce_plain(
        op, words, seg_ids, k)) for op in ("or", "xor")}
    for op in ("or", "xor"):
        want = plain[op]()
        require(max_abs_err(torch, b7[op](), want) == 0,
                f"B7's run variant != the plain reduce over {name} ({op})")
        require(max_abs_err(torch, b2[op](), want) == 0,
                f"B2 != the plain reduce over {name} ({op})")
        del want
    torch.cuda.empty_cache()
    read = kernels.b7_launch_bytes(plan.values, plan.dense_rows, k,
                                   plan.runs)
    # the values as their u16, 2 bytes each: the int32 copy is the port's
    nbytes = read - 2 * plan.values
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    ms = {op: graph_ms(torch, b7[op], 20) for op in ("or", "xor")}
    ms2 = graph_ms(torch, b2["xor"], 10)
    plain_ms = max(timed_ms(torch, plain[op], 3) for op in ("or", "xor"))
    slow = max(ms.values())
    log(f"  B7 runs [{name}, K {k}, {plan.values} values, {plan.runs} runs, "
        f"{plan.dense_rows} dense rows, {plan.pieces.shape[0]} pieces]: "
        f"alone or {ms['or']:.4f} ms, xor {ms['xor']:.4f} ms (one graph "
        f"replay each), bound {bound:.4f} ms ({nbytes} bytes needed), "
        f"{bound / ms['or']:.1%} / {bound / ms['xor']:.1%} of it (of the "
        f"{read} bytes the kernel reads and writes, "
        f"{read / PEAK_BYTES_PER_S * 1e3 / ms['or']:.1%} / "
        f"{read / PEAK_BYTES_PER_S * 1e3 / ms['xor']:.1%}); B2 xor over the "
        f"image {ms2:.4f} ms, {ms2 / ms['xor']:.2f}x B7's; plain (the slower "
        f"op) {plain_ms:.4f} ms")
    return {"name": f"stream_segmented_reduce@{name}", "route": "cuda",
            "source": "roaringbitmap_tpu_torch/ops/csrc/stream_reduce.cu",
            "replaces": kernels.B7.replaces, "ms": slow, "bound_ms": bound,
            "bytes": nbytes, "share": bound / slow, "plain_ms": plain_ms}


def phase19(torch, kernels, packing, seed: int) -> list:
    """B8 at the benchmark's two dense configurations at full size: the
    dense layout's pack of each set, its streams on the card, B8 held
    bit-equal to the plain version, then B8 alone (one graph replay) and
    the plain version each timed beside the bound.  Returns the rows of the
    kernels line."""
    from pathlib import Path

    from cardbench import gen

    from roaringbitmap_tpu_torch.ops import dense
    from roaringbitmap_tpu_torch.ops.words import as_i32

    rows = []
    for name in ("census1881_srt_like", "census1881_like"):
        cfg = json.loads((Path(__file__).resolve().parent / "cardbench"
                          / "configs" / f"{name}.json").read_text())
        t0 = time.perf_counter()
        sources = gen.dataset_bytes(cfg, seed)
        p = packing.pack_blocked_compact(sources, min_block=4, runs=True)
        s, n = p.streams, p.n_rows
        log(f"  {name}: generated and packed in "
            f"{time.perf_counter() - t0:.1f} s: {n} rows, block {p.block}, "
            f"{s.total_values} values, {s.total_runs} runs, "
            f"{s.dense_words.shape[0]} dense-wire rows, kinds {s.kinds}")
        streams = tuple(as_i32(a, "cuda") for a in (
            s.dense_words, s.dense_dest, s.values.astype(np.int32),
            s.val_counts, s.val_dest))
        runs = tuple(as_i32(a, "cuda") for a in (
            s.runs.view(np.uint32), s.run_counts, s.run_dest))
        plan = kernels.row_build_plan(streams[3], streams[4], streams[1], n,
                                      runs[1], runs[2])
        k = p.keys.size
        row_seg = np.repeat(p.blk_seg.astype(np.int32), p.block)
        plan7 = kernels.stream_reduce_plan(
            s.val_counts, s.val_dest, s.dense_dest, row_seg, k,
            run_counts=s.run_counts, run_dest=s.run_dest).to("cuda")
        seg_ids, blk_seg = as_i32(row_seg, "cuda"), as_i32(p.blk_seg, "cuda")
        del sources, s

        def run():
            return kernels.row_build(*streams, n, plan.values, runs=runs,
                                     plan=plan)

        def plain():
            return dense.densify_streams_impl(*streams, n, plan.values,
                                              runs=runs)

        got = run()
        want = plain()
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"B8 != plain over {name}")
        del got, want
        torch.cuda.empty_cache()
        alone = graph_ms(torch, run, 10)
        plain_ms = timed_ms(torch, plain, 3)
        torch.cuda.empty_cache()
        nbytes = kernels.b8_launch_bytes(n, plan.values, plan.runs,
                                         plan.dense_rows)
        read = nbytes + 2 * plan.values + 20 * n + 16
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        log(f"  B8 [{name}, {n} rows]: alone {alone:.4f} ms (one graph "
            f"replay), bound {bound:.4f} ms ({nbytes} bytes needed), "
            f"{bound / alone:.1%} of its bound; the {read} bytes the kernel "
            f"reads and writes, {read / PEAK_BYTES_PER_S * 1e3 / alone:.1%}; "
            f"plain {plain_ms:.4f} ms")
        rows.append({"name": f"row_build@{name}", "route": "cuda",
                     "source": "roaringbitmap_tpu_torch/ops/csrc/row_build.cu",
                     "replaces": kernels.B8.replaces, "ms": alone,
                     "bound_ms": bound, "bytes": nbytes,
                     "share": bound / alone, "plain_ms": plain_ms})
        rows.append(b7_runs_alone(torch, kernels, name, run(), streams, runs,
                                  seg_ids, blk_seg, plan7, k, p.block))
        del streams, runs, plan
        torch.cuda.empty_cache()
    return rows


def ptxas_entries(report: str) -> list:
    """(entry function, "stack/spill; registers/smem") pairs of one
    ``nvcc -Xptxas -v`` report."""
    out, entry, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            out.append((entry, f"{line.split(':', 1)[-1].strip()}; {spill}"))
            entry = None
    return out


def timed_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of one replay of ``fn`` captured in a CUDA
    graph: its device work without the host's part of the call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return timed_ms(torch, graph.replay, reps)


def max_abs_err(torch, a, b) -> int:
    """Largest |difference| of two word/card results, as u32 values."""
    err = 0
    for x, y in zip(a, b):
        x64 = x.to(torch.int64) & 0xFFFFFFFF
        y64 = y.to(torch.int64) & 0xFFFFFFFF
        err = max(err, int((x64 - y64).abs().max()) if x.numel() else 0)
    return err


def traced(torch, fn) -> str:
    """One warm call of ``fn`` under ``torch.profiler``: its host time to a
    synchronize, the device time of the kernels and copies it ran, and the
    three longest of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev = []
    for e in prof.key_averages():
        # device rows only: a CPU op's row repeats the time of the kernels
        # it launched, which have rows of their own
        if getattr(e, "device_type", DeviceType.CPU) == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev.append((us / 1e3, e.count, e.key))
    if not dev:
        return (f"host {host_ms:.3f} ms; device time not measured (the "
                f"profiler saw no device activity)")
    busy = sum(ms for ms, _, _ in dev)
    top = "; ".join(f"{key[:48]} x{n} {ms:.3f} ms"
                    for ms, n, key in sorted(dev, reverse=True)[:3])
    return (f"host {host_ms:.3f} ms, device busy {busy:.3f} ms in "
            f"{sum(n for _, n, _ in dev)} kernels and copies (idle "
            f"{1 - busy / host_ms:.1%}): {top}")


def median_ms(torch, fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` (which returns host results, so it
    synchronizes) over ``reps`` warm runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def fires_first(faults, spec_of, key: str, rate: float, later: int) -> str:
    """A fault spec whose first draw at ``key`` fires and whose next
    ``later`` draws do not."""
    for seed in range(1000):
        plan = faults.FaultPlan.from_spec(spec_of(seed))
        draws = [plan._draw(0, key) for _ in range(later + 1)]
        if draws[0] < rate and all(d >= rate for d in draws[1:]):
            return spec_of(seed)
    raise AssertionError("no seed fires only first")


def phase11(smoke, bms, sbms, price, lift, seed: int, shapes: dict):
    """The pooled multi-tenant engine (``MultiSetBatchEngine``): 11a flat
    pools over 16 tenants of phase 2's bitmaps (12 dense, 4 compact),
    11b one pooled expression and value pool in one B5 launch, 11c the
    pipeline, the budget split and the guard, 11d 64-bit tenants.  Puts
    the inputs of the Q 64 pool's largest B1 call, and 11a's pooled B1
    launches, into ``shapes`` for phase 6."""
    import torch

    from roaringbitmap_tpu_torch import DeviceBitmapSet
    from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap
    from roaringbitmap_tpu_torch.ops import kernels, megakernel
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery
    from roaringbitmap_tpu_torch.parallel.multiset import (
        BatchGroup, MultiSetBatchEngine, random_multiset_pool)
    from roaringbitmap_tpu_torch.runtime import errors, faults, guard

    b1, b3, b5 = (kernels.B1.name, kernels.B3.name, kernels.B5.name)
    n_t, per = 16, min(256, len(bms) // 16)

    def as_form(pool, form):
        return [BatchGroup(g.set_id, [BatchQuery(q.op, q.operands, form=form)
                                      for q in g.queries]) for g in pool]

    def same_pool(got, want) -> bool:
        return len(got) == len(want) and all(
            same_results(g, w) for g, w in zip(got, want))

    # 11a: flat pools over 16 tenants
    tenants = [bms[t * per:(t + 1) * per] for t in range(n_t)]
    sets = smoke.main_path("11a tenant builds", lambda: [
        DeviceBitmapSet(b, layout="dense" if t < 12 else "compact")
        for t, b in enumerate(tenants)])
    ms = MultiSetBatchEngine(sets)
    for t in (0, 12):
        ds = sets[t]
        log(f"  11a: tenant {t} ({ds.layout}): {per} bitmaps, rows "
            f"{ds._n_rows}, K {ds.keys.size}, {ds.hbm_bytes()} bytes "
            f"resident")
    log(f"  11a: tenants 0-11 dense ({sum(s.hbm_bytes() for s in sets[:12])}"
        f" bytes), 12-15 compact ({sum(s.hbm_bytes() for s in sets[12:])} "
        f"bytes), rows {[s._n_rows for s in sets]}")
    pools = {q: random_multiset_pool([per] * n_t, q, seed=0xACE,
                                     max_operands=8) for q in (64, 256)}
    bm64 = as_form(pools[64], "bitmap")

    def per_set(pool, engine="cuda"):
        return [ms._engines[g.set_id].execute(list(g.queries), engine=engine)
                for g in pool]

    got = smoke.main_path("11a pooled bitmap Q64", lambda: ms.execute(bm64))
    plan = ms._plan_pool(ms._flatten(bm64)[0])
    require(smoke.last[b1] == len(plan.op_groups) and smoke.last[b3] == 4,
            f"11a pooled: B1 {smoke.last[b1]}, B3 {smoke.last[b3]}; want "
            f"{len(plan.op_groups)} and 4")
    pooled_b1 = smoke.last[b1]
    loop = smoke.main_path("11a per-set loop bitmap Q64",
                           lambda: per_set(bm64))
    require(same_pool(got, loop), "11a: pooled cuda != the per-set loop")
    require(same_pool(got, ms.execute(bm64, engine="torch")),
            "11a: pooled cuda != pooled torch")
    t0 = time.perf_counter()
    for g, rows in zip(bm64, got):
        for q, r in zip(g.queries, rows):
            require(r.bitmap == host_query(q, tenants[g.set_id]),
                    f"11a: tenant {g.set_id} {q.op} != the host fold")
    log(f"    bitmap Q64: pooled cuda equals the per-set loop, pooled torch "
        f"and the host fold of every query (host {time.perf_counter() - t0:.1f}"
        f" s); {len(plan.buckets)} buckets in {len(plan.op_groups)} op "
        f"groups, pooled image {plan.n_pool_rows} rows")
    want_card = {}
    for q, pool in pools.items():
        pooled = smoke.main_path(f"11a pooled Q{q}", lambda: ms.execute(pool))
        pl = dict(smoke.last)
        pooled_b1 += pl[b1]
        loop = smoke.main_path(f"11a per-set loop Q{q}",
                               lambda: per_set(pool))
        ll = dict(smoke.last)
        require(same_pool(pooled, loop), f"11a Q{q}: pooled != per-set loop")
        want_card[q] = pooled
        t_pool = median_ms(torch, lambda: ms.execute(pool))
        t_loop = median_ms(torch, lambda: per_set(pool))
        log(f"    Q{q} cardinality: pooled {t_pool:.3f} ms ({q / t_pool * 1e3:.0f}"
            f" Q/s; B1 {pl[b1]}, B3 {pl[b3]} launches) against the per-set "
            f"loop {t_loop:.3f} ms ({q / t_loop * 1e3:.0f} Q/s; B1 {ll[b1]}, "
            f"B3 {ll[b3]}); medians of 5, warm")
        log(f"    Q{q} traced: pooled "
            f"{traced(torch, lambda: ms.execute(pool))}; per-set loop "
            f"{traced(torch, lambda: per_set(pool))}")

    # the Q 64 pool's op groups, run eagerly with B1's inputs kept: the
    # largest is phase 6's pooled row
    plan64 = ms._plan_pool(ms._flatten(pools[64])[0])
    calls, real_b1 = [], kernels.segmented_reduce

    def keep(op, w, s, k, *args, **kw):
        calls.append((op, w.clone(), s.clone(), k))
        return real_b1(op, w, s, k, *args, **kw)

    kernels.segmented_reduce = keep
    try:
        ms._run(plan64, "cuda", ms._operands(plan64, "cuda", False))
    finally:
        kernels.segmented_reduce = real_b1
    shapes["segmented_reduce_pooled"] = max(calls,
                                            key=lambda c: c[1].shape[0])
    shapes["segmented_reduce_pooled_launches"] = pooled_b1
    del calls

    # 11b: pooled expressions and value queries, one B5 launch
    sets_e = smoke.main_path("11b shard tenant builds", lambda: [
        DeviceBitmapSet(sbms[t * per:(t + 1) * per], layout="dense")
        for t in range(n_t)])
    for t in range(4):
        sets_e[t].attach_column(price)
    ems = MultiSetBatchEngine(sets_e)

    def value_queries(t):
        lo, hi = PRICE_MAX // 4, PRICE_MAX // 2
        return [expr.ExprQuery(expr.and_(expr.or_(2 * t, 2 * t + 1),
                                         expr.range_("price", lo, hi)),
                               form="bitmap"),
                expr.ExprQuery(expr.sum_("price", found=expr.or_(0, 1)))]

    def expr_pool(q_t):
        return [BatchGroup(t, expr.random_expr_pool(per, q_t, depth=2,
                                                    seed=300 + t)
                           + (value_queries(t) if t < 4 else []))
                for t in range(n_t)]

    epool = None
    for q_t in (4, 2, 1):
        cand = expr_pool(q_t)
        t0 = time.perf_counter()
        eplan = ems._plan_pool(ems._flatten(cand)[0])
        plan_ms = (time.perf_counter() - t0) * 1e3
        mega = eplan.mega
        log(f"  11b: {q_t} expression queries a tenant + 2 value queries "
            f"on tenants 0-3: plan {plan_ms:.1f} ms (host, cold), steps "
            f"{mega.n_steps}, slots {mega.n_slots}, bank-2 rows "
            f"{mega.col_rows}: {'fits' if mega.fits() else 'does not fit'}")
        if mega.fits():
            epool = cand
            break
    require(epool is not None, "11b: no pooled expression plan fits B5")
    got = smoke.main_path("11b pooled expr", lambda: ems.execute(epool))
    require(smoke.last[b5] == 1 and smoke.last[b1] == 0,
            f"11b: B5 {smoke.last[b5]}, B1 {smoke.last[b1]}; want one B5")
    require(same_pool(got, ems.execute(epool, engine="cuda")),
            "11b: megakernel != pooled cuda")
    require(same_pool(got, [ems._engines[g.set_id].execute(list(g.queries))
                            for g in epool]),
            "11b: pooled != the per-set loop")
    cols = {"price": price}
    t0 = time.perf_counter()
    for g, rows in zip(epool, got):
        srcs = sbms[g.set_id * per:(g.set_id + 1) * per]
        for q, r in zip(g.queries, rows):
            if expr.is_agg(q.expr):
                card, value, _ = expr.evaluate_host_agg(q.expr, srcs, cols)
                ok = (r.cardinality, r.value) == (card, value)
            else:
                want = expr.evaluate_host(q.expr, srcs, cols)
                ok = (r.cardinality == want.cardinality
                      and (q.form != "bitmap" or r.bitmap == want))
            require(ok, f"11b: tenant {g.set_id} != the host oracle")
    pooled_e = ems._flatten(epool)[0]
    dev_ms = median_ms(torch, lambda: ems._program(eplan, "megakernel"))
    outs = ems._program(eplan, "megakernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ems._readback(eplan, outs, pooled_e, "megakernel", False)
    unpack_ms = (time.perf_counter() - t0) * 1e3
    log(f"    {len(pooled_e)} queries over {n_t} tenants in one B5 launch, "
        f"equal to pooled cuda, the per-set loop and the host oracles; "
        f"plan {plan_ms:.1f} ms (host, cold), device {dev_ms:.3f} ms "
        f"(pooled image, B5 and the copies to the host, to a synchronize; "
        f"median of 5, warm), unpack {unpack_ms:.3f} ms")
    # B5 alone on this stream against its bound, the bytes and word ops
    # as obs.cost counts the dispatch (the plan's predicted bytes and word
    # operations) and as the kernels line counts a stream
    ops_e = ems._operands(eplan, "megakernel", False)
    pw = ems._pooled_words(eplan, "megakernel", ops_e["r"])
    me = ops_e["m"]
    k_ms = timed_ms(torch, lambda: megakernel.raw_call(
        eplan.mega, pw, me["extra"], me["cols"], stream=me["stream"],
        steps_dev=me.get("steps")), 20)
    c_bytes = ems._predict(eplan, "megakernel")["peak_bytes"]
    c_ops = ems._word_ops(eplan, "megakernel")
    s_bytes = megakernel.stream_bytes(eplan.mega)
    s_ops = eplan.mega.n_steps * 2048
    for label, nb, no in (("obs.cost's counts", c_bytes, c_ops),
                          ("the stream's counts", s_bytes, s_ops)):
        bound = max(nb / PEAK_BYTES_PER_S, no / PEAK_OPS_PER_S) * 1e3
        log(f"    11b B5 alone: {k_ms:.4f} ms for {eplan.mega.n_steps} "
            f"steps; bound by {label} {bound:.4f} ms ({nb} bytes, {no} "
            f"word ops; {'bytes' if nb / PEAK_BYTES_PER_S >= no / PEAK_OPS_PER_S else 'operations'}"
            f"), {bound / k_ms:.1%} of it")
    del pw

    # 11c: the pipeline, the budget and the guard
    pools8 = [random_multiset_pool([per] * n_t, 64, seed=s, max_operands=8)
              for s in range(200, 208)]
    want8 = [ms.execute(p) for p in pools8]
    for d in (1, 2, 4):
        pol = guard.GuardPolicy(pipeline_depth=d)
        ms.execute_pipelined(pools8, policy=pol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got8 = ms.execute_pipelined(pools8, policy=pol)
        wall = (time.perf_counter() - t0) * 1e3
        require(all(same_pool(g, w) for g, w in zip(got8, want8)),
                f"11c depth {d}: != execute")
        st = ms.last_pipeline
        require(st["launches"] == len(pools8) and st["depth"] == d,
                f"11c depth {d}: {st}")
        log(f"  11c depth {d}: 8 Q64 pools in {wall:.3f} ms (host clock, "
            f"warm), host_ms {st['host_ms']}, host_overlapped_ms "
            f"{st['host_overlapped_ms']}, overlap_ratio "
            f"{st['overlap_ratio']}, drain_ms {st['drain_ms']}; equal to "
            f"execute")
    pooled256 = ms._flatten(pools[256])[0]
    full = ms.predict_dispatch_bytes(pooled256)
    budget = full // 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms._launch_once(pooled256, "cuda")
    peak = torch.cuda.max_memory_allocated() - base
    require(peak <= full, f"11c: Q256 measured {peak} > predicted {full}")
    log(f"  11c: Q256 pool in one launch: predicted {full} bytes, measured "
        f"peak {peak} (predicted / measured {full / max(peak, 1):.3f})")
    n_split, n_launch = ms.proactive_split_count, ms.launch_count
    got = smoke.main_path("11c Q256 under a budget", lambda: ms.execute(
        pools[256], policy=guard.GuardPolicy(hbm_budget=budget)))
    launched = ms.launch_count - n_launch
    preds = [m["predicted_bytes"] for m in list(ms.dispatch_memory)[-launched:]]
    require(ms.proactive_split_count > n_split and launched > 1
            and all(p <= budget for p in preds),
            f"11c budget {budget}: splits "
            f"{ms.proactive_split_count - n_split}, predictions {preds}")
    require(same_pool(got, want_card[256]), "11c: budgeted pool != unsplit")
    log(f"    budget {budget} (a quarter of the prediction): "
        f"{ms.proactive_split_count - n_split} proactive splits, {launched} "
        f"launches, every prediction within the budget; equal results")
    for sub in ms._launch_iter(pooled256, "cuda", budget):
        pred = ms.predict_dispatch_bytes(sub, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms._launch_once(sub, "cuda")
        peak = torch.cuda.max_memory_allocated() - base
        require(peak <= pred <= budget,
                f"11c: launch of {len(sub)}: measured {peak}, predicted "
                f"{pred}, budget {budget}")
        log(f"    launch of {len(sub)} queries: predicted {pred}, measured "
            f"peak {peak} (predicted / measured {pred / max(peak, 1):.3f})")
    stats = guard.dispatch_stats("multiset")
    require(stats["demotions"] == 0 and stats["sequential"] == 0,
            f"11c: the guard demoted or landed at multiset: {stats}")
    log(f"  11c: no demotion and no host landing at multiset before the "
        f"injected faults ({stats})")
    guard.reset_dispatch_stats()
    spec = "transient@multiset.drain=0.5:0xD4"
    plan_f = faults.FaultPlan.from_spec(spec)
    fires = sum(plan_f._draw(0, "multiset.drain/pallas") < 0.5
                for _ in pools8)
    r0 = ms.drain_retries
    with faults.inject(spec):
        got8 = ms.execute_pipelined(pools8,
                                    policy=guard.GuardPolicy(pipeline_depth=2))
    require(fires > 0 and ms.drain_retries - r0 == fires
            and all(same_pool(g, w) for g, w in zip(got8, want8)),
            f"11c drain: retries {ms.drain_retries - r0}, fires {fires}")
    log(f"    {spec} at depth 2: {fires} launches re-run at drain, equal")
    two = [g for g in pools[64] if g.set_id in (0, 12)]
    clean = ms.execute(two)
    spec = fires_first(faults, lambda sd: f"oom@multiset=0.5:{sd}",
                       "multiset/pallas", 0.5, 2)
    s0, n_launch = ms.split_count, ms.launch_count
    with faults.inject(spec):
        got = smoke.main_path(f"11c two tenants under {spec}",
                              lambda: ms.execute(two))
    halves = list(ms.dispatch_memory)[-(ms.launch_count - n_launch):]
    require(same_pool(got, clean) and ms.split_count - s0 == 1
            and len(halves) == 2
            and all(m["engine"] == "cuda" for m in halves)
            and guard.dispatch_stats("multiset")["demotions"] == 0,
            f"11c oom: splits {ms.split_count - s0}, launches {halves}")
    log(f"    {spec}: the two-tenant pool was halved once, each half on "
        f"cuda; equal")
    guard.reset_dispatch_stats()

    def lowered():
        try:
            ms.execute(pools[64])
        except errors.EngineLoweringError as exc:
            return exc
        return None

    with faults.inject("lowering@cuda:1"):
        raised = smoke.main_path("11c pooled under lowering@cuda", lowered)
    require(raised is not None and smoke.last[b1] == 0
            and guard.dispatch_stats("multiset")["demotions"] == 0
            and guard.dispatch_stats("multiset")["sequential"] == 0,
            f"11c lowering@cuda: raised {raised!r}, launches {smoke.last}")
    log(f"    lowering@cuda: the pooled launch raised "
        f"{type(raised).__name__} on the card (no B1 launch, no demotion)")
    guard.reset_dispatch_stats()

    # 11d: 64-bit tenants
    l64 = lift(bms[:4 * per])
    sets64 = [DeviceBitmapSet(l64[t * per:(t + 1) * per], layout="dense")
              for t in range(4)]
    ms64 = MultiSetBatchEngine(sets64)
    pool64 = as_form(random_multiset_pool([per] * 4, 64, seed=0xACE),
                     "bitmap")
    got = smoke.main_path("11d pooled 64-bit Q64", lambda: ms64.execute(pool64))
    loop = [ms64._engines[g.set_id].execute(list(g.queries), engine="cuda")
            for g in pool64]
    require(same_pool(got, loop)
            and all(type(r.bitmap) is Roaring64Bitmap
                    for rows in got for r in rows),
            "11d: pooled 64-bit != the per-set loop")
    log(f"  11d: 4 dense tenants of Roaring64Bitmaps (K "
        f"{[s.keys.size for s in sets64]}): the bitmap Q64 pool on pooled "
        f"cuda equals the per-set loop, Roaring64Bitmap results")
    return sets, tenants, pools[64], want_card[64]


def refs_of(e, expr) -> set:
    """Resident source indices an expression reads."""
    if isinstance(e, expr.Ref):
        return {e.index}
    out = set()
    for c in getattr(e, "children", ()) or ():
        out |= refs_of(c, expr)
    found = getattr(e, "found", None)
    if found is not None:
        out |= refs_of(found, expr)
    return out


def reads_col(e, name: str) -> bool:
    """Whether an expression reads value column ``name``."""
    if getattr(e, "col", None) == name:
        return True
    found = getattr(e, "found", None)
    return ((found is not None and reads_col(found, name))
            or any(reads_col(c, name)
                   for c in getattr(e, "children", ()) or ()))


class HostRows:
    """The smoke's own host copy of a resident set's sources under deltas:
    the containers a delta touched, as sorted u16 values per (source, key),
    beside the untouched source bitmaps."""

    def __init__(self, bitmaps):
        self.base = bitmaps
        self.rows: dict = {}            # (src, key) -> u16 values

    def values(self, src: int, key: int) -> np.ndarray:
        got = self.rows.get((src, key))
        if got is not None:
            return got
        b = self.base[src]
        i = int(np.searchsorted(b.keys, key))
        if i < b.keys.size and int(b.keys[i]) == key:
            return b.containers[i].values().astype(np.uint16)
        return np.zeros(0, np.uint16)

    def apply(self, adds: dict, removes: dict) -> None:
        """One delta, adds first and removes winning."""
        for spec, add in ((adds, True), (removes, False)):
            for src, vals in spec.items():
                vals = np.asarray(vals, np.uint32)
                for key in np.unique(vals >> np.uint32(16)):
                    lo = (vals[(vals >> np.uint32(16)) == key]
                          & np.uint32(0xFFFF)).astype(np.uint16)
                    cur = self.values(src, int(key))
                    self.rows[(src, int(key))] = (
                        np.union1d(cur, lo) if add else np.setdiff1d(cur, lo))

    def words(self, src: int, key: int) -> np.ndarray:
        from roaringbitmap_tpu_torch.core.containers import values_to_words
        return values_to_words(self.values(src, key)).view(np.uint32)

    def bitmap(self, src: int):
        """The current source as a host bitmap."""
        from roaringbitmap_tpu_torch import RoaringBitmap
        b = self.base[src]
        touched = sorted(k for s, k in self.rows if s == src)
        if not touched:
            return b
        v = b.to_array()
        v = v[~np.isin(v >> np.uint32(16), np.array(touched, np.uint32))]
        parts = [v] + [(np.uint32(k) << np.uint32(16))
                       | self.rows[(src, k)].astype(np.uint32)
                       for k in touched]
        return RoaringBitmap.from_values(np.concatenate(parts))


def phase12(smoke, seed, ds, bms, eng, xds, sds, sbms, seng, epool, price,
            cols, batches, tenants11) -> dict:
    """Mutable tenants: 12a 64 in-place patches of phase 2's dense set,
    12b the escalations (structural, drift, layout, never, the maintenance
    worker), 12c the result cache on 7b's shard (replays, subtree injection
    into B5, exact invalidation, a column delta), 12d the cache shared by
    phase 11's 16 tenants.  Returns 12a's deltas with their eager patch
    and host planning ms (phase 17f replays them)."""
    import threading

    import torch

    from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap
    from roaringbitmap_tpu_torch.mutation import MaintenanceWorker, ResultCache
    from roaringbitmap_tpu_torch.mutation import delta as mut_delta
    from roaringbitmap_tpu_torch.ops import kernels
    from roaringbitmap_tpu_torch.ops.words import to_u32
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import (
        BatchEngine, BatchQuery, random_query_pool)
    from roaringbitmap_tpu_torch.parallel.multiset import (
        BatchGroup, MultiSetBatchEngine)

    b1, b2, b3, b5 = (kernels.B1.name, kernels.B2.name, kernels.B3.name,
                      kernels.B5.name)
    rng = np.random.default_rng(seed + 12)

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def same_pool(got, want) -> bool:
        return len(got) == len(want) and all(
            same_results(g, w) for g, w in zip(got, want))

    # 12a: in-place patches of phase 2's dense set
    keys_12a = np.sort(rng.choice(ds.keys.size, 16, replace=False))
    seg_rows = {}
    for k in keys_12a:
        off, size = int(ds._seg_offsets[k]), int(ds._seg_sizes[k])
        rows = np.arange(off, off + size)
        seg_rows[int(k)] = rows[ds.row_src[rows] >= 0]
    live = np.concatenate(list(seg_rows.values()))
    host = HostRows(bms)
    v0 = ds.version
    want_rows = np.full(ds._n_rows, v0, np.int64)
    want_srcs = ds.source_versions.copy()
    pre = [t.clone() for t in ds.aggregate_device("or")]
    patch_ms, plan_ms, patched = [], [], 0
    touched: list = []
    deltas12: list = []

    def check_12a(label):
        for op in ("or", "xor"):
            got = smoke.main_path(f"12a {label} {op}",
                                  lambda op=op: ds.aggregate_device(op))
            want = ds.aggregate_device(op, engine="torch")
            require(smoke.last[b2] == 1
                    and all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"12a {label} {op}: B2 != the torch engine")
        srcs = sorted(set(touched))[-64:] or list(range(16))
        pool = [BatchQuery(("or", "xor", "and", "andnot")[i % 4], tuple(
            int(x) for x in rng.choice(srcs, min(len(srcs), 2 + i % 7),
                                       replace=False)))
            for i in range(16)]
        got = smoke.main_path(f"12a {label} flat x16",
                              lambda: eng.execute(pool, engine="cuda"))
        require(smoke.last[b1] > 0
                and same_results(got, eng.execute(pool, engine="torch")),
                f"12a {label}: B1 batch != the torch rung")
        return pool, got

    for i in range(64):
        p = int(rng.integers(1, 65))
        rows = rng.choice(live, p, replace=False)
        n_add = 1 + rng.multinomial(99, np.full(p, 1 / p))
        n_rem = rng.multinomial(100, np.full(p, 1 / p))
        adds, removes = {}, {}
        for r, na, nr in zip(rows, n_add, n_rem):
            src = int(ds.row_src[r])
            key = int(ds.keys[ds.row_seg[r]])
            base = np.uint32(key) << np.uint32(16)
            a = base | rng.integers(0, 1 << 16, na).astype(np.uint32)
            cur = host.values(src, key)
            rem = base | rng.choice(cur, min(int(nr), cur.size),
                                    replace=False).astype(np.uint32)
            adds.setdefault(src, []).extend(a.tolist())
            removes.setdefault(src, []).extend(rem.tolist())
        # the host's share: the same delta planned alone (no state moves)
        t0 = time.perf_counter()
        mut_delta.plan_patch(ds, mut_delta._normalize_delta(ds.n, adds),
                             mut_delta._normalize_delta(ds.n, removes))
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        rep, ms = sync_ms(lambda: ds.apply_delta(adds=adds, removes=removes))
        require(rep["mode"] == "patch" and rep["rows_patched"] == p,
                f"12a delta {i}: {rep}")
        deltas12.append((adds, removes))
        host.apply(adds, removes)
        want_rows[rows] = ds.version
        want_srcs[list(adds)] = ds.version
        touched += list(adds)
        patch_ms.append(ms)
        patched += p
        if i % 8 == 7:
            check_12a(f"after delta {i + 1}")
    require(ds.version == v0 + 64
            and np.array_equal(ds.row_versions, want_rows)
            and np.array_equal(ds.source_versions, want_srcs),
            "12a: the version stamps are not exactly the touched rows and "
            "sources")
    # the host fold of the smoke's own rows at the touched keys; the other
    # keys are as phase 2 checked them
    t0 = time.perf_counter()
    dev = ds.words.device
    kidx = torch.from_numpy(keys_12a.astype(np.int64)).to(dev)
    rest = np.setdiff1d(np.arange(ds.keys.size), keys_12a)
    ridx = torch.from_numpy(rest.astype(np.int64)).to(dev)
    heads, cards = ds.aggregate_device("or")
    require(torch.equal(heads[ridx], pre[0][ridx]),
            "12a: an untouched key's or changed")
    for op, fn in (("or", np.bitwise_or), ("xor", np.bitwise_xor)):
        heads, cards = ds.aggregate_device(op)
        got_w, got_c = to_u32(heads[kidx]), cards[kidx].cpu().numpy()
        for j, k in enumerate(keys_12a):
            k = int(k)
            rows = np.stack([host.words(int(s), k)
                             for s in ds.row_src[seg_rows[k]]])
            w = fn.reduce(rows, axis=0)
            require(np.array_equal(got_w[j], w)
                    and int(got_c[j]) == int(np.unpackbits(
                        w.view(np.uint8)).sum()),
                    f"12a: {op} at key {k} != the host fold")
    pool, got = check_12a("final")
    for q, r in zip(pool, got):
        want = host_query(q, {s: host.bitmap(s) for s in set(q.operands)})
        require(r.cardinality == want.cardinality,
                f"12a: final {q.op} != the host fold")
    log(f"  12a: 64 deltas over {keys_12a.size} keys ({patched} rows, "
        f"{len(set(touched))} sources, ~100 adds and ~100 removes each) "
        f"patched in place: median {np.median(patch_ms):.3f} ms a patch "
        f"(host clock to a synchronize; min {min(patch_ms):.3f}, max "
        f"{max(patch_ms):.3f}), of which planning the rows and masks on "
        f"the host alone takes a median {np.median(plan_ms):.3f} ms; "
        f"version {ds.version}; B2 and B1 equal the "
        f"torch engine every 8th delta, the touched keys' or/xor and the "
        f"final batch equal the host fold ({time.perf_counter() - t0:.1f} s "
        f"host); row and source versions stamp exactly the touched ones")

    # 12b: escalations
    ds256 = DeviceBitmapSet(bms[:256], layout="dense")
    e256 = BatchEngine(ds256)
    h256 = list(bms[:256])
    pool256 = [BatchQuery(q.op, q.operands, form="bitmap")
               for q in random_query_pool(256, 16, seed=seed + 12)]

    def host_apply(hosts, adds, removes=None):
        out = list(hosts)
        for src, vals in adds.items():
            out[src] = out[src] | RoaringBitmap.from_values(
                np.asarray(vals, np.uint32))
        for src, vals in (removes or {}).items():
            out[src] = out[src] - RoaringBitmap.from_values(
                np.asarray(vals, np.uint32))
        return out

    def check_256(label):
        got = e256.execute(pool256)
        for q, r in zip(pool256, got):
            require(r.bitmap == host_query(q, h256),
                    f"12b {label}: {q.op} != the host fold")
        return got

    walls = {}
    adds = {1: [(0xBEE << 16) + 7]}
    rep, walls["structural"] = sync_ms(lambda: ds256.apply_delta(adds=adds))
    require(rep["mode"] == "repack" and rep["repack_reason"] == "structural"
            and ds256.structure_version == 1, f"12b structural: {rep}")
    h256 = host_apply(h256, adds)
    check_256("structural")
    adds = {2: [int(v) + 1 for v in h256[2].to_array()[:50]]}
    rep, walls["drift"] = sync_ms(lambda: ds256.apply_delta(
        adds=adds, drift_limit=10))
    require(rep["mode"] == "repack" and rep["repack_reason"] == "drift"
            and rep["drift"]["fired"], f"12b drift: {rep}")
    h256 = host_apply(h256, adds)
    words0, v_b = ds256.words.clone(), ds256.version
    try:
        ds256.apply_delta(adds={3: [(0xBEF << 16) + 1]}, repack="never")
        refused = False
    except ValueError:
        refused = True
    require(refused and ds256.version == v_b
            and torch.equal(ds256.words, words0),
            "12b never: did not raise, or mutated the set")
    del words0
    adds = {0: [5]}
    pre_or = xds.aggregate("or")
    rep = smoke.main_path("12b compact delta", lambda: xds.apply_delta(
        adds=adds))
    require(rep["mode"] == "repack" and rep["repack_reason"] == "layout"
            and smoke.last[b3] >= 1, f"12b compact: {rep}, {smoke.last}")
    got = smoke.main_path("12b repacked or", lambda: xds.aggregate("or"))
    require(got == pre_or | RoaringBitmap.from_values(
        np.array(adds[0], np.uint32)), "12b compact: or != the host fold")
    log(f"  12b: compact set of {xds.n} -> layout repack to {xds.layout} "
        f"(B3 rebuilt the image it was read from), or equals the pre-delta "
        f"or with the add")
    # the maintenance worker: the commit waits on the serving lock
    lock = threading.RLock()
    worker = MaintenanceWorker(lock=lock)
    adds = {4: [(0xBF0 << 16) + 3]}
    with lock:
        pre_res = e256.execute(pool256)
        v_b = ds256.version
        rep = ds256.apply_delta(adds=adds, worker=worker)
        require(rep["mode"] == "repack_queued" and ds256.version == v_b
                and worker.pending() == 1, f"12b worker: {rep}")
        require(same_results(e256.execute(pool256), pre_res),
                "12b worker: the pre-delta image changed before the commit")
    t0 = time.perf_counter()
    worker.drain()
    walls["worker commit"] = (time.perf_counter() - t0) * 1e3
    worker.stop()
    h256 = host_apply(h256, adds)
    require(worker.jobs_done == 1 and worker.jobs_failed == 0
            and ds256.version == v_b + 1, "12b worker: the commit failed")
    check_256("after the worker's commit")
    for op in ("or", "xor"):
        got = smoke.main_path(f"12b 256 {op}", lambda op=op: ds256.aggregate(
            op))
        require(got == host_fold(op, h256), f"12b {op} != the host fold")
    log(f"  12b: 256 bitmaps: structural, drift (limit 10) and worker "
        f"repacks; repack='never' raised with nothing mutated; the queued "
        f"repack served the pre-delta image bit-exact at version {v_b}, then "
        f"version {ds256.version} after drain; batches and or/xor equal the "
        f"host fold.  Repack wall ms (host clock to a synchronize): "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"; against the median patch {np.median(patch_ms):.3f} ms")
    del ds256, e256

    # 12c: the result cache on 7b's shard
    rc = ResultCache(256 << 20)
    ceng = BatchEngine(sds, result_cache=rc)
    shost = list(sbms)
    card_pool = [expr.ExprQuery(q.expr) for q in epool]
    got = smoke.main_path("12c replay 1 (misses)", lambda: ceng.execute(epool))
    require(smoke.last[b5] == 1 and same_results(got, seng.execute(epool)),
            "12c: the filling batch != the cacheless engine")
    for r in range(8):
        for pool in (epool, card_pool):
            res = ceng.execute(pool)
            require(same_results(res, got if pool is epool else [
                type(g)(g.cardinality, None, g.value) for g in got]),
                f"12c replay {r}: != the first")
    st = rc.stats()
    hit_ms = median_ms(torch, lambda: ceng.execute(epool))
    miss_ms = median_ms(torch, lambda: seng.execute(epool))
    log(f"  12c: {len(epool)} queries x 8 replays in bitmap and cardinality "
        f"form: hit rate {st['hits'] / (st['hits'] + st['misses']):.4f} "
        f"({st}); warm batch {hit_ms:.3f} ms all-hit against {miss_ms:.3f} "
        f"ms all-miss (the cacheless engine; medians of 5)")
    inner = epool[-2].expr          # 7b's fixed (0 | 1) & ~2, cached
    q_inj = [expr.ExprQuery(expr.xor(inner, expr.or_(7, 9)), form="bitmap")]
    entry = rc._data[ceng._cache_key_of(epool[-2])[0]]
    saved = entry.words.clone()
    n_cached = ceng.plan(q_inj).exprs[0].n_cached
    got_inj = smoke.main_path("12c injected plan", lambda: ceng.execute(
        q_inj))
    require(n_cached >= 1 and smoke.last[b5] == 1
            and got_inj[0].bitmap == expr.evaluate_host(q_inj[0].expr, shost)
            and same_results(got_inj, seng.execute(q_inj, engine="torch"))
            and torch.equal(entry.words, saved),
            f"12c injection: n_cached {n_cached}, launches {smoke.last}")
    log(f"    a query over the cached (0 | 1) & ~2: n_cached {n_cached}, one "
        f"B5 launch, equal to the torch rung and evaluate_host; the entry's "
        f"rows unchanged")
    # a delta to one source drops exactly the entries that read it
    src = 0
    keyed = {}
    for q in list(epool) + q_inj:
        keyed[ceng._cache_key_of(q)[0]] = refs_of(expr.canonicalize(q.expr),
                                                  expr)
    predicted = sum(src in refs for refs in keyed.values())
    st0 = rc.stats()
    v_src = sbms[src].to_array()
    adds = {src: [int(v_src[0]) ^ 1, int(v_src[-1]) ^ 2]}
    rep = sds.apply_delta(adds=adds)
    shost = host_apply(shost, adds)
    st1 = rc.stats()
    dropped = st1["invalidations"] - st0["invalidations"]
    require(rep["mode"] == "patch" and dropped == predicted
            and st1["entries"] == st0["entries"] - predicted,
            f"12c invalidation: dropped {dropped}, predicted {predicted}")
    got2 = ceng.execute(epool)
    require(same_results(got2, seng.execute(epool, engine="cuda")),
            "12c: after the delta != the cacheless engine")
    for q, r in zip(epool, got2):
        require(r.bitmap == expr.evaluate_host(q.expr, shost),
                "12c: after the delta != evaluate_host")
    log(f"    delta to source {src}: {dropped} entries dropped (a host "
        f"recount of the leaves predicts {predicted}), "
        f"{st1['entries']} kept; the replay equals evaluate_host")
    # a column delta drops the entries that read the column
    batch = batches[0][0]
    ceng.execute(batch)
    n_price = len({ceng._cache_key_of(q)[0] for q in batch
                   if reads_col(q.expr, "price")})
    st0 = rc.stats()
    rows_p = rng.choice(1 << 20, 128, replace=False)
    crep, c_ms = sync_ms(lambda: price.apply_delta(dict(zip(
        rows_p.tolist(), rng.integers(0, PRICE_MAX, 128).tolist()))))
    dropped = rc.stats()["invalidations"] - st0["invalidations"]
    require(dropped == n_price > 0, f"12c column: dropped {dropped} of "
            f"{n_price}")
    got = smoke.main_path("12c value batch after the column delta",
                          lambda: seng.execute(batch))
    require(smoke.last[b5] == 1, "12c value batch: not one B5 launch")
    check_value(expr, "12c value batch", seng, batch, shost, cols, got)
    log(f"    BsiColumn delta of 128 rows ({crep}) in {c_ms:.1f} ms (host "
        f"oracle and planes rebuilt); {dropped} entries reading price "
        f"dropped; 9a's first value batch equals the host oracles")

    # 12d: phase 11's 16 tenants sharing one cache
    sets, tenants, pool64, want64 = tenants11
    rcd = ResultCache(256 << 20)
    msc = MultiSetBatchEngine(sets, result_cache=rcd)
    got = smoke.main_path("12d pooled Q64 (misses)", lambda: msc.execute(
        pool64))
    require(same_pool(got, want64) and smoke.last[b1] > 0
            and smoke.last[b3] == 4, f"12d: first replay {smoke.last}")
    served0 = rcd.hits
    predicted = msc.count_cache_hits(pool64)
    got = smoke.main_path("12d pooled Q64 (hits)", lambda: msc.execute(
        pool64))
    require(same_pool(got, want64) and not any(smoke.last.values())
            and rcd.hits - served0 == predicted == len(
                [q for g in pool64 for q in g.queries]),
            f"12d: hits {rcd.hits - served0}, predicted {predicted}")
    thost = {t: list(tenants[t]) for t in (3, 5)}
    e3 = msc._engines[3]
    src3 = next(q.operands[0] for g in pool64 if g.set_id == 3
                for q in g.queries)
    keys3 = {e3._cache_key_of(q)[0]: set(q.operands)
             for g in pool64 if g.set_id == 3 for q in g.queries}
    st_full = rcd.stats()
    predicted = sum(src3 in ops for ops in keys3.values())
    others = {k for k, e in rcd._data.items()
              if all(lf[0] != sets[3].uid for lf in e.leaves)}
    st0 = rcd.stats()
    v3 = tenants[3][src3].to_array()
    adds = {src3: [int(v3[0]) ^ 1]}
    rep = sets[3].apply_delta(adds=adds)
    thost[3] = host_apply(thost[3], adds)
    dropped = rcd.stats()["invalidations"] - st0["invalidations"]
    require(rep["mode"] == "patch" and dropped == predicted
            and others <= set(rcd._data),
            f"12d tenant 3: dropped {dropped}, predicted {predicted}")
    rows5 = msc._rows[5]
    adds = {0: [(0xBF0 + k) << 16 for k in range(16)]}
    rep5 = sets[5].apply_delta(adds=adds)
    thost[5] = host_apply(thost[5], adds)
    require(rep5["mode"] == "repack", f"12d tenant 5: {rep5}")
    got = smoke.main_path("12d pooled Q64 after the deltas",
                          lambda: msc.execute(pool64))
    loop = [msc._engines[g.set_id].execute(list(g.queries), engine="cuda",
                                           fallback=False) for g in pool64]
    require(same_pool(got, loop) and msc._rows[5] == sets[5]._n_rows
            != rows5, "12d: the pool after the repack != the per-set loop")
    for g, rows in zip(pool64, got):
        if g.set_id in thost:
            for q, r in zip(g.queries, rows):
                require(r.cardinality == host_query(
                    q, thost[g.set_id]).cardinality,
                    f"12d: tenant {g.set_id} {q.op} != the host fold")
    log(f"  12d: 16 tenants, one cache: the Q64 pool filled it (pooled "
        f"B1 + B3), then was served whole ({st_full}); "
        f"count_cache_hits matched the hits served; a delta to tenant 3 "
        f"dropped {dropped} entries (host recount {predicted}), none of "
        f"another tenant's; tenant 5's structural repack ({rows5} -> "
        f"{sets[5]._n_rows} rows) retired its pooled plans, and the pool "
        f"equals the per-set loop and the host fold")
    log(f"  12: mutation counters: deltas by mode {delta_modes()}, rows "
        f"patched {ctr('rb_delta_rows_patched_total'):.0f}")
    return {"deltas": deltas12, "patch_ms": patch_ms, "plan_ms": plan_ms}


def pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def lattice_needs(buckets) -> tuple:
    """(queries of the largest op, real rows of the largest query, keys of
    the widest query) of an unsnapped plan's buckets: what a lattice point
    must cover for the plan to snap."""
    if not len(buckets):
        return 1, 1, 1
    per_op: dict = {}
    for b in buckets:
        per_op[b.op] = per_op.get(b.op, 0) + len(b.qids)
    rows = max(int(b.host["valid"].sum(1).max()) for b in buckets)
    keys = max(max((k.size for k in b.keys), default=1) for b in buckets)
    return max(per_op.values()), rows, keys


def phase13(smoke, seed, ds, bms, sds, sbms, xsds, q_fit, fixed,
            tenants11) -> None:
    """The compile vocabulary on the card: each engine warmed with
    ``warmup(profile=...)`` (its lattice sealed, every program of the
    vocabulary a captured CUDA graph), then post-seal traffic replayed
    through the graphs with no escape, bit-equal to the eager rungs with no
    lattice, on samples to the "torch" rung and the host; timings of one
    batch an engine, graph against eager; one out-of-vocabulary batch (one
    counted escape); a patch then a replay, and a repack retiring graphs.
    13a phase 2's dense set, 13b 7b's shard with 9's columns and its
    compact set, 13c 11a's 16 tenants."""
    import torch

    from roaringbitmap_tpu_torch import DeviceBitmapSet, obs
    from roaringbitmap_tpu_torch.ops import kernels
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import (
        BatchEngine, BatchQuery, BatchResult, random_query_pool,
        resolve_query_engine)
    from roaringbitmap_tpu_torch.parallel.multiset import (
        BatchGroup, MultiSetBatchEngine, random_multiset_pool)
    from roaringbitmap_tpu_torch.runtime import guard
    from roaringbitmap_tpu_torch.runtime import lattice as rt_lattice

    b1, b3, b5 = kernels.B1.name, kernels.B3.name, kernels.B5.name
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rt_lattice.deactivate()

    def same_pool(got, want) -> bool:
        return len(got) == len(want) and all(
            same_results(g, w) for g, w in zip(got, want))

    def off(fn):
        """``fn()`` with no lattice active (the eager path); the sealed
        lattice object, with its escape count, is put back after."""
        lat = rt_lattice.active()
        rt_lattice.deactivate()
        try:
            return fn()
        finally:
            if lat is not None:
                rt_lattice.activate(lat)

    def warm(label, engines, profile):
        """warmup(profile=...) of each engine (the last seals the lattice
        that all share); prints points, programs, graphs, wall and pools."""
        for e in engines:
            rep = e.warmup(profile=profile)
            budget = rep["hbm_budget_bytes"]
            require(rep["lattice"]["sealed"] and (
                budget is None or rep["pool_bytes"] <= budget),
                f"{label}: warmup not sealed within the budget: {rep}")
            log(f"    {label} warmup: {rep['lattice']['points']} points, "
                f"{rep['lattice']['compiled']} compiled, {rep['graphs']} "
                f"graphs captured, {rep['wall_ms'] / 1e3:.2f} s, pool "
                f"{rep['pool_bytes']} bytes (predicted peak "
                f"{rep['predicted_pool_bytes']}), budget {budget} bytes "
                f"[{card}]")
        require(rt_lattice.sealed_active(), f"{label}: lattice not sealed")

    def replay_check(label, progs, run, want, kernels_want,
                     same=same_pool):
        """Post-seal traffic as one main-path call: no escape, no capture,
        no eager run; results equal ``want``; each kernel in
        ``kernels_want`` launched, by replays alone."""
        before = [(p.captures, p.replays, p.eager) for p in progs]
        e0 = rt_lattice.escape_total()
        got = smoke.main_path(label, run)
        after = [(p.captures, p.replays, p.eager) for p in progs]
        replays = sum(a[1] - b[1] for a, b in zip(after, before))
        require(rt_lattice.escape_total() == e0 == 0,
                f"{label}: {rt_lattice.escape_total()} escapes "
                f"{by_label('rb_lattice_escapes_total', 'site')}")
        require(all(a[0] == b[0] and a[2] == b[2]
                    for a, b in zip(after, before)) and replays > 0,
                f"{label}: not every batch replayed a warmed graph")
        if not same(got, want):
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if not same([g], [w])]
            raise AssertionError(f"{label}: != the eager rung (batches "
                                 f"{bad})")
        for k in kernels_want:
            require(smoke.last[k] > 0, f"{label}: {k} not launched by the "
                    f"replays")
        log(f"    {label}: {replays} graph replays, no escape, equal to the "
            f"eager rung; launches "
            f"{ {k: c for k, c in smoke.last.items() if c} }")
        return got

    def timing(label, execute, dispatch, plan):
        """One batch, graph against eager: ``execute()`` (to host results)
        and ``dispatch()`` (plan + copy-in + the replay call; eager: plan +
        launches) timed as wall, host dispatch and device time (CUDA events
        around ``dispatch``), medians of 5 warm; the traced kernel counts
        and ``plan``'s padding fraction."""
        def host_dev():
            host, dev_ = [], []
            dispatch()
            for _ in range(5):
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                t0 = time.perf_counter()
                dispatch()
                host.append((time.perf_counter() - t0) * 1e3)
                b.record()
                b.synchronize()
                dev_.append(a.elapsed_time(b))
            return float(np.median(host)), float(np.median(dev_))

        g_wall = median_ms(torch, execute)
        g_host, g_dev = host_dev()
        g_tr = traced(torch, execute)
        e_wall = off(lambda: median_ms(torch, execute))
        e_host, e_dev = off(host_dev)
        e_tr = off(lambda: traced(torch, execute))
        log(f"    {label} timing [{card}], medians of 5 warm: graph wall "
            f"{g_wall:.3f} ms, host dispatch {g_host:.3f} ms, device "
            f"{g_dev:.3f} ms; eager wall {e_wall:.3f} ms, host dispatch "
            f"{e_host:.3f} ms, device {e_dev:.3f} ms; padding "
            f"{plan.padding[1]:.4f} of the gathered rows ({plan.padding[0]} "
            f"bytes)")
        log(f"      graph (one replay a batch): traced {g_tr}")
        log(f"      eager: traced {e_tr}")

    def batch_timing(label, e, batch):
        plan = e.plan(batch)
        rung = e._bucket_engine(plan, resolve_query_engine(
            "auto", batch, e.device), note=False)
        timing(f"{label} ({len(batch)} queries on {rung})",
               lambda: e.execute(batch),
               lambda: e._program(e.plan(batch), rung), plan)

    def oov(label, eng, batch, site, want):
        """One batch past the vocabulary: exactly one escape at ``site``,
        not in the vocabulary, exact."""
        e0 = ctr("rb_lattice_escapes_total", site=site)
        dump = out_path(f"escape-{site}.jsonl")
        stop = trace_into(obs, dump)
        try:
            got = eng.execute(batch)
        finally:
            stop()
        if got and isinstance(got[0], list):     # a pool's groups
            got = [r for rows in got for r in rows]
        evs = [e for sp in read_spans(dump) for e in sp["events"]
               if e["name"] == "lattice.escape"]
        ev = evs[-1] if evs else None
        require(ctr("rb_lattice_escapes_total", site=site) == e0 + 1
                and len(evs) == 1 and ev["site"] == site
                and ev["in_vocabulary"] is False,
                f"{label}: escape not counted once at {site}: {evs}")
        require(same_results(got, want), f"{label}: != the host")
        log(f"    {label}: one escape at {site} ({ev}), exact")

    # ----------------------------------------------------------------- 13a
    n = ds.n
    eng = BatchEngine(ds, result_cache=None)
    small = DeviceBitmapSet(bms[:256], layout="dense")
    seng_ = BatchEngine(small, result_cache=None)
    traffic = [[BatchQuery(q.op, q.operands, form=form)
                for q in random_query_pool(n, 64, seed=s)]
               for s in range(1, 9) for form in ("cardinality", "bitmap")]
    need = np.max([lattice_needs(off(lambda b=b: eng.plan(b)))
                   for b in traffic], axis=0)
    prof_a = (f"q={pow2(need[0])},;rows={pow2(need[1])},;"
              f"keys={pow2(need[2])},;heads=both")
    log(f"  13a: phase 2's set ({n} bitmaps, K {ds.keys.size}); traffic "
        f"needs q {need[0]}, rows {need[1]}, keys {need[2]}; profile "
        f"{prof_a!r}")
    want = [off(lambda b=b: eng.execute(b, engine="cuda")) for b in traffic]
    warm("13a", [eng, seng_], prof_a)
    got = replay_check("13a flat x16 batches", [eng._programs],
                       lambda: [eng.execute(b) for b in traffic], want, [b1])
    sample = traffic[1][:8]
    require(same_results(got[1][:8], off(lambda: eng.execute(
        sample, engine="torch")))
            and all(r.bitmap == host_query(q, bms)
                    for q, r in zip(sample, got[1][:8])),
            "13a sample: != the torch rung or the host")
    log("    13a: the first 8 of a bitmap batch equal the torch rung and the "
        "host fold")
    batch_timing("13a", eng, traffic[0])
    big = [BatchQuery("or", (0, 1)) for _ in range(pow2(need[0]) + 1)]
    card01 = host_query(big[0], bms).cardinality
    oov("13a out of vocabulary", eng, big, "batch_engine",
        [BatchResult(card01)] * len(big))
    # 13 mutation: a patch then a replay; a repack retiring the graphs
    pool_s = [BatchQuery(q.op, q.operands, form="bitmap")
              for q in random_query_pool(256, 16, seed=seed + 13)]
    seng_.execute(pool_s)
    rng = np.random.default_rng(seed + 13)
    hosts = bms[:256]
    adds = {int(s): (hosts[s].to_array()[:40] ^ np.uint32(1)).tolist()
            for s in rng.choice(256, 8, replace=False)}
    removes = {int(s): hosts[s].to_array()[::7].tolist()
               for s in rng.choice(256, 8, replace=False)}
    rep = small.apply_delta(adds=adds, removes=removes)
    require(rep["mode"] == "patch", f"13 patch: {rep}")
    caps = seng_._programs.captures
    got = seng_.execute(pool_s)
    require(seng_._programs.captures == caps
            and same_results(got, off(lambda: seng_.execute(
                pool_s, engine="torch"))),
            "13 patch then replay != the torch rung")
    log(f"  13 patch: {rep['rows_patched']} rows patched in place, then the "
        f"warmed graph replayed (no capture), equal to the torch rung")
    g0, p0 = seng_._programs.graphs, seng_._programs.pool_bytes()
    small.apply_delta(adds={0: [7, 8, 9]}, repack="always")
    seng_._sync_with_ds()
    g1, p1 = seng_._programs.graphs, seng_._programs.pool_bytes()
    require(g0 > 0 and g1 == 0 and p1 < p0,
            f"13 repack: graphs {g0} -> {g1}, pool {p0} -> {p1}")
    got = seng_.execute(pool_s)
    require(same_results(got, off(lambda: seng_.execute(
        pool_s, engine="torch"))), "13 repack: != the torch rung")
    log(f"  13 repack: graphs {g0} -> {g1}, pool {p0} -> {p1} bytes "
        f"[{card}]; the next batch re-captured (an escape, counted) and "
        f"equals the torch rung")
    del eng, seng_, small, want, got
    rt_lattice.deactivate()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 13b
    e_b = BatchEngine(sds, result_cache=None)
    x_b = BatchEngine(xsds, result_cache=None)
    srcs = sbms
    price, ts = sds.columns["price"], sds.columns["ts"]
    cols = dict(sds.columns)

    def host_results(batch):
        out = []
        for q in batch:
            if expr.is_agg(q.expr):
                card, value, bm = expr.evaluate_host_agg(q.expr, srcs, cols)
            else:
                bm = expr.evaluate_host(q.expr, srcs, cols)
                card, value = bm.cardinality, None
            out.append(BatchResult(card, bm if q.form == "bitmap" else None,
                                   value))
        return out

    vb_old = fitting_batches(e_b, value_pool(expr, price, ts, srcs))
    sizes = [len(b) for b, _ in vb_old]
    vpool_new = value_pool(expr, price, ts, srcs, alt=1)
    vb_new, i = [], 0
    for k in sizes:
        vb_new.append(vpool_new[i:i + k])
        i += k
    vb_old = [b for b, _ in vb_old]

    def expr_pools(e, n_src):
        out = []
        for s in (seed + 131, seed + 132):
            for q in (q_fit, q_fit // 2, q_fit // 4):
                pool = expr.random_expr_pool(n_src, q, depth=2, seed=s,
                                             form="bitmap") + fixed
                if e.plan(pool).mega.fits():
                    out.append(pool)
                    break
        return out

    rt_lattice.activate("q=1024;rows=1024;keys=64;expr=4;bsi=64,;"
                        "heads=both")
    ep_s, ep_x = expr_pools(e_b, sds.n), expr_pools(x_b, xsds.n)
    rt_lattice.deactivate()
    needs = [lattice_needs(e.plan(b)) for e, bs in (
        (e_b, ep_s + vb_old + vb_new), (x_b, ep_x)) for b in bs]
    need = np.max(needs, axis=0)
    prof_b = (f"q={pow2(need[0])},;rows={pow2(need[1])},;"
              f"keys={pow2(need[2])},;heads=both;expr=4;bsi=64,")
    log(f"  13b: 7b's shard (K {sds.keys.size}, columns price/ts) and its "
        f"compact set of {xsds.n}; expression pools of "
        f"{[len(p) for p in ep_s]} / {[len(p) for p in ep_x]} queries, "
        f"{len(vb_new)} value batches at new predicate values; needs "
        f"q {need[0]}, rows {need[1]}, keys {need[2]}; profile {prof_b!r}")
    want_s = [off(lambda b=b: e_b.execute(b)) for b in ep_s + vb_new]
    want_x = [off(lambda b=b: x_b.execute(b)) for b in ep_x]
    # a novel DAG is a new program in both packages (an escape after the
    # seal): the expression pools are warmed as prepared batches, and the
    # value batches at phase 9's predicate values, before the seal
    rt_lattice.activate(prof_b)
    for b in ep_s + vb_old:
        e_b.warmup(queries=b)
    for b in ep_x:
        x_b.warmup(queries=b)
    warm("13b", [e_b, x_b], prof_b)
    got = replay_check("13b shard expr + value batches", [e_b._programs],
                       lambda: [e_b.execute(b) for b in ep_s + vb_new],
                       want_s, [b5])
    replay_check("13b compact expr", [x_b._programs],
                 lambda: [x_b.execute(b) for b in ep_x], want_x, [b3, b5])
    for b, g in ((ep_s[0][:8], got[0][:8]), (vb_new[0], got[len(ep_s)])):
        require(same_results(g, off(lambda b=b: e_b.execute(
            b, engine="torch"))) and same_results(g, host_results(b)),
            "13b sample: != the torch rung or the host oracles")
    log("    13b: the first 8 of an expression pool and the first value "
        "batch equal the torch rung and the host oracles")
    batch_timing("13b expr", e_b, ep_s[0])
    batch_timing("13b value", e_b, vb_new[0])
    over = [expr.ExprQuery(expr.or_(2 * i, 2 * i + 1))
            for i in range(pow2(need[0]) + 1)]
    oov("13b out of vocabulary", e_b, over, "batch_engine",
        host_results(over))
    del e_b, x_b
    rt_lattice.deactivate()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 13c
    sets, tbms = tenants11[0], tenants11[1]
    ms = MultiSetBatchEngine(sets, result_cache=None)

    def host_pool(pool):
        return [[BatchResult(host_query(q, tbms[g.set_id]).cardinality)
                 for q in g.queries] for g in pool]

    per = [s.n for s in sets]
    pools = [random_multiset_pool(per, 64, seed=s, max_operands=8)
             for s in range(200, 208)]
    plans = [ms._plan_pool(ms._flatten(p)[0]) for p in pools]
    need = np.max([lattice_needs(p.buckets) for p in plans], axis=0)
    pool_need = max(max(r.size for r in p.row_sel.values())
                    for p in plans) + 1
    prof_c = (f"q={pow2(need[0])},;rows={pow2(need[1])},;"
              f"keys={pow2(need[2])},;heads=cardinality;"
              f"pool={pow2(pool_need)},")
    log(f"  13c: 11a's {len(sets)} tenants; Q64 pools at seeds 200-207 need "
        f"q {need[0]}, rows {need[1]}, keys {need[2]}, pool {pool_need}; "
        f"profile {prof_c!r}")
    want = [off(lambda p=p: ms.execute(p)) for p in pools]
    warm("13c", [ms], prof_c)
    progs = [ms._programs] + [e._programs for e in ms._engines]
    def same_pools(got, want) -> bool:
        return len(got) == len(want) and all(
            same_pool(g, w) for g, w in zip(got, want))

    replay_check("13c execute x8", progs,
                 lambda: [ms.execute(p) for p in pools], want, [b1, b3],
                 same_pools)
    pol = guard.GuardPolicy(pipeline_depth=2)
    got = replay_check("13c execute_pipelined depth 2", progs,
                       lambda: ms.execute_pipelined(pools, policy=pol), want,
                       [b1, b3], same_pools)
    log(f"    13c pipeline: {ms.last_pipeline}")
    require(same_pool(got[0], off(lambda: ms.execute(pools[0],
                                                      engine="torch")))
            and same_pool(got[0], host_pool(pools[0])),
            "13c sample: != the torch rung or the host")
    log("    13c: the first pool equals the torch rung and the host fold")
    pooled0 = ms._flatten(pools[0])[0]
    timing("13c (one Q64 pooled launch on cuda)",
           lambda: ms.execute(pools[0]),
           lambda: ms._program(ms._plan_pool(pooled0), "cuda"),
           ms._plan_pool(pooled0))
    big = [BatchGroup(t, [BatchQuery("or", (0, 1))] * (pow2(need[0]) + 1))
           for t in (0, 1)]
    oov("13c out of vocabulary", ms, big, "multiset",
        [r for rows in host_pool(big) for r in rows])
    from roaringbitmap_tpu_torch.obs import metrics
    frac = {lab["site"]: inst.value
            for n, lab, inst in metrics.REGISTRY.instruments()
            if n == "rb_lattice_padding_fraction"}
    log(f"  13: escapes by site {by_label('rb_lattice_escapes_total', 'site')}"
        f"; padding bytes by site "
        f"{by_label('rb_lattice_padding_bytes', 'site')}, latest padded "
        f"fraction {frac}")
    del ms
    rt_lattice.deactivate()
    torch.cuda.empty_cache()


def has_value_leaf(e, expr) -> bool:
    """An expression reading a value column (a predicate or an aggregate)."""
    if isinstance(e, (expr.ValuePred, expr.Agg)):
        return True
    if isinstance(e, expr.Node):
        return any(has_value_leaf(c, expr) for c in e.children)
    return False


def phase14(smoke, seed: int, tenants11) -> tuple:
    """The serving stack on the card (``serving``, ``wire``,
    ``mutation.durability``) over phase 11's 16 tenants, each with a
    ``BsiColumn("v")`` made as ``replay.build_dataset`` makes one: 14a a
    query-only replay stream through ``ServingLoop``; 14c the resident ring
    lane on 14a's engine; 14e the wire front door over 14a's loop and a
    ``bootstrap --device cuda`` child; 14b the default mix with deltas;
    14d a durable tenant."""
    import shutil
    import tempfile

    import torch

    from roaringbitmap_tpu_torch import DeviceBitmapSet
    from roaringbitmap_tpu_torch.analytics import BsiColumn
    from roaringbitmap_tpu_torch.mutation import MaintenanceWorker
    from roaringbitmap_tpu_torch.mutation import durability
    from roaringbitmap_tpu_torch.ops import kernels
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery
    from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine
    from roaringbitmap_tpu_torch import obs
    from roaringbitmap_tpu_torch.runtime import errors, faults
    from roaringbitmap_tpu_torch.runtime import lattice as rt_lattice
    from roaringbitmap_tpu_torch.serving import (ServingLoop, ServingPolicy,
                                                 ServingRequest, replay)
    from roaringbitmap_tpu_torch.serving.loop import replay_stream
    from roaringbitmap_tpu_torch.serving.resident import signature_id
    from roaringbitmap_tpu_torch.wire import WireClient, WireServer
    from roaringbitmap_tpu_torch.wire import migrate as wmig

    b1, b3, b5 = kernels.B1.name, kernels.B3.name, kernels.B5.name
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    served = dict.fromkeys((b1, b3, b5), 0)

    def serve(label, fn):
        """A main-path call of the serving stack: its launches count
        toward the phase's B1 / B3 / B5 requirement."""
        out = smoke.main_path(label, fn)
        for k in served:
            served[k] += smoke.last[k]
        return out

    sets, tenants = list(tenants11[0]), tenants11[1]
    n_t, per = len(sets), min(len(t) for t in tenants)
    for t, ds in enumerate(sets):
        if ds.version:          # phase 12 patched or repacked it
            sets[t] = DeviceBitmapSet(tenants[t], layout="dense" if t < 12
                                      else "compact")
    knobs = dict(sets=n_t, sources=per, tenants=64, users=1 << 24,
                 requests=2048, duration_s=4.0, seed=seed)
    for ds, (ids, vals) in zip(sets, replay.dataset_columns(
            replay.ReplayProfile(**knobs))):
        ds.attach_column(BsiColumn("v", ids, vals))
    columns = [{"v": ds.columns["v"]} for ds in sets]
    n_compact = sum(s.layout == "compact" for s in sets)
    log(f"  14: {n_t} tenants of {per} ({n_compact} compact), a "
        f"BsiColumn('v') each; resident {obs.LEDGER.snapshot()}")

    def oracle(sid, q, hosts, cols):
        srcs, cols = hosts[sid], cols[sid]
        if isinstance(q, BatchQuery):
            want = host_query(q, srcs)
            return want.cardinality, None, want
        if expr.is_agg(q.expr):
            return expr.evaluate_host_agg(q.expr, srcs, cols)
        want = expr.evaluate_host(q.expr, srcs, cols)
        return want.cardinality, None, want

    def exact(res, req, q, hosts, cols=columns) -> bool:
        card_, value, want = oracle(req.set_id, q, hosts, cols)
        if (res.cardinality, res.value) != (card_, value):
            return False
        return q.form != "bitmap" or res.bitmap == want

    def report_line(label, rep, loop):
        t = list(loop.timings)
        lm = float(np.median([x["loop_ms"] for x in t])) if t else 0.0
        em = float(np.median([x["engine_ms"] for x in t])) if t else 0.0
        log(f"    {label} [{card}]: {rep['done']} done, {rep['shed']} shed, "
            f"{rep['rejected']} rejected, {rep['failed']} failed of "
            f"{rep['queries']} ({rep['deltas']} deltas); p50 "
            f"{rep['p50_ms']} ms, p99 {rep['p99_ms']} ms (fault clock), "
            f"{rep['qps']} Q/s, attainment {rep['attainment']}, "
            f"typed_only {rep['typed_only']}; {loop.stats['pools']} pools, "
            f"level peak {loop.level_peak}; a pool's host ms in the loop "
            f"(assembly to the engine call) {lm:.3f} beside the engine's "
            f"wall {em:.3f} (medians of {len(t)})")

    # ----------------------------------------------------------------- 14a
    events = replay.generate(replay.ReplayProfile(**knobs, delta_share=0.0))
    queries = [ev[2] for ev in events]
    ms = MultiSetBatchEngine(sets, result_cache=None)
    policy = ServingPolicy(pool_target=64)
    want: dict = {}         # id(request) -> the host oracle's answer

    def exact_t(t) -> bool:
        """A done ticket against the host oracle of its request (computed
        once a request: every run of the stream serves the same ones)."""
        got = want.get(id(t.request))
        if got is None:
            got = want[id(t.request)] = oracle(
                t.request.set_id, t.request.query, tenants, columns)
        card_, value, bm = got
        return ((t.result.cardinality, t.result.value) == (card_, value)
                and (t.query.form != "bitmap" or t.result.bitmap == bm))

    def run_14a(rate, stream):
        """``stream`` (events) at ``rate`` x the profile's arrival rate
        through a fresh loop: the report, the loop and its completed
        tickets; prints each admission's host ms."""
        loop = ServingLoop(ms, policy)
        done: list = []
        adm: list = []
        shed0 = by_label("rb_serving_shed_total", "reason")
        loop.add_completion_listener(done.extend)
        submit = loop.submit

        def timed_submit(req, arrival=None):
            a = time.perf_counter()
            t = submit(req, arrival=arrival)
            adm.append((time.perf_counter() - a) * 1e3)
            return t

        loop.submit = timed_submit
        rep = serve(f"14a run_inproc, {len(stream)} queries at {rate:g}x",
                    lambda: replay.run_inproc(loop, stream, rate_scale=rate))
        del loop.submit
        loop.remove_completion_listener(done.extend)
        t0 = time.perf_counter()
        ok = [t for t in done if t.status == "done"]
        bad = [t for t in ok if not exact_t(t)]
        require(not bad, f"14a at {rate:g}x: {len(bad)} tickets != the host "
                f"oracle, first {bad[:1]}")
        require(rep["typed_only"] and rep["queries"] == len(stream)
                and ctr("rb_serving_pump_errors_total") == 0,
                f"14a at {rate:g}x: {rep}")
        report_line(f"14a at {rate:g}x", rep, loop)
        log(f"      all {len(ok)} served equal the host oracle (host "
            f"{time.perf_counter() - t0:.1f} s); admission host ms median "
            f"{float(np.median(adm)):.3f}, p99 "
            f"{float(np.percentile(adm, 99)):.3f} ({len(adm)} admitted); "
            f"launches B1 {smoke.last[b1]}, B3 {smoke.last[b3]}, B5 "
            f"{smoke.last[b5]}; shed by reason "
            f"{ {r: v - shed0.get(r, 0) for r, v in by_label('rb_serving_shed_total', 'reason').items()} }")
        return rep, loop, done

    # the whole stream at the profile's rate, then a rate ladder on its
    # first eighth (rising to the diurnal curve's first peak) for the rate
    # the loop sustains; later arms run at that rate
    # (the ladder's 1/64 rung was cut to make room for phase 17: when no
    # rung sustains, the later arms still run at 1/64, 14e on a fresh loop)
    rates = (1.0, 0.25, 0.0625)
    prefix = events[:len(events) // 8]
    runs = {}
    for rate in rates:
        runs[rate] = run_14a(rate, events if rate == 1.0 else prefix)
    sus = replay.sustained(lambda r: runs[r][0], rates, slo_target=0.9)
    rate_s = sus["sustained_rate_x"] or 0.015625
    # the loop 14e's wire server fronts
    loop_a = (runs[rate_s][1] if rate_s in runs
              else ServingLoop(ms, policy))
    by_req = {id(t.request): t for rate in rates for t in runs[rate][2]
              if t.status == "done"}
    log(f"    14a [{card}]: the profile offers {len(events) / 4.0:.0f} "
        f"arrivals/s on average; sustained at attainment >= 0.9: "
        f"{sus['sustained_rate_x']}x, {sus['sustained_qps']} Q/s, p99 "
        f"{sus['sustained_p99_ms']} ms; ladder {sus['ladder']} (1x on the "
        f"whole stream, the others on its first {len(prefix)} requests)")
    probe = queries[:64]
    loop_t = ServingLoop(ms, ServingPolicy(pool_target=64,
                                           default_deadline_ms=600_000.0))

    def one_pump():
        for r in probe:
            loop_t.submit(r)
        return loop_t.pump(force=True)

    log(f"    14a one traced pump of 64 requests: {traced(torch, one_pump)}")

    # ----------------------------------------------------------------- 14c
    exprs = [r for r in queries if isinstance(r.query, expr.ExprQuery)
             and not has_value_leaf(r.query.expr, expr)]
    flats = [r for r in queries if isinstance(r.query, BatchQuery)]

    def pooled_of(reqs):
        return tuple((r.set_id, r.query) for r in reqs)

    pairs, plans = [], []
    # two tenants a pool: the pooled engine plans it (a one-set pool would
    # go through that set's own engine)
    flats = iter(flats)
    for a in exprs:
        b = next((f for f in flats if f.set_id != a.set_id), None)
        if b is None:
            break
        p = ms._plan_pool(pooled_of([a, b]))
        if p.mega is not None and p.mega.fits():
            pairs.append((a, b))
            plans.append(p)
            if len(pairs) == 32:
                break
    require(len(pairs) >= 8, f"14c: only {len(pairs)} fused pairs fit B5")
    need = np.max([lattice_needs(p.buckets) for p in plans], axis=0)
    pool_need = max(max(r.size for r in p.row_sel.values())
                    for p in plans) + 1
    depth = max(s.depth for p in plans for s in p.exprs
                if s.kind == "fused")
    prof_c = (f"q={pow2(need[0])},;rows={pow2(need[1])},;"
              f"keys={pow2(need[2])},;heads=both;expr={depth};"
              f"pool={pow2(pool_need)},")
    rt_lattice.activate(prof_c)
    lat = rt_lattice.active()
    keep = []
    for pr in pairs:
        p = ms._plan_pool(pooled_of(pr))
        if (p.point is not None and signature_id(lat, p.point) is not None
                and ms._pool_engine(p, "megakernel", note=False)
                == "megakernel"):
            keep.append(pr)
    pairs = keep
    require(len(pairs) >= 8, f"14c: {len(pairs)} pairs snap into {prof_c}")
    arrivals = [(i * 1e-3, r) for i, r in enumerate(
        [r for pr in pairs for r in pr])]
    log(f"  14c: {len(pairs)} pools of [expression, flat] from 14a's stream "
        f"(two tenants each, with a fused section that fits B5, of "
        f"{len(exprs)} expression requests); needs q {need[0]}, "
        f"rows {need[1]}, keys {need[2]}, depth {depth}, pool {pool_need}; "
        f"profile {prof_c!r}")
    mega_pol = dict(pool_target=2, engine="megakernel",
                    default_deadline_ms=600_000.0)
    # each pool's program captured before the seal (a novel DAG is a new
    # program), then the vocabulary warmed and sealed through the loop
    replay_stream(ServingLoop(ms, ServingPolicy(**mega_pol)), arrivals)
    loop_c = ServingLoop(ms, ServingPolicy(resident=True, **mega_pol))
    t0 = time.perf_counter()
    wrep = loop_c.warmup(profile=prof_c)
    require(wrep["lattice"]["sealed"] and loop_c._resident.active,
            f"14c: warmup not sealed: {wrep['lattice']}")
    log(f"    14c warmup [{card}]: {wrep['lattice']['points']} points, "
        f"{wrep['graphs']} graphs, pool {wrep['pool_bytes']} bytes, "
        f"{time.perf_counter() - t0:.2f} s")
    caps0 = ms._programs.captures
    d_ring = ctr("rb_serving_dispatches_total")
    got_c = serve("14c resident ring stream",
                  lambda: replay_stream(loop_c, arrivals))
    rs = loop_c._resident.stats
    require(ctr("rb_serving_dispatches_total") == d_ring
            and rs["served"] == loop_c.stats["pools"] == len(pairs)
            and rs["demoted"] == 0 and ms._programs.captures == caps0
            and rt_lattice.escape_total() == 0,
            f"14c: ring {rs}, pools {loop_c.stats['pools']}, dispatches "
            f"{ctr('rb_serving_dispatches_total') - d_ring}, escapes "
            f"{rt_lattice.escape_total()}")
    require(smoke.last[b5] >= len(pairs), f"14c: B5 {smoke.last[b5]}")
    for t in got_c:
        a = by_req.get(id(t.request))
        require(t.ok and exact(t.result, t.request, t.query, tenants),
                f"14c: {t.request} != the host oracle")
        if a is not None and a.ok and not a.degraded:
            require(same_results([t.result], [a.result]),
                    "14c: ring result != 14a's")
    loop_o = ServingLoop(ms, ServingPolicy(**mega_pol))
    got_o = serve("14c one-shot stream (same pools, same graphs)",
                  lambda: replay_stream(loop_o, arrivals))
    require(all(same_results([a.result], [b.result])
                for a, b in zip(got_c, got_o)), "14c: ring != one-shot")
    one_t = list(loop_o.timings)
    # the ring again on a fresh loop (the same pools), its plans cached as
    # the one-shot run's were
    loop_c = ServingLoop(ms, ServingPolicy(resident=True, **mega_pol))
    d0 = ctr("rb_serving_dispatches_total")
    got_c = serve("14c resident ring stream, again",
                  lambda: replay_stream(loop_c, arrivals))
    require(ctr("rb_serving_dispatches_total") == d0
            and ms._programs.captures == caps0
            and rt_lattice.escape_total() == 0
            and all(same_results([a.result], [b.result])
                    for a, b in zip(got_c, got_o)), "14c: second ring run")
    ring_t = list(loop_c.timings)
    rs = loop_c._resident.stats

    def med(ts, key):
        return float(np.median([x[key] for x in ts]))

    log(f"    14c [{card}]: {rs['served']} pools ring-served of "
        f"{loop_c.stats['pools']}, rb_serving_dispatches_total flat, no "
        f"capture, no escape; results equal 14a's and the host oracle; a "
        f"pool's host ms (medians of {len(ring_t)}): ring loop "
        f"{med(ring_t, 'loop_ms'):.3f} + serve {med(ring_t, 'engine_ms'):.3f}"
        f" against one-shot loop {med(one_t, 'loop_ms'):.3f} + execute "
        f"{med(one_t, 'engine_ms'):.3f}; ring "
        f"{loop_c._resident.ring.state_event()}")
    # one pool past the vocabulary, one wedged ring: typed demotions
    deep = expr.ref(0)
    for i in range(depth + 1):
        deep = expr.xor(expr.and_(deep, expr.ref(i + 1)), expr.ref(i + 2))
    deep_req = ServingRequest(0, expr.ExprQuery(deep), tenant="deep")
    d0 = ctr("rb_serving_dispatches_total")
    dem0 = {r: ctr("rb_serving_resident_demotions_total", reason=r)
            for r in ("vocabulary", "wedged")}
    t_deep = loop_c.submit(deep_req)
    loop_c.drain()
    loop_c._resident.ring.wedge()
    t_wedged = [loop_c.submit(r) for r in pairs[0]]
    loop_c.drain()
    loop_c._resident.ring.reset()
    dem = {r: ctr("rb_serving_resident_demotions_total", reason=r) - dem0[r]
           for r in ("vocabulary", "wedged")}
    require(dem == {"vocabulary": 1, "wedged": 1}
            and ctr("rb_serving_dispatches_total") == d0 + 2,
            f"14c demotions {dem}")
    for t in [t_deep] + t_wedged:
        require(t.ok and exact(t.result, t.request, t.query, tenants),
                f"14c demoted pool: {t.request} != the host oracle")
    log(f"    14c: a depth-{depth + 2} pool and a wedged ring demoted typed "
        f"({dem}), each served exactly by the one-shot dispatch")
    rt_lattice.deactivate()

    # ----------------------------------------------------------------- 14e
    with WireServer(loop_a, max_inflight=4096) as srv:
        cl = WireClient(srv.address, timeout=120)
        cl_tickets = recorded(cl)
        # the stream at 14a's sustained rate, paced, for about 6 s of wall
        n_wire = max(64, min(len(events), int(len(events) * 6.0 * rate_s
                                              / 4.0)))
        rep_e = serve(f"14e run_wire over 127.0.0.1, paced at {rate_s:g}x",
                      lambda: replay.run_wire(cl, events[:n_wire],
                                              rate_scale=rate_s, pace=True,
                                              timeout=120))
        del cl.submit
        same = 0
        for t in cl_tickets:
            a = by_req.get(id(t.request))
            if t.ok and a is not None and a.ok:
                require(t.result.cardinality == a.result.cardinality
                        and t.result.value == a.result.value and (
                            t.result.degraded or a.degraded
                            or t.result.bitmap == a.result.bitmap),
                        f"14e: {t.request} != 14a's result")
                same += 1
        require(rep_e["typed_only"] and same > 0, f"14e: {rep_e}")
        log(f"    14e wire [{card}]: the first {n_wire} requests at "
            f"{rate_s:g}x: {rep_e['done']} done, {rep_e['shed']} "
            f"shed, {rep_e['failed']} failed of {rep_e['queries']}; p50 "
            f"{rep_e['p50_ms']} ms, p99 {rep_e['p99_ms']} ms (wall, client "
            f"send to response), {rep_e['qps']} Q/s; {same} results equal "
            f"14a's; server {srv.stats}")
        # typed error frames on a live connection
        with faults.inject(f"wire@slow_peer=1.0:{seed}"):
            r = cl.call(queries[0], 60)
        bad_set = cl.submit(ServingRequest(n_t + 5, BatchQuery("or", (0, 1))))
        err = None
        try:
            bad_set.value(60)
        except errors.CorruptInput as exc:
            err = exc
        cl.ping()
        require(r.cardinality >= 0 and err is not None,
                f"14e: slow peer / malformed submit: {err!r}")
        # migration: tenant 1's captured state as mig_* frames
        t0 = time.perf_counter()
        state = durability.capture_state(sets[1], tenant="t1")
        frames = wmig.state_frames("m14", "t1", state)
        ack = cl.migrate_frames(frames, timeout=300)
        mig_ms = (time.perf_counter() - t0) * 1e3
        want_crcs = wmig.source_crcs(sets[1])
        landed = srv.migrated.pop("t1")
        require(ack["source_crcs"] == want_crcs,
                f"14e migration: source CRCs differ ({ack.get('phase')})")
        require(landed.device.type == "cuda",
                f"14e migration: landed on {landed.device}, not the card")
        del landed
        cl.close()
        require(srv.stats["pump_errors"] == 0, f"14e: {srv.stats}")
    with WireServer(loop_a, auth={"tok": ["t0"]}) as asrv:
        acl = WireClient(asrv.address, token="tok", timeout=60)
        denied = acl.submit(ServingRequest(1, BatchQuery("or", (0, 1)),
                                           tenant="t1"))
        try:
            denied.value(60)
            auth_err = None
        except errors.AuthRejected as exc:
            auth_err = exc
        acl.ping()
        acl.close()
    require(auth_err is not None and auth_err.context["tenant"] == "t1",
            "14e: a tenant outside the grant was not AuthRejected")
    log(f"    14e: wire@slow_peer answered, a malformed submit came back as a "
        f"typed {type(err).__name__} frame and a tenant outside its grant "
        f"as AuthRejected, each connection live after (ping); tenant 1 "
        f"migrated as {len(frames)} mig_* frames "
        f"({durability.state_bytes(state)} bytes) and committed onto the "
        f"card in {mig_ms:.1f} ms with its {len(want_crcs)} source CRCs equal")
    require(ctr("rb_serving_pump_errors_total") == 0,
            "14e: a pump raised")
    # the second process: bootstrap --device cuda
    bknobs = dict(sets=4, sources=64, users=1 << 24, density=40960,
                  tenants=8, requests=256, seed=seed)
    cmd = [sys.executable, "-m", "roaringbitmap_tpu_torch.wire.bootstrap",
           "--device", "cuda", "--seed", str(seed), "--sets", "4",
           "--sources", "64", "--users", str(1 << 24), "--density", "40960",
           "--tenants", "8"]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        up_s = time.perf_counter() - t0
        bprof = replay.ReplayProfile(**bknobs, delta_share=0.0)
        bbms, bcols = replay.build_dataset(bprof)
        bcolumns = [{"v": BsiColumn("v", ids, vals)} for ids, vals in bcols]
        bev = replay.generate(bprof)
        bcl = WireClient((info["host"], info["port"]), timeout=120)
        btk = recorded(bcl)
        brep = replay.run_wire(bcl, bev, pace=False, timeout=120)
        bcl.close()
        for t in btk:
            require(t.ok and exact(t.result, t.request, t.request.query,
                                   bbms, bcolumns),
                    f"14e bootstrap: {t.request} != the host oracle "
                    f"({t.error!r})")
        proc.stdin.close()
        rc = proc.wait(timeout=60)
        require(rc == 0, f"14e bootstrap: exit {rc}, {info}")
        require(info["device"].startswith("cuda"),
                f"14e bootstrap: served from {info['device']}, not the card")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log(f"    14e bootstrap --device cuda [{card}]: a child process "
        f"(pid {info['pid']}, {info['device']}, up in {up_s:.1f} s) served "
        f"{brep['done']} of {brep['queries']} requests exactly, p50 "
        f"{brep['p50_ms']} ms, p99 {brep['p99_ms']} ms, {brep['qps']} Q/s; "
        f"exit 0 when its pipe closed")

    # ----------------------------------------------------------------- 14b
    # the default mix; its first eighth, as 14a's ladder (each delta that
    # lands in a container its source lacks costs a repack of the tenant)
    mev = replay.generate(replay.ReplayProfile(**knobs))
    mev = mev[:len(mev) // 8]
    hosts = [list(t) for t in tenants]
    for ev in mev:
        if ev[0] == "delta":
            _, _, sid, adds, removes = ev
            hosts[sid] = host_delta(hosts[sid], adds, removes)
    loop_b = ServingLoop(ms, policy)
    # deltas that escalate (a value in a container its source lacks) repack
    # on a maintenance worker under the loop's lock, off the serving path;
    # a front door with apply_delta is how the replay arm sends them
    worker = MaintenanceWorker(lock=loop_b._lock)

    class Front:
        submit, pump, drain = loop_b.submit, loop_b.pump, loop_b.drain

        @staticmethod
        def apply_delta(sid, adds, removes):
            with loop_b._lock:
                sets[sid].apply_delta(adds, removes, worker=worker)

    rep_b = serve(f"14b run_inproc, mixed stream with deltas at {rate_s:g}x",
                  lambda: replay.run_inproc(Front, mev, rate_scale=rate_s))
    t0 = time.perf_counter()
    worker.stop(drain=True, timeout=600)
    loop_b.drain()
    drain_s = time.perf_counter() - t0
    require(rep_b["typed_only"] and rep_b["deltas"] > 0
            and worker.jobs_failed == 0
            and ctr("rb_serving_pump_errors_total") == 0,
            f"14b: {rep_b}, worker failures {worker.jobs_failed}")
    report_line("14b", rep_b, loop_b)
    t0 = time.perf_counter()
    for t, ds in enumerate(sets):
        require(ds.host_bitmaps() == hosts[t],
                f"14b: tenant {t}'s host twin != the host copy")
    post = [ev[2] for ev in mev if ev[0] == "query"][:64]
    tk = [loop_b.submit(ServingRequest(r.set_id, r.query, tenant=r.tenant,
                                       deadline_ms=600_000.0)) for r in post]
    loop_b.drain()
    require(all(t.ok and exact(t.result, t.request, t.query, hosts)
                for t in tk), "14b: the post-drain pool != the host oracle")
    log(f"    14b: after drain every tenant's host twin equals the host "
        f"copy with the stream's {rep_b['deltas']} deltas applied in order, "
        f"and a 64-request pool equals the host oracle (host "
        f"{time.perf_counter() - t0:.1f} s); the worker's {worker.jobs_done} "
        f"repacks drained {drain_s:.1f} s after the stream; deltas by "
        f"mode {delta_modes()}; layouts {[s.layout for s in sets]}")

    # ----------------------------------------------------------------- 14d
    # the durable root: a temporary directory inside the checkout
    root = tempfile.mkdtemp(prefix=".durable-", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        drng = np.random.default_rng(seed + 14)
        def values_in(t, src, n):
            """``n`` values inside containers tenant ``t``'s source ``src``
            holds."""
            k = drng.choice(np.asarray(tenants[t][src].keys, np.uint32), n)
            return (k << 16) | drng.integers(0, 1 << 16, n).astype(np.uint32)

        def gen_delta(t=0):
            """The generator's delta shape (8-48 adds to one source, 8
            removes from one in 3 of 10), its values inside the source's
            containers: the patch path, whose durability this measures
            (14b's uniform values take the repack path)."""
            src = int(drng.integers(0, per))
            adds = {src: values_in(t, src, int(drng.integers(8, 48)))}
            removes = None
            if drng.random() < 0.3:
                src = int(drng.integers(0, per))
                removes = {src: values_in(t, src, 8)}
            return adds, removes

        ds0 = DeviceBitmapSet(tenants[0], layout="dense")
        twin = DeviceBitmapSet(tenants[0], layout="dense")
        t0 = time.perf_counter()
        dt = durability.DurableTenant(
            ds0, root=root, tenant="d0",
            policy=durability.FlushPolicy("always"))
        base_ms = (time.perf_counter() - t0) * 1e3
        appends = []
        orig_append = dt.journal.append

        def timed_append(rec):
            a = time.perf_counter()
            out = orig_append(rec)
            appends.append((time.perf_counter() - a) * 1e3)
            return out

        dt.journal.append = timed_append
        snap = None
        for k in range(64):
            adds, removes = gen_delta()
            dt.apply_delta(adds=adds, removes=removes)
            twin.apply_delta(adds=adds, removes=removes)
            if k == 31:
                snap = dt.snapshot()
        dt.journal.append = orig_append

        def same_image(rec) -> bool:
            torch.cuda.synchronize()
            return (torch.equal(rec.ds.words, twin.words)
                    and rec.ds.host_bitmaps() == twin.host_bitmaps()
                    and rec.ds.aggregate("or").cardinality
                    == twin.aggregate("or").cardinality)

        rows = []
        for point, scope in (("pre_append", "pre_append"),
                             ("pre_apply", "pre_apply"),
                             ("torn", "torn"), ("post_apply", "post_apply")):
            adds, removes = gen_delta()
            with faults.inject(f"crash@{scope}=1.0:1"):
                try:
                    dt.apply_delta(adds=adds, removes=removes)
                    crashed = False
                except errors.InjectedCrash:
                    crashed = True
            require(crashed, f"14d: no crash at {point}")
            dt.close()
            committed = point in ("pre_apply", "post_apply")
            if committed:
                twin.apply_delta(adds=adds, removes=removes)
            torn0 = ctr("rb_journal_torn_tails_total")
            rec, rep = durability.recover_tenant(
                root=root, tenant="d0",
                policy=durability.FlushPolicy("always"))
            require(rec.ds.device.type == "cuda",
                    f"14d {point}: recovered onto {rec.ds.device}, not the "
                    f"card")
            require(rep["torn"] == (point == "torn")
                    and ctr("rb_journal_torn_tails_total") - torn0
                    == (point == "torn") and same_image(rec),
                    f"14d {point}: recovery != the never-crashed twin {rep}")
            if not committed:
                rec.apply_delta(adds=adds, removes=removes)
                twin.apply_delta(adds=adds, removes=removes)
            rows.append(f"{point} (replayed {rep['replayed']}, torn "
                        f"{rep['torn']}): load {rep['load_ms']:.1f} + restore"
                        f" {rep['restore_ms']:.1f} + replay "
                        f"{rep['replay_ms']:.1f} ms")
            dt = rec
        require(same_image(dt), "14d: the final image != the twin")
        dt.close()
        log(f"  14d durable tenant 0 [{card}]: base snapshot {base_ms:.1f} "
            f"ms; 64 deltas, journal append with fsync median "
            f"{float(np.median(appends)):.3f} ms (p99 "
            f"{float(np.percentile(appends, 99)):.3f}); snapshot after 32: "
            f"{snap['wall_ms']} ms, {snap['bytes']} bytes")
        log(f"    14d crash seams, each recovered onto the card equal to the "
            f"never-crashed twin (image words, host twin and cardinality): "
            f"{'; '.join(rows)}")
        del ds0, twin, dt, rec
        # group commit across 4 tenants
        sched = durability.GroupCommitScheduler(every_n=8)
        gts = [durability.DurableTenant(
            DeviceBitmapSet(tenants[t], layout="dense"), root=root,
            tenant=f"g{t}", policy=sched.policy()) for t in range(4)]
        ghosts = [list(tenants[t]) for t in range(4)]
        t0 = time.perf_counter()
        for k in range(16):
            for t, gt in enumerate(gts):
                adds, removes = gen_delta(t)
                gt.apply_delta(adds=adds, removes=removes)
                ghosts[t] = host_delta(ghosts[t], adds, removes)
        sched.commit()
        g_ms = (time.perf_counter() - t0) * 1e3
        for gt in gts:
            gt.close()
        for t in range(4):
            rec, _ = durability.recover_tenant(
                root=root, tenant=f"g{t}",
                policy=durability.FlushPolicy("never"))
            require(rec.ds.host_bitmaps() == ghosts[t],
                    f"14d group: tenant g{t} != its host copy")
            rec.close()
        log(f"    14d group commit over 4 tenants: {sched.stats} "
            f"({sched.stats['fsyncs']} fsyncs for {sched.stats['appends']} "
            f"appends; 64 applies in {g_ms:.1f} ms); each recovered exact")
        del gts
    finally:
        shutil.rmtree(root, ignore_errors=True)

    require(all(served.values()), f"14: B1/B3/B5 from the loop {served}")
    log(f"  14: launches from the serving stack's main-path calls {served}; "
        f"pump errors {ctr('rb_serving_pump_errors_total'):.0f}")
    del loop_a, loop_b, loop_c, loop_o, loop_t, runs, ms
    torch.cuda.empty_cache()
    return tenants, knobs


#: the span names a serving pool's host work splits into (15a)
SERVING_SPANS = ("serving.admit", "serving.assemble", "serving.shed",
                 "serving.dispatch")


def serving_split(spans: list, builds: list) -> dict:
    """{(serving span, name): [ms, count]} of a dump: every span's wall
    under the ``serving.*`` span it nests in (by parent links), and the B5
    stream builds (``builds``: (start, end) wall intervals) under the
    serving span whose interval holds them."""
    by_id = {s["span_id"]: s for s in spans}

    def root(s):
        while s is not None:
            if s["name"] in SERVING_SPANS:
                return s["name"]
            s = by_id.get(s["parent_id"])
        return None

    out: dict = {}
    for s in spans:
        r = root(s)
        if r is None:
            continue
        row = out.setdefault((r, s["name"]), [0.0, 0])
        row[0] += s["dur_ms"]
        row[1] += 1
    holders = [(s["t_start"], s["t_start"] + s["dur_ms"] / 1e3, s["name"])
               for s in spans if s["name"] in SERVING_SPANS]
    for a, b in builds:
        # the innermost serving span holding the build
        held = [(hi - lo, name) for lo, hi, name in holders
                if lo - 1e-6 <= a and b <= hi + 1e-6]
        if held:
            row = out.setdefault((min(held)[1], "B5 stream build"),
                                 [0.0, 0])
            row[0] += (b - a) * 1e3
            row[1] += 1
    return out


def device_share(trace_path: str, names) -> dict:
    """{range name: (host ms, device-busy ms)} from a ``torch.profiler``
    Chrome trace: each kernel, copy or set counts toward every range whose
    host interval holds the runtime call that launched it (matched by the
    correlation id), so a range counts the device work of the ranges
    nested in it."""
    with open(trace_path) as f:
        evs = json.load(f).get("traceEvents", [])
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in evs
              if e.get("ph") == "X" and e.get("name") in names
              and e.get("cat") == "user_annotation"]
    launch = {}
    for e in evs:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                "args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    out = {n: [0.0, 0.0] for n in names}
    for lo, hi, n in ranges:
        out[n][0] += (hi - lo) / 1e3
    for e in evs:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for n in {n for lo, hi, n in ranges if lo <= ts <= hi}:
            out[n][1] += e.get("dur", 0) / 1e3
    return {n: tuple(v) for n, v in out.items()}


PROM_LINE = re.compile(
    r'^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'(-?[0-9.]+(e[-+]?[0-9]+)?|NaN|[-+]Inf))$')


def phase15(smoke, seed: int, state14, ds, sds, epool, bms) -> list:
    """Observability on the card, after 14 and before 6: 15a a traced
    serving stream (every ticket exact, the dump valid, the pool's host
    time split by span, B1 / B3 / B5 launched inside ``serving.dispatch``);
    15b cost and memory events of a traced pool, expression batch and
    dense ``or``; 15c an SLO miss, a flight dump, guard counters under a
    drain fault, statusz, the Prometheus text and one profiled pump; 15d
    the Q 64 pool's wall with tracing off and on.  Returns the roofline
    fractions of 15b for phase 6 to print beside each kernel's share of
    its bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from roaringbitmap_tpu_torch import DeviceBitmapSet, obs
    from roaringbitmap_tpu_torch.analytics import BsiColumn
    from roaringbitmap_tpu_torch.mutation import durability
    from roaringbitmap_tpu_torch.ops import kernels, megakernel
    from roaringbitmap_tpu_torch.parallel import aggregation, expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                               BatchQuery)
    from roaringbitmap_tpu_torch.parallel.multiset import (
        MultiSetBatchEngine, random_multiset_pool)
    from roaringbitmap_tpu_torch.runtime import faults, guard
    from roaringbitmap_tpu_torch.runtime import lattice as rt_lattice
    from roaringbitmap_tpu_torch.serving import (ServingLoop, ServingPolicy,
                                                 ServingRequest, replay)

    b1, b3, b5 = kernels.B1.name, kernels.B3.name, kernels.B5.name
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    checker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "check_trace.py")

    def check_dump(path: str) -> str:
        """``tools/check_trace.py`` in plain mode, as a subprocess."""
        out = subprocess.run([sys.executable, checker, path],
                             capture_output=True, text=True, timeout=600)
        require(out.returncode == 0,
                f"check_trace {path}: {out.stderr[-3000:]}")
        return out.stdout.strip()

    # 14a's 16 tenants built anew (14b patched and repacked its own: a
    # structural delta repacks a compact tenant dense), with 14's columns
    tenants, knobs = state14
    per = min(len(t) for t in tenants)
    sets = smoke.main_path("15 tenant builds", lambda: [
        DeviceBitmapSet(b, layout="dense" if t < 12 else "compact")
        for t, b in enumerate(tenants)])
    for ds_, (ids, vals) in zip(sets, replay.dataset_columns(
            replay.ReplayProfile(**knobs))):
        ds_.attach_column(BsiColumn("v", ids, vals))
    columns = [{"v": ds_.columns["v"]} for ds_ in sets]
    obs.reset()

    def oracle(sid, q):
        srcs, cols = tenants[sid], columns[sid]
        if isinstance(q, BatchQuery):
            want = host_query(q, srcs)
            return want.cardinality, None, want
        if expr.is_agg(q.expr):
            return expr.evaluate_host_agg(q.expr, srcs, cols)
        want = expr.evaluate_host(q.expr, srcs, cols)
        return want.cardinality, None, want

    def exact(t) -> bool:
        card_, value, bm = oracle(t.request.set_id, t.query)
        return ((t.result.cardinality, t.result.value) == (card_, value)
                and (t.query.form != "bitmap" or t.result.bitmap == bm))

    # ----------------------------------------------------------------- 15a
    events = replay.generate(replay.ReplayProfile(
        **knobs, delta_share=0.0))[:256]
    ms = MultiSetBatchEngine(sets, result_cache=None)
    loop = ServingLoop(ms, ServingPolicy(pool_target=64))
    done: list = []
    loop.add_completion_listener(done.extend)
    # the launches made inside the loop's dispatch (the serving.dispatch
    # span), and the B5 stream builds by wall interval
    in_dispatch = dict.fromkeys((b1, b3, b5), 0)
    dispatch, build_full = loop._dispatch, megakernel.build_full
    builds: list = []

    def counted(tickets):
        before = {k.name: k.launches for k in kernels.KERNELS}
        try:
            return dispatch(tickets)
        finally:
            for k in kernels.KERNELS:
                if k.name in in_dispatch:
                    in_dispatch[k.name] += k.launches - before[k.name]

    def timed_build(*a, **kw):
        t0 = time.time()
        try:
            return build_full(*a, **kw)
        finally:
            builds.append((t0, time.time()))

    dump_a = out_path("15a-serving.jsonl")
    loop._dispatch = counted
    megakernel.build_full = timed_build
    stop = trace_into(obs, dump_a)
    try:
        rep = smoke.main_path(
            "15a traced replay, first 256 at 1/16",
            lambda: replay.run_inproc(loop, events, rate_scale=1 / 16))
    finally:
        stop()
        megakernel.build_full = build_full
        loop._dispatch = dispatch
    ok = [t for t in done if t.status == "done"]
    bad = [t for t in ok if not exact(t)]
    require(not bad and rep["typed_only"],
            f"15a: {len(bad)} tickets != the host oracle; {rep}")
    total = {k: smoke.last[k] for k in in_dispatch}
    require(all(in_dispatch[k] > 0 for k in in_dispatch)
            and in_dispatch == total,
            f"15a: launches inside serving.dispatch {in_dispatch}, in the "
            f"run {total}")
    log(f"    15a [{card}]: {rep['done']} served (each equal to the host "
        f"oracle), {rep['shed']} shed, {rep['rejected']} rejected of "
        f"{rep['queries']}, typed only; {loop.stats['pools']} pools; "
        f"launches inside serving.dispatch {in_dispatch}; "
        f"{check_dump(dump_a)}")
    spans = read_spans(dump_a)
    split = serving_split(spans, builds)
    pools = max(1, loop.stats["pools"])
    engine_ms = sum(t["engine_ms"] for t in loop.timings)
    cost_evs = [e for s in spans for e in s["events"]
                if e["name"] in ("batch.cost", "multiset.cost")]
    dev_ms = sum(e["device_ms"] for e in cost_evs)
    for name in SERVING_SPANS:
        ms_, n_ = split.get((name, name), (0.0, 0))
        inner = sorted(((k[1], v) for k, v in split.items()
                        if k[0] == name and k[1] != name),
                       key=lambda kv: -kv[1][0])[:6]
        log(f"    15a host ms by span: {name} {ms_:.3f} ms in {n_} spans "
            f"({ms_ / pools:.3f} a pool); inside it "
            + ", ".join(f"{k} {v[0]:.3f} ms x{v[1]}" for k, v in inner))
    log(f"    15a: the engine's wall {engine_ms:.3f} ms over {pools} pools "
        f"({engine_ms / pools:.3f} a pool), device_ms of their "
        f"{len(cost_evs)} cost events {dev_ms:.3f} ms "
        f"({dev_ms / pools:.3f} a pool)")

    # ----------------------------------------------------------------- 15b
    pool64 = random_multiset_pool([per] * len(sets), 64, seed=0xACE,
                                  max_operands=8)
    seng = BatchEngine(sds, result_cache=None)
    deng = BatchEngine(ds, result_cache=None)
    orq = [BatchQuery("or", tuple(range(64)), form="bitmap")]
    adhoc = bms[:1024]
    want = (ms.execute(pool64), seng.execute(epool), deng.execute(orq),
            aggregation.or_(adhoc))          # warm, untraced
    require(same_results(want[2], deng.execute(orq, engine="torch")),
            "15b: the dense or != the torch rung")
    dump_b = out_path("15b-cost.jsonl")
    stop = trace_into(obs, dump_b)
    try:
        got = (smoke.main_path("15b Q64 pool traced",
                               lambda: ms.execute(pool64)),
               smoke.main_path("15b 7b expression batch traced",
                               lambda: seng.execute(epool)),
               smoke.main_path("15b dense or at K 256 traced",
                               lambda: deng.execute(orq)),
               smoke.main_path("15b ad-hoc or_ (B2) traced",
                               lambda: aggregation.or_(adhoc)))
    finally:
        stop()
    require(all(same_results(g, w) for g, w in zip(got[0], want[0]))
            and same_results(got[1], want[1])
            and same_results(got[2], want[2]) and got[3] == want[3],
            "15b: a traced result != the untraced one")
    spans = read_spans(dump_b)
    log(f"    15b: {check_dump(dump_b)}")
    predicted = {"multiset.dispatch": ms.predict_dispatch_bytes(pool64),
                 "seng": seng.predict_dispatch_bytes(epool),
                 "deng": deng.predict_dispatch_bytes(orq)}
    dispatches = [s for s in spans
                  if s["name"] in ("batch.dispatch", "multiset.dispatch")]
    require(len(dispatches) == 3, f"15b: dispatch spans "
            f"{[s['name'] for s in dispatches]}")
    labels = ("11a Q64 pool (B1 + B3)", "7b expression batch (B5)",
              "dense or at K 256 (B1)")
    kern = ((b1, b3), (b5,), (b1,))
    pred = (predicted["multiset.dispatch"], predicted["seng"],
            predicted["deng"])
    fractions = []
    for s, label, ks, p in zip(dispatches, labels, kern, pred):
        ev = {e["name"]: e for e in s["events"]}
        cost = ev.get("batch.cost") or ev.get("multiset.cost")
        mem = ev.get("batch.memory") or ev.get("multiset.memory")
        require(cost is not None and cost["device_ms"] > 0
                and cost["bytes_accessed"] == p
                and 0.0 < cost["roofline_fraction"] <= 1.0,
                f"15b {label}: cost event {cost}, predicted {p}")
        require(mem is not None and "measured_peak_bytes" in mem
                and mem["measured_peak_bytes"] <= mem["predicted_bytes"],
                f"15b {label}: memory event {mem}")
        fractions.append((label, ks, cost["roofline_fraction"],
                          cost["roofline_fraction_raw"]))
        log(f"    15b [{card}] {label}: device {cost['device_ms']} ms, "
            f"{cost['bytes_accessed']:.0f} bytes (= the plan's prediction), "
            f"{cost['flops']:.0f} word ops, roofline fraction "
            f"{cost['roofline_fraction']} (raw "
            f"{cost['roofline_fraction_raw']}); measured peak "
            f"{mem['measured_peak_bytes']} <= predicted "
            f"{mem['predicted_bytes']}")
    wide = [s for s in spans if s["name"] == "aggregation.wide"]
    require(wide and wide[0]["tags"].get("rung_used") == "cuda",
            f"15b: aggregation.wide {wide}")
    log(f"    15b: the ad-hoc or_ ran under aggregation.wide "
        f"({wide[0]['dur_ms']} ms, rung cuda; the JAX schema gives a wide "
        f"call no cost event)")

    # ----------------------------------------------------------------- 15c
    dump_c = out_path("15c-slo.jsonl")
    stop = trace_into(obs, dump_c)
    try:
        ms.execute(pool64, policy=guard.GuardPolicy(slo_deadline_ms=1e-3))
    finally:
        stop()
    slos = [e for s in read_spans(dump_c) for e in s["events"]
            if e["name"] == "slo"]
    require(slos and slos[0]["missed"] is True
            and abs(sum(slos[0]["phases_ms"].values()) - slos[0]["wall_ms"])
            <= 0.05 * slos[0]["wall_ms"], f"15c: slo events {slos}")
    fdir = os.path.join(OUT_DIR, "flight")
    shutil.rmtree(fdir, ignore_errors=True)
    obs.flight.configure(dir=fdir)
    obs.flight.reset()                 # no debounce left from phase 14
    lf = ServingLoop(ms, ServingPolicy(pool_target=4, shed=False))
    late = lf.submit(ServingRequest(0, BatchQuery("or", (0, 1)),
                                    deadline_ms=1e-3))
    lf.pump(force=True)
    dumps = sorted(os.listdir(fdir)) if os.path.isdir(fdir) else []
    require(late.status == "done" and late.missed and dumps,
            f"15c: late request {late.status}, missed {late.missed}, "
            f"flight dumps {dumps}")
    with open(os.path.join(fdir, dumps[0])) as f:
        fdoc = json.load(f)
    log(f"    15c: a {slos[0]['deadline_ms']} ms deadline: slo event, "
        f"phases {slos[0]['phases_ms']} sum to {slos[0]['wall_ms']} ms; "
        f"flight dump {dumps[0]} ({fdoc['trigger']}, {len(fdoc['events'])} "
        f"events) parses; {check_dump(os.path.join(fdir, dumps[0]))}")
    obs.flight.configure(dir=None)
    guard.reset_dispatch_stats()
    pools4 = [random_multiset_pool([per] * len(sets), 64, seed=200 + i,
                                   max_operands=8) for i in range(4)]
    r0 = ms.drain_retries
    with faults.inject("transient@multiset.drain=0.5:0xD4"):
        ms.execute_pipelined(pools4,
                             policy=guard.GuardPolicy(pipeline_depth=2))
    reg = {}
    for n, lab, inst in obs.metrics.REGISTRY.instruments():
        if n == "rb_dispatch_events_total":
            reg.setdefault(lab["site"], {})[lab["event"]] = int(inst.value)
    stats = guard.dispatch_stats()
    require(all(reg.get(site, {}).get(k, 0) == v
                for site, row in stats.items() for k, v in row.items())
            and all(stats.get(site, {}).get(k, 0) == v
                    for site, row in reg.items() for k, v in row.items()),
            f"15c: registry {reg} != dispatch_stats {stats}")
    log(f"    15c: transient@multiset.drain=0.5: "
        f"{ms.drain_retries - r0} launches re-run at drain "
        f"(rb_multiset_drain_retries_total "
        f"{ctr('rb_multiset_drain_retries_total'):.0f}); guard counters "
        f"in the registry {reg} equal dispatch_stats() {stats}")
    root = out_path("15c-durable")
    shutil.rmtree(root, ignore_errors=True)
    dt = durability.DurableTenant(
        DeviceBitmapSet(tenants[0][:16], layout="dense"), root=root,
        tenant="sz", policy=durability.FlushPolicy("never"),
        snapshot_every=None)
    dt.apply_delta(adds={0: [12345]})
    loop_r = ServingLoop(ms, ServingPolicy(pool_target=4, resident=True))
    rt_lattice.activate("q=4,;rows=64,;keys=256,;heads=both;pool=256,")
    try:
        doc = obs.statusz.merge([obs.statusz.local_doc(
            sections={"serving": loop_r.snapshot()})])
        page = obs.render_markdown(doc)
        top = obs.render_markdown(obs.statusz())
    finally:
        rt_lattice.deactivate()
        dt.close()
        shutil.rmtree(root, ignore_errors=True)
    for part in ("- serving: level=", "- resident ring: active=",
                 "- journal[sz]:", "- lattice:", "- flight: ring"):
        require(part in page, f"15c statusz: no {part!r} in\n{page}")
    sz = out_path("15c-statusz.jsonl")
    with open(sz, "w") as f:
        f.write(json.dumps(doc, default=str) + "\n")
    log(f"    15c statusz [{card}]: {check_dump(sz)}; the page:")
    for line in page.splitlines():
        if line.startswith("- ") and not line.startswith("- `"):
            log(f"      {line[:160]}")
    require(top.startswith("# roaring-tpu statusz"), "15c: obs.statusz()")
    text = obs.render_prometheus()
    badp = [line for line in text.splitlines() if not PROM_LINE.match(line)]
    require(text and not badp, f"15c: Prometheus lines {badp[:3]}")
    log(f"    15c: render_prometheus: {len(text.splitlines())} lines, "
        f"{text.count('# TYPE')} families, every line parses")
    # one pump under torch.profiler with the spans as profiler ranges
    lp = ServingLoop(ms, ServingPolicy(pool_target=64))
    # far deadlines: the profiler's own cost must not shed the pool
    reqs = [dataclasses.replace(ev[2], deadline_ms=600_000.0)
            for ev in events[:48]]
    for r in reqs[:4]:
        lp.submit(r)
    lp.drain()                                 # warm
    dump_x = out_path("15c-xprof.jsonl")
    chrome = out_path("15c-profile.json")
    stop = trace_into(obs, dump_x, xprof=True)
    try:
        for r in reqs[4:]:
            lp.submit(r)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lp.pump(force=True)
            torch.cuda.synchronize()
        prof.export_chrome_trace(chrome)
    finally:
        stop()
    names = ("serving.assemble", "serving.dispatch", "multiset.dispatch",
             "batch.dispatch", "multiset.readback", "batch.readback")
    share = device_share(chrome, names)
    require(lp.stats["pools"] >= 2 and share["serving.dispatch"][1] > 0,
            f"15c: pools {lp.stats}, no device time under serving.dispatch "
            f"ranges: {share}")
    log(f"    15c profiled pump [{card}]: device-busy share by range: "
        + "; ".join(f"{n} {d:.3f} of {h:.3f} ms ({d / h:.1%})"
                    for n, (h, d) in share.items() if h > 0))
    os.remove(chrome)

    # ----------------------------------------------------------------- 15d
    t_off = median_ms(torch, lambda: ms.execute(pool64))
    dump_d = out_path("15d-on.jsonl")
    stop = trace_into(obs, dump_d)
    try:
        t_on = median_ms(torch, lambda: ms.execute(pool64))
    finally:
        stop()
    log(f"  15d [{card}]: the 11a Q64 pool (cardinality form), wall to host "
        f"results, median of 5 warm: tracing off {t_off:.3f} ms, on "
        f"{t_on:.3f} ms ({t_on / t_off:.3f}x)")
    del loop, lf, loop_r, lp, ms
    torch.cuda.empty_cache()
    return fractions, sets


def phase16(smoke, seed: int, shapes: dict, adhoc, abms, lift, bsi9, sbms,
            price, sets15, tenants15, knobs15) -> None:
    """Mesh and pod on the card (``parallel.sharding``,
    ``parallel.sharded_engine``, ``parallel.multihost``,
    ``parallel.podmesh``, ``serving.frontdoor``, ``serving.migration``),
    after 15 and before 6, over logical shards of the one card (they
    measure the combine's cost, not scaling): 16a the sharded wide ops,
    16b the sharded value columns, 16c the sharded engine, 16d the pod,
    16e process groups.  Fills ``shapes`` with B1's narrow widths and B5's
    combine-mode plan for phase 6."""
    import tempfile

    import torch

    from roaringbitmap_tpu_torch import DeviceBitmapSet, aggregation
    from roaringbitmap_tpu_torch.bsi import Operation
    from roaringbitmap_tpu_torch.bsi.device import _topk_res
    from roaringbitmap_tpu_torch.core.bitmap import RoaringBitmap
    from roaringbitmap_tpu_torch.ops import kernels, packing
    from roaringbitmap_tpu_torch.ops.words import popcount
    from roaringbitmap_tpu_torch.parallel import (
        BatchGroup, BatchQuery, MultiSetBatchEngine, ShardedBatchEngine, expr,
        multihost, podmesh, sharding)
    from roaringbitmap_tpu_torch.parallel.multiset import random_multiset_pool
    from roaringbitmap_tpu_torch.runtime import errors, faults, guard
    from roaringbitmap_tpu_torch.runtime import lattice as rt_lattice
    from roaringbitmap_tpu_torch.serving import (PodFrontDoor, ServingPolicy,
                                                 host_join, host_leave,
                                                 migrate_tenant)
    from roaringbitmap_tpu_torch.serving.loop import AdmissionRejected
    from roaringbitmap_tpu_torch.serving import replay
    from roaringbitmap_tpu_torch.wire import WireClient
    from roaringbitmap_tpu_torch.wire import migrate as wmig

    b1, b3, b5 = kernels.B1.name, kernels.B3.name, kernels.B5.name
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    def mesh(rows, cols, names=("rows", "lanes")):
        devs = np.empty((rows, cols), dtype=object)
        devs.flat[:] = [torch.device("cuda", 0)] * (rows * cols)
        return sharding.Mesh(devs, names)

    def same_pool(got, want) -> bool:
        return len(got) == len(want) and all(
            same_results(g, w) for g, w in zip(got, want))

    # ----------------------------------------------------------------- 16a
    t0 = time.perf_counter()
    inputs = {"or": adhoc, "xor": adhoc, "and": abms}
    single = {"or": aggregation.or_(adhoc), "xor": aggregation.xor(adhoc),
              "and": aggregation.and_(abms)}
    host = {op: host_fold(op, inputs[op]) for op in inputs}
    for op in inputs:
        require(single[op] == host[op], f"16a: single-device {op} != host")
    log(f"  16a: single-device or_/xor/and_ over {len(adhoc)} / "
        f"{len(abms)} bitmaps equal the host folds (host "
        f"{time.perf_counter() - t0:.1f} s)")
    runs = []
    for (r, l) in ((1, 1), (4, 1), (2, 2), (8, 1), (2, 4), (1, 8)):
        m = mesh(r, l)
        width = 2048 // l
        ops = ("or", "xor", "and") if l <= 2 and r * l != 2 * 4 else ("or",)
        for op in ops:
            ingests = (("dense", "compact") if op != "and" and l <= 2
                       else ("dense",))
            for ingest in ingests:
                t1 = time.perf_counter()
                k, w, c = smoke.main_path(
                    f"16a {r}x{l} {op} {ingest}",
                    lambda m=m, op=op, ingest=ingest:
                    sharding.wide_aggregate_sharded(m, op, inputs[op],
                                                    ingest=ingest))
                wall = (time.perf_counter() - t1) * 1e3
                nw = kernels.B1.variants.get(width, 0)
                require(nw >= r * l and smoke.last[b1] == nw,
                        f"16a {r}x{l} {op}: B1 launches {smoke.last[b1]}, "
                        f"at width {width}: {nw}")
                got = packing.unpack_result(k, w, c)
                require(got == single[op] and got == host[op],
                        f"16a {r}x{l} {op} {ingest}: != the single-device "
                        f"op or the host fold")
                runs.append(f"{r}x{l} {op} {ingest} {wall:.0f} ms "
                            f"(B1 x{nw} at {width} words)")
    log(f"  16a [{card}]: every sharded result equals the single-device op "
        f"and the host fold: " + "; ".join(runs))
    l_or, l_and = lift(adhoc), lift(abms, bucket=2**31)
    m41 = mesh(4, 1)
    for op, src, fn in (("or", l_or, aggregation.or64),
                        ("xor", l_or, aggregation.xor64),
                        ("and", l_and, aggregation.and64)):
        k, w, c = smoke.main_path(
            f"16a u48 4x1 {op}", lambda op=op, src=src:
            sharding.wide_aggregate_sharded(m41, op, src))
        got = packing.unpack_result(k, w, c)
        require(got == fn(src), f"16a u48 {op}: != the single-device op")
        require(k.dtype == np.uint64, "16a u48: keys are not u48 keys")
    log(f"    16a u48: 10a's lifted bitmaps, or/xor/and over 4x1 equal "
        f"or64/xor64/and64 (K {k.size} for and)")
    n_keys = 2 * sharding.MAX_KEYS_PER_SHARD_PASS + 777
    base = np.arange(n_keys, dtype=np.uint32) << 16
    kbms = [RoaringBitmap.from_values(base + np.uint32(7 * i))
            for i in range(4)]
    kbms.append(RoaringBitmap.from_values(
        (1000 << 16) + np.arange(30000, dtype=np.uint32)))
    for op in ("or", "xor"):
        for ingest in ("dense", "compact"):
            k, w, c = smoke.main_path(
                f"16a chunked {op} {ingest}", lambda op=op, ingest=ingest:
                sharding.wide_aggregate_sharded(m41, op, kbms,
                                                ingest=ingest))
            require(k.size == n_keys and packing.unpack_result(k, w, c)
                    == host_fold(op, kbms), f"16a chunked {op} {ingest}")
    log(f"    16a: {n_keys} keys (3 key chunks of at most "
        f"{sharding.MAX_KEYS_PER_SHARD_PASS}) over 4x1, or/xor in both "
        f"ingests, equal the host fold")
    # B1 at each narrow width, at the shape 16a gives it there: the first
    # shard of the mesh that runs that width (2x2, 2x4, 1x8) holds the
    # first 1/rows of the pack's rows and the first 2048/lanes words of each
    pk = shapes["segmented_reduce"]
    for (r, l) in ((2, 2), (2, 4), (1, 8)):
        width, n = 2048 // l, -(-pk.words.shape[0] // r)
        shapes[f"segmented_reduce_w{width}"] = (
            np.ascontiguousarray(pk.words[:n, :width]), pk.seg_ids[:n],
            pk.num_keys, f"{r}x{l}")

    # ----------------------------------------------------------------- 16b
    hbsi, dbsi, ts_host, drb = bsi9
    m42 = mesh(4, 2)
    t1 = time.perf_counter()
    sb = smoke.main_path("16b ShardedBSI build 4x2",
                         lambda: sharding.ShardedBSI(m42, hbsi))
    stored = int(hbsi.get_value(12345)[0])
    for op, a, b in (("EQ", stored, 0), ("NEQ", stored, 0),
                     ("LT", PRICE_MAX // 3, 0), ("LE", PRICE_MAX // 3, 0),
                     ("GT", PRICE_MAX // 2, 0), ("GE", PRICE_MAX // 2, 0),
                     ("RANGE", PRICE_MAX // 4, PRICE_MAX // 2)):
        got = smoke.main_path(f"16b compare {op}", lambda op=op, a=a, b=b:
                              sb.compare_cardinality(Operation[op], a, b))
        require(got == dbsi.compare_cardinality(Operation[op], a, b),
                f"16b ShardedBSI {op} != DeviceBSI")
    require(sb.sum() == dbsi.sum(), "16b ShardedBSI sum != DeviceBSI")
    want_k = int(popcount(_topk_res(dbsi.slices, dbsi.ebm, 1000)).sum())
    require(sb.top_k_cardinality(1000) == want_k,
            "16b ShardedBSI top_k != DeviceBSI")
    srb = sharding.ShardedRangeBitmap(m42, ts_host)
    tmax = ts_host.max_value
    for op, a in (("lte", tmax // 3), ("lt", tmax // 3), ("gte", tmax // 2),
                  ("gt", tmax // 2), ("eq", tmax // 5), ("neq", tmax // 5)):
        require(getattr(srb, f"{op}_cardinality")(a)
                == getattr(drb, f"{op}_cardinality")(a),
                f"16b ShardedRangeBitmap {op} != DeviceRangeBitmap")
    require(srb.between_cardinality(tmax // 4, tmax // 2)
            == drb.between_cardinality(tmax // 4, tmax // 2),
            "16b ShardedRangeBitmap between != DeviceRangeBitmap")
    ge_ms = median_ms(torch, lambda: sb.compare_cardinality(
        Operation.GE, PRICE_MAX // 2))
    dge_ms = median_ms(torch, lambda: dbsi.compare_cardinality(
        Operation.GE, PRICE_MAX // 2))
    log(f"  16b [{card}]: ShardedBSI over 9c's 2^24 rows (4x2 mesh) equals "
        f"DeviceBSI on every compare op, sum and top_k(1000); "
        f"ShardedRangeBitmap over 9a's ts equals DeviceRangeBitmap; GE "
        f"cardinality {ge_ms:.3f} ms sharded against {dge_ms:.3f} ms single "
        f"(medians of 5; {time.perf_counter() - t1:.1f} s in all)")
    del sb, srb

    # ----------------------------------------------------------------- 16c
    per = min(len(t) for t in tenants15)
    n_t = len(sets15)
    ms = MultiSetBatchEngine(sets15, result_cache=None)
    pools = {q: random_multiset_pool([per] * n_t, q, seed=0xACE,
                                     max_operands=8) for q in (64, 256)}

    def as_form(pool, form):
        return [BatchGroup(g.set_id, [BatchQuery(q.op, q.operands, form=form)
                                      for q in g.queries]) for g in pool]

    forms = {(q, f): as_form(pools[q], f) for q in (64, 256)
             for f in ("cardinality", "bitmap")}
    want = {k: ms.execute(p) for k, p in forms.items()}
    for g, rows in zip(forms[(64, "bitmap")], want[(64, "bitmap")]):
        q = g.queries[0]
        require(rows[0].bitmap == host_query(q, tenants15[g.set_id]),
                f"16c: pooled reference != host fold (tenant {g.set_id})")
    results64 = None
    for shape, placement in (((4, 1), "sharded"), ((2, 2), "replicated")):
        label = f"{shape[0]}x{shape[1]} {placement}"
        m = mesh(*shape, names=("rows", "data"))
        eng = smoke.main_path(f"16c {label} build", lambda m=m, placement=(
            placement): ShardedBatchEngine(sets15, mesh=m,
                                           placement=placement,
                                           result_cache=None))
        require(smoke.last[b3] >= 4, f"16c {label}: the compact tenants' "
                f"rows were not rebuilt by B3 ({smoke.last})")
        log(f"  16c {label} [{card}]: pool image {eng.pool_rows} rows, "
            f"{eng.hbm_bytes()} bytes held (shards of the card share it), "
            f"rows a shard {eng.rows_per_shard}, balance "
            f"{eng.shard_balance:.4f}")
        for (q, f), pool in forms.items():
            got = smoke.main_path(f"16c {label} Q{q} {f}",
                                  lambda pool=pool: eng.execute(pool))
            require(smoke.last[b1] >= 1 and same_pool(got, want[(q, f)]),
                    f"16c {label} Q{q} {f}: != MultiSetBatchEngine")
            if (q, f) == (64, "cardinality"):
                results64 = got
        for q in (64, 256):
            pool = forms[(q, "cardinality")]
            t_sh = median_ms(torch, lambda: eng.execute(pool))
            t_ms = median_ms(torch, lambda: ms.execute(pool))
            log(f"    16c {label} Q{q} [{card}]: sharded {t_sh:.3f} ms "
                f"against MultiSetBatchEngine {t_ms:.3f} ms (wall to host "
                f"results, medians of 5, warm)")
        if placement == "sharded":
            pool256 = forms[(256, "cardinality")]
            budget = eng.predict_dispatch_bytes(pool256)[
                "per_shard_bytes"] // 4
            pol = guard.GuardPolicy(hbm_budget=budget)
            s0, m0 = eng.proactive_split_count, ms.proactive_split_count
            got = smoke.main_path("16c Q256 under a quarter budget",
                                  lambda: eng.execute(pool256, policy=pol))
            require(same_pool(got, want[(256, "cardinality")]),
                    "16c budget: != MultiSetBatchEngine")
            got_ms = ms.execute(pool256, policy=pol)
            require(same_pool(got_ms, got), "16c budget: single != sharded")
            log(f"    16c Q256 under {budget} bytes (a quarter of its "
                f"per-shard prediction): sharded splits "
                f"{eng.proactive_split_count - s0}, MultiSetBatchEngine at "
                f"the same budget {ms.proactive_split_count - m0}")
            guard.reset_dispatch_stats()
            pool64 = forms[(64, "cardinality")]
            for spec in ("transient@mesh=1.0:3", "lowering@mesh=1.0:4"):
                with faults.inject(spec):
                    got = smoke.main_path(f"16c {spec}",
                                          lambda: eng.execute(pool64))
                require(same_pool(got, results64), f"16c {spec}: != clean")
            st = guard.dispatch_stats(
                "sharded_engine")
            require(st["demotions"] == 2 and st["retries"] >= 1
                    and st["sequential"] == 0,
                    f"16c faults: {st}; want 2 demotions to single, none "
                    f"to the host")
            log(f"    16c faults: transient@mesh and lowering@mesh each "
                f"demoted mesh -> single (the pooled engine's kernels), "
                f"counted {st}; no host landing; results equal")
            plan = eng._plan(tuple(eng._single._flatten(pool64)[0]))
            need = lattice_needs(plan.buckets)
            prof = (f"q={pow2(need[0])},;rows={pow2(need[1])},;"
                    f"keys={pow2(need[2])},;heads=cardinality")
            rt_lattice.deactivate()
            rep = smoke.main_path("16c warmup", lambda: eng.warmup(
                profile=prof))
            esc0 = rt_lattice.escape_total()
            got = smoke.main_path("16c sealed Q64",
                                  lambda: eng.execute(pool64))
            require(same_pool(got, results64)
                    and rt_lattice.escape_total() == esc0 == 0,
                    f"16c sealed: escapes {rt_lattice.escape_total()}")
            require(smoke.last[b1] >= 1, "16c sealed: no B1 in the replay")
            g_ms = median_ms(torch, lambda: eng.execute(pool64))
            rt_lattice.deactivate()
            log(f"    16c warmup({prof!r}): {rep['lattice']['points']} "
                f"points, {rep['graphs']} graphs, {rep['wall_ms']} ms; the "
                f"sealed Q64 pool replays its graph, zero escapes, equal; "
                f"{g_ms:.3f} ms a pool (median of 5)")
        del eng
        torch.cuda.empty_cache()
    # 11b's expression pool on 11b's tenants: one B5 combine launch
    sets_e = [DeviceBitmapSet(sbms[t * per:(t + 1) * per], layout="dense")
              for t in range(n_t)]
    for t in range(4):
        sets_e[t].attach_column(price)
    ems = MultiSetBatchEngine(sets_e, result_cache=None)
    lo, hi = PRICE_MAX // 4, PRICE_MAX // 2

    def expr_pool(q_t):
        return [BatchGroup(t, expr.random_expr_pool(per, q_t, depth=2,
                                                    seed=300 + t)
                           + ([expr.ExprQuery(expr.and_(
                               expr.or_(2 * t, 2 * t + 1),
                               expr.range_("price", lo, hi)), form="bitmap"),
                               expr.ExprQuery(expr.sum_(
                                   "price", found=expr.or_(0, 1)))]
                              if t < 4 else []))
                for t in range(n_t)]

    epool = next(p for p in (expr_pool(q) for q in (4, 2, 1))
                 if ems._plan_pool(ems._flatten(p)[0]).mega.fits())
    ewant = ems.execute(epool)
    for shape, placement in (((4, 1), "sharded"), ((2, 2), "replicated")):
        m = mesh(*shape, names=("rows", "data"))
        eeng = ShardedBatchEngine(sets_e, mesh=m, placement=placement,
                                  result_cache=None)
        got = smoke.main_path(f"16c {shape[0]}x{shape[1]} expression pool",
                              lambda: eeng.execute(epool))
        require(smoke.last[b5] == 1
                and kernels.B5.variants.get("combine", 0) == 1,
                f"16c expressions: B5 {smoke.last[b5]} "
                f"{kernels.B5.variants}; want one combine-mode launch")
        require(same_pool(got, ewant), "16c expressions: != pooled")
        eplan = eeng._plan(tuple(eeng._single._flatten(epool)[0]))
        require(eplan.megas is not None and len(eplan.megas) == 1,
                f"16c expressions: {eplan.megas}; want one stream")
        mega = eplan.megas[0]
        log(f"    16c {shape[0]}x{shape[1]} {placement} expression pool "
            f"[{card}]: {sum(len(g.queries) for g in epool)} queries, one "
            f"B5 combine-mode launch ({mega.n_steps} steps, "
            f"{mega.n_slots} slots, {mega.leaf_rows} leaf rows), B1 "
            f"{smoke.last[b1]}; equal to MultiSetBatchEngine; "
            f"{median_ms(torch, lambda: eeng.execute(epool)):.3f} ms against "
            f"{median_ms(torch, lambda: ems.execute(epool)):.3f} ms")
        if placement == "sharded":
            ops_ = eeng._eager_operands(eplan)
            heads = [eeng._group_body(g.sig, a)[0]
                     for g, a in zip(eplan.op_groups, ops_["g"])]
            bank_a = torch.cat([h for h, gb in zip(heads, mega.group_base)
                                if gb >= 0])
            leaves = eeng._replicated_rows(ops_["leaf"][0])
            m_arrs = ops_["m"][0]
            shapes["megakernel_combine"] = (
                mega, bank_a, torch.cat([leaves, m_arrs["extra"]]),
                m_arrs["cols"])
            # a larger pool whose one combine stream passes B5's capacity:
            # its sections are halved into streams that fit, one
            # combine-mode launch each, with no demotion
            for q_t in (2, 4, 8, 16):
                bpool = expr_pool(q_t)
                bplan = eeng._plan(tuple(eeng._single._flatten(bpool)[0]))
                if bplan.megas is None or len(bplan.megas) > 1:
                    break
            n_m = len(bplan.megas or ())
            require(n_m > 1, f"16c past capacity: {bplan.megas}; want "
                    f"several streams that each fit B5")
            guard.reset_dispatch_stats()
            got = smoke.main_path("16c expression pool past B5's capacity",
                                  lambda: eeng.execute(bpool))
            st = guard.dispatch_stats("sharded_engine")
            require(smoke.last[b5] == n_m
                    and kernels.B5.variants.get("combine", 0) == n_m
                    and st["demotions"] == 0,
                    f"16c past capacity: B5 {smoke.last[b5]} "
                    f"{kernels.B5.variants}, guard {st}; want {n_m} "
                    f"combine-mode launches and no demotion")
            require(same_pool(got, ems.execute(bpool)),
                    "16c past capacity: != MultiSetBatchEngine")
            n_host = 0
            for g, rows in zip(bpool, got):
                for q, r_ in list(zip(g.queries, rows))[::4]:
                    ref = eeng._engines[g.set_id]._sequential_result(q)
                    require(r_.cardinality == ref.cardinality
                            and (q.form != "bitmap" or r_.bitmap
                                 == ref.bitmap),
                            f"16c past capacity: != the host oracle "
                            f"(tenant {g.set_id})")
                    n_host += 1
            log(f"    16c 4x1 sharded expression pool past B5's capacity "
                f"[{card}]: {sum(len(g.queries) for g in bpool)} queries "
                f"({q_t} a tenant); one stream would not fit, so "
                f"{n_m} combine-mode launches of "
                f"{[m.n_steps for m in bplan.megas]} steps, no demotion; "
                f"equal to MultiSetBatchEngine, and {n_host} of them "
                f"(every fourth) to the host oracle")
        del eeng
    del ems, sets_e
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 16e
    import torch.distributed as dist

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                         backend="nccl", timeout=60)
    try:
        gm = multihost.global_mesh(row_axis="rows", lane_axis="data")
        geng = ShardedBatchEngine(sets15, mesh=gm, result_cache=None)
        got = smoke.main_path("16e NCCL world 1 Q64", lambda: geng.execute(
            forms[(64, "cardinality")]))
        require(same_pool(got, results64),
                "16e: the global mesh's Q64 != 16c's")
        sbm = sharding.ShardedBSI(multihost.global_mesh(), hbsi)
        require(sbm.compare_cardinality(Operation.GE, PRICE_MAX // 2)
                == dbsi.compare_cardinality(Operation.GE, PRICE_MAX // 2),
                "16e: ShardedBSI over the NCCL group != DeviceBSI")
        log(f"  16e [{card}]: multihost.initialize at world size 1 on "
            f"{dist.get_backend()}: global_mesh {gm.devices.shape}, the Q64 "
            f"pool equals 16c's, a ShardedBSI compare (its sum an NCCL "
            f"all_reduce) equals DeviceBSI; {multihost.snapshot()}")
        del geng, sbm
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # two gloo ranks on the card (NCCL refuses two ranks on one device)
    store = os.path.join(tempfile.mkdtemp(), "store")
    me = os.path.abspath(__file__)
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, me, "--gloo-rank", str(r), "--gloo-store", store,
         "--gloo-per", str(per), "--seed", str(seed)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=os.path.dirname(me))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    docs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith("GLOO16 ")]
        require(p.returncode == 0 and line,
                f"16e gloo rank {r}: exit {p.returncode}\n{out[-3000:]}")
        docs.append(json.loads(line[0][len("GLOO16 "):]))
    n3 = 3
    want3 = [[r.cardinality for r in rows]
             for g, rows in zip(forms[(64, "cardinality")], results64)
             if g.set_id < n3]
    require(docs[0]["cards"] == docs[1]["cards"] == want3,
            f"16e gloo: the two ranks' pool != the single-process pool: "
            f"{docs[0]['cards']} / {docs[1]['cards']} / {want3}")
    require(all(d["staged_bytes"] > 0 for d in docs),
            f"16e gloo: nothing staged through host memory: {docs}")
    log(f"  16e [{card}]: two gloo ranks on cuda:0 (pod_mesh "
        f"{docs[0]['mesh']}, each holding its own row shard) ran 16c's Q64 "
        f"pool over tenants 0-{n3 - 1} bit-equal to the single-process "
        f"pool; staged through pinned host memory "
        f"{[d['staged_bytes'] for d in docs]} bytes in "
        f"{[d['exchanges'] for d in docs]} exchanges; dispatch "
        f"{[d['ms'] for d in docs]} ms; both ranks up and done in "
        f"{time.perf_counter() - t1:.1f} s")
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        dead = s_.getsockname()[1]
    t1 = time.perf_counter()
    try:
        multihost.initialize(f"127.0.0.1:{dead}", num_processes=2,
                             process_id=1, backend="gloo", timeout=3)
        raised = None
    except errors.CoordinatorTimeout as exc:
        raised = exc
    waited = time.perf_counter() - t1
    require(raised is not None and f"127.0.0.1:{dead}" in str(raised)
            and waited < 10, f"16e: unreachable coordinator {raised!r} "
            f"after {waited:.1f} s")
    log(f"    16e: an unreachable coordinator raised CoordinatorTimeout "
        f"after {waited:.2f} s of its 3 s budget: {str(raised)[:120]}")

    # ----------------------------------------------------------------- 16d
    pod = podmesh.PodMesh.simulate(2, devices=["cuda:0"] * 8)
    t_bytes = podmesh.tenant_bytes_of(sets15)
    big = int(np.argmax(t_bytes))
    hot = int(np.argmin(t_bytes))
    qps = [100.0 if s == hot else 1.0 for s in range(n_t)]
    plan = podmesh.place(sets15, pod, budget_per_host=2 * t_bytes[big] - 2,
                         qps=qps, replicate_max_bytes=1 << 40)
    counts = plan.regime_counts()
    require(set(counts) == {"sharded", "replicated", "local"},
            f"16d: regimes {counts}; want all three")
    log(f"  16d: place over {n_t} tenants ({min(t_bytes)}-{max(t_bytes)} "
        f"bytes) on a simulated 2-host pod of cuda:0 x8, budget "
        f"{2 * t_bytes[big] - 2} a host: {counts}; bytes a host "
        f"{list(plan.bytes_per_host)}")
    columns = [{"v": ds_.columns["v"]} for ds_ in sets15]

    def oracle(sid, q):
        srcs, cols = tenants15[sid], columns[sid]
        if isinstance(q, BatchQuery):
            w = host_query(q, srcs)
            return w.cardinality, None, w
        if expr.is_agg(q.expr):
            return expr.evaluate_host_agg(q.expr, srcs, cols)
        w = expr.evaluate_host(q.expr, srcs, cols)
        return w.cardinality, None, w

    def exact(t) -> bool:
        card_, value, bm = oracle(t.pod_sid, t.query)
        return ((t.result.cardinality, t.result.value) == (card_, value)
                and (t.query.form != "bitmap" or t.result.bitmap == bm))

    fd = PodFrontDoor(sets15, pod=pod, plan=plan,
                      policy=ServingPolicy(pool_target=64))
    events = replay.generate(replay.ReplayProfile(
        **knobs15, delta_share=0.0))[:256]

    def replay_pod():
        t0_ = faults.clock()
        out, rejected = [], 0
        for i, ev in enumerate(events):
            sched = t0_ + ev[1] * 16
            now = faults.clock()
            if sched > now:
                faults.advance_clock(sched - now)
            if i == len(events) // 2:
                fd.fail_host(1)
            try:
                out.append(fd.submit(ev[2], arrival=sched))
            except AdmissionRejected:
                rejected += 1
            fd.pump()
        fd.drain()
        return out, rejected

    tickets, rejected = smoke.main_path("16d pod replay, first 256 at 1/16",
                                        replay_pod)
    done = [t for t in tickets if t.status == "done"]
    untyped = [t for t in tickets if t.status != "done"
               and not isinstance(t.error, errors.RoaringRuntimeError)
               and type(t.error).__name__ not in ("RequestShed",
                                                  "AdmissionRejected")]
    bad = [t for t in done if not exact(t)]
    require(not bad and not untyped and done,
            f"16d: {len(bad)} served tickets != the host oracle, "
            f"{len(untyped)} untyped")
    st = fd.stats
    require(st["host_drops"] == 1
            and st["reroutes"] + st["single_demotions"] > 0,
            f"16d: host loss not taken: {st}")
    hosts_ = {}
    for t in done:
        hosts_[str(t.pod_host)] = hosts_.get(str(t.pod_host), 0) + 1
    log(f"  16d [{card}]: {len(done)} served (each equal to the host "
        f"oracle), {sum(t.status == 'shed' for t in tickets)} shed, "
        f"{rejected} rejected of {len(events)}; served by {hosts_}; "
        f"fail_host(1) at request {len(events) // 2}: {st}, reroutes by "
        f"kind {by_label('rb_pod_reroutes_total', 'to')}; launches "
        f"{ {k: v for k, v in smoke.last.items() if v} }")
    fd.pod.mark_up(1)
    local = [s for s in range(n_t) if plan.regime(s) == "local"]
    sid = local[0]
    src = fd.owner_host(sid)
    dst = 1 - src

    def ask(q=BatchQuery("or", (0, 1, 2))):
        from roaringbitmap_tpu_torch.serving import ServingRequest

        t = fd.submit(ServingRequest(sid, q, tenant="mig"))
        fd.drain()
        require(t.status == "done", f"16d migration ask: {t.status}")
        return t.result.cardinality

    before = ask()
    key0 = int(tenants15[sid][0].keys[0]) << 16
    added = [int(v) for v in np.setdiff1d(
        np.arange(key0, key0 + 4096, dtype=np.uint32),
        tenants15[sid][0].to_array())[:2]]

    def during(fd_):
        fd_.apply_delta(sid, adds={0: added})
        require(ask() == before + 2, "16d: dual-write window lost a delta")

    rep = smoke.main_path("16d migrate_tenant", lambda: migrate_tenant(
        fd, sid, dst, during=during))
    require(fd.owner_host(sid) == dst and ask() == before + 2
            and rep["catch_up_records"] >= 1,
            f"16d migration: {rep}")
    j = smoke.main_path("16d host_join", lambda: host_join(
        fd, devices=["cuda:0"] * 4))
    require(ask() == before + 2, "16d: host_join changed the bits")
    lv = smoke.main_path("16d host_leave", lambda: host_leave(
        fd, j["host"]))
    require(ask() == before + 2, "16d: host_leave changed the bits")
    log(f"    16d: tenant {sid} migrated {src} -> {dst} with a delta in "
        f"flight ({rep['bytes']} bytes, {rep['catch_up_records']} catch-up "
        f"records, blip {rep['blip_ms']} ms), bits kept; host_join added "
        f"host {j['host']} (plan changed {j['changed']}, moved "
        f"{j['moved']}), host_leave drained it (moved {lv['moved']})")
    # over the wire: a bootstrap --frontdoor 2 child on the card
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "roaringbitmap_tpu_torch.wire.bootstrap",
         "--device", "cuda", "--frontdoor", "2", "--seed", str(seed)],
        cwd=here, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)
    try:
        info = json.loads(proc.stdout.readline())
        cl = WireClient((info["host"], info["port"]), timeout=300)
        wsid = local[-1]
        wrep = smoke.main_path("16d migrate_tenant_wire", lambda: (
            wmig.migrate_tenant_wire(fd, wsid, cl, tenant="16d")))
        cl.close()
        require(wrep["source_crcs"] == wmig.source_crcs(fd._sets[wsid]),
                "16d wire: CRCs differ")
        proc.stdin.close()
        require(proc.wait(timeout=60) == 0, "16d wire child: exit != 0")
        require(info["device"].startswith("cuda"),
                f"16d wire child on {info['device']}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log(f"    16d wire: a bootstrap --frontdoor 2 --device cuda child "
        f"received tenant {wsid} ({wrep['bytes']} bytes) and committed it "
        f"with its {len(wrep['source_crcs'])} source CRCs equal")
    del fd
    torch.cuda.empty_cache()


def phase17(smoke, seed: int, shapes: dict, union, adhoc, ds, bms256, eng,
            flat, sds, seng, epool, xsds, xpool, tenants11, state12) -> None:
    """The engine leftovers of ROADMAP A2-A8 on the card: 17a the flagship
    model on B1, 17b ``DeviceBitmapSet.evaluate`` (one B5 launch a query),
    17c ``BatchEngine.chained_cardinality``, 17d the "torch-vmap" rung by
    name, 17e ``execute_node_at_a_time`` beside the fused B5 batch, 17g
    ``explain`` / ``explain_wide`` and ``hbm_bytes``, then 17f phase 12's
    patches replayed through warmed "delta:N" graphs and a repack that drops
    them (17f last: it moves the set's version and replaces its image)."""
    import torch

    from roaringbitmap_tpu_torch import DeviceBitmapSet, aggregation
    from roaringbitmap_tpu_torch.models import flagship
    from roaringbitmap_tpu_torch.mutation import delta as mut_delta
    from roaringbitmap_tpu_torch.ops import kernels, packing
    from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import (
        ENGINES, BatchEngine, BatchQuery, random_query_pool,
        resolve_query_engine)
    from roaringbitmap_tpu_torch.parallel.multiset import (
        BatchGroup, MultiSetBatchEngine)
    from roaringbitmap_tpu_torch.runtime import guard

    b1, b3, b5 = (kernels.B1.name, kernels.B3.name, kernels.B5.name)

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def peak_of(fn) -> int:
        """Device bytes ``fn`` allocates at its peak above what was live."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    # 17a: the flagship model over phase 5's 1,024 bitmaps, on B1
    pk = shapes["segmented_reduce"]
    w, sg, hd = (as_i32(a, "cuda") for a in (pk.words, pk.seg_ids,
                                             pk.head_idx))
    words, cards = smoke.main_path("17a flagship forward",
                                   lambda: flagship.forward(w, sg, hd))
    require(smoke.last[b1] == 1 and sum(smoke.last.values()) == 1,
            f"17a: launches {smoke.last}; want one B1")
    pw, pc = kernels.segmented_reduce_plain("or", w, sg, pk.num_keys)
    require(torch.equal(words, pw) and torch.equal(cards, pc),
            "17a: flagship forward != B1's plain version")
    require(packing.unpack_result(pk.keys, to_u32(words),
                                  cards.cpu().numpy()) == union,
            "17a: flagship forward != aggregation.or_")
    f_ms = timed_ms(torch, lambda: flagship.forward(w, sg, hd), 20)
    log(f"  17a: forward over {len(adhoc)} bitmaps ({pk.m} rows, K "
        f"{pk.num_keys}): one B1 launch, equal to B1's plain version and "
        f"to or_ (cardinality {union.cardinality}); {f_ms:.4f} ms (CUDA "
        f"events, median of 20)")
    del w, sg, hd, words, cards, pw, pc

    # 17b: evaluate over 7b's shard, every 7b expression in both forms.
    # A query with a fused section is one B5 launch; one whose canonical
    # DAG is a single reduce has none, and runs one B1 a bucket
    def launches_of(set_, pool):
        planner = BatchEngine(set_)
        n5 = n1 = 0
        for q in pool:
            plan = planner.plan([q])
            if plan.fused and plan.mega.fits():
                n5 += 1
            else:
                n1 += len(plan)
        return n5, n1

    want = seng.execute(epool)
    n5, n1 = launches_of(sds, epool)

    def evaluate_all():
        return [(sds.evaluate(q), sds.evaluate(q, form="cardinality"))
                for q in epool]

    got = smoke.main_path(f"17b evaluate x{2 * len(epool)}", evaluate_all)
    require(smoke.last[b5] == 2 * n5 and smoke.last[b1] == 2 * n1,
            f"17b: launches {smoke.last}; want B5 {2 * n5}, B1 {2 * n1}")
    for (bm, card), w_ in zip(got, want):
        require(bm == w_.bitmap and card == w_.cardinality,
                "17b: evaluate != BatchEngine.execute")
    hits0 = sds._expr_engine._plans.stats()["hits"]
    _, ev_ms = sync_ms(evaluate_all)
    hits = sds._expr_engine._plans.stats()["hits"] - hits0
    require(hits == 2 * len(epool), f"17b: {hits} plan-cache hits on repeat")
    log(f"  17b: {len(epool)} expressions x 2 forms through evaluate: one "
        f"B5 launch each for the {n5} with a fused section (the other "
        f"{len(epool) - n5} are one reduce: {n1} B1 launches a form), equal "
        f"to BatchEngine.execute; on repeat "
        f"{hits} plan-cache hits, {ev_ms / (2 * len(epool)):.3f} ms a call "
        f"(host clock, warm)")
    xwant = BatchEngine(xsds).execute(xpool, engine="cuda")
    x5, x1 = launches_of(xsds, xpool)
    got = smoke.main_path(f"17b compact evaluate x{len(xpool)}",
                          lambda: [xsds.evaluate(q) for q in xpool])
    require(smoke.last[b5] == x5 and smoke.last[b1] == x1
            and smoke.last[b3] == len(xpool)
            and all(g == w_.bitmap for g, w_ in zip(got, xwant)),
            f"17b compact: launches {smoke.last} (want B5 {x5}, B1 {x1}, "
            f"B3 {len(xpool)}), or != execute")
    log(f"  17b: 7b's compact set: {len(xpool)} evaluate calls, B3 each and "
        f"B5 {x5} / B1 {x1}, equal to execute on the cuda rung")

    # 17c: the chained flat-batch probe over 7a's batch
    want7a = eng.execute(flat)
    total = sum(r.cardinality for r in want7a)
    n_buckets = len(eng.plan(flat))
    probe = eng.chained_cardinality(flat, 8)
    got = smoke.main_path("17c chained_cardinality x8", probe)
    require(int(got) == (8 * total) % (1 << 32)
            and smoke.last[b1] == 8 * n_buckets,
            f"17c: total {int(got)} (want {(8 * total) % (1 << 32)}), B1 "
            f"{smoke.last[b1]} (want {8 * n_buckets})")
    rep_ms = median_ms(torch, probe) / 8
    one_ms = median_ms(torch, lambda: eng.execute(flat))
    log(f"  17c: 8 reps of the Q {len(flat)} batch ({n_buckets} buckets, "
        f"one B1 each): total == 8 x {total} mod 2^32; {rep_ms:.3f} ms a "
        f"rep on the device loop beside {one_ms:.3f} ms for one execute "
        f"(host clock to a synchronize, medians of 5)")
    xeng = BatchEngine(xsds)
    xflat = random_query_pool(xsds.n, 16, seed=seed + 17)
    xtotal = sum(r.cardinality for r in xeng.execute(xflat))
    xb = len(xeng.plan(xflat))
    got = smoke.main_path("17c compact chained_cardinality x8",
                          xeng.chained_cardinality(xflat, 8))
    require(int(got) == (8 * xtotal) % (1 << 32)
            and smoke.last[b3] == 8 and smoke.last[b1] == 8 * xb,
            f"17c compact: total {int(got)}, launches {smoke.last}")
    log(f"  17c: on 7b's compact set, 8 reps of a Q 16 batch: B3 once and "
        f"B1 {xb} times a rep, total == 8 x {xtotal} mod 2^32")
    del xeng

    # 17d: the per-query cross-check rung, asked for by name
    stats0 = guard.dispatch_stats("batch_engine")
    mstats0 = guard.dispatch_stats("multiset")
    got = smoke.main_path("17d torch-vmap 7a",
                          lambda: eng.execute(flat, engine="torch-vmap"))
    require(eng.last_timings["engine"] == "torch-vmap"
            and not any(smoke.last.values())
            and same_results(got, want7a),
            "17d: torch-vmap on 7a's batch != the cuda rung")
    ms11 = MultiSetBatchEngine(tenants11[0])
    pool11 = [BatchGroup(g.set_id, [BatchQuery(q.op, q.operands,
                                               form="bitmap")
                                    for q in g.queries])
              for g in tenants11[2]]
    want11 = ms11.execute(pool11)
    got = smoke.main_path("17d torch-vmap 11a Q64",
                          lambda: ms11.execute(pool11, engine="torch-vmap"))
    require(smoke.last[b1] == 0 and len(got) == len(want11)
            and all(same_results(g, w_) for g, w_ in zip(got, want11)),
            "17d: torch-vmap on 11a's pool != pooled cuda")
    chain = guard.chain_from(resolve_query_engine("auto", epool, "cuda"),
                             ENGINES, "cuda")
    require(chain == ("megakernel", "cuda")
            and guard.dispatch_stats("batch_engine") == stats0
            and guard.dispatch_stats("multiset") == mstats0,
            f"17d: chain {chain}, or a demotion on the clean runs")
    log(f"  17d: torch-vmap (explicit) over 7a's batch and 11a's Q 64 pool "
        f"bit-equal to cuda; the card's chain {' -> '.join(chain)}, zero "
        f"demotions")

    # 17e: node at a time against the fused B5 batch (7b's expressions)
    e32 = epool[:-2]
    fused = smoke.main_path(f"17e fused x{len(e32)}",
                            lambda: seng.execute(e32))
    require(smoke.last[b5] == 1, f"17e fused: launches {smoke.last}")
    fused_ms = median_ms(torch, lambda: seng.execute(e32))
    nodes = smoke.main_path(f"17e node at a time x{len(e32)}",
                            lambda: expr.execute_node_at_a_time(seng, e32))
    n_b1 = smoke.last[b1]
    require(smoke.last[b5] == 0 and n_b1 > 0
            and same_results(nodes, fused),
            "17e: node at a time != the fused batch")
    node_ms = median_ms(torch, lambda: expr.execute_node_at_a_time(seng,
                                                                   e32), 3)
    log(f"  17e: {len(e32)} expressions node at a time ({n_b1} B1 "
        f"launches, host combines) equal the fused batch (one B5); wall "
        f"{node_ms:.3f} ms against {fused_ms:.3f} ms fused (host clock, "
        f"medians, warm)")

    # 17g: explain and explain_wide, predicted beside the measured peak
    ms_eng = MultiSetBatchEngine(tenants11[0])
    require(eng.hbm_bytes() == ds.hbm_bytes()
            and seng.hbm_bytes() == sds.hbm_bytes()
            and ms_eng.hbm_bytes() == sum(s.hbm_bytes()
                                          for s in tenants11[0]),
            "17g: an engine's hbm_bytes != the sum of its sets'")
    for label, ex, run, chain_want in (
            ("7a", eng.explain(flat), lambda: eng.execute(flat), ["cuda"]),
            ("7b", seng.explain(epool), lambda: seng.execute(epool),
             ["megakernel", "cuda"]),
            ("or_ 1024", aggregation.explain_wide("or", adhoc),
             lambda: aggregation.or_(adhoc), ["cuda"])):
        require(ex["engine_chain"] == chain_want,
                f"17g {label}: chain {ex['engine_chain']}")
        pred = (ex["predicted"]["peak_bytes"] if "predicted" in ex
                else ex["predicted_hbm_bytes"])
        peak = peak_of(run)
        extra = ("" if "predicted" not in ex else
                 f"; {len(ex['buckets'])} buckets, plan cache hit "
                 f"{ex['plan_cache_hit']}, program cache hit "
                 f"{ex['program_cache_hit']}, host pairwise ops "
                 f"{ex['sequential_floor']['host_pairwise_ops']}, est "
                 f"device {ex['cost']['est_device_total_ms']} ms")
        log(f"  17g {label}: engine {ex['engine']}, chain "
            f"{ex['engine_chain']}; predicted {pred} bytes beside a "
            f"measured peak of {peak} ({peak / max(1, pred):.2f}x); budget "
            f"{ex['hbm_budget_bytes']}{extra}")
    log(f"  17g: hbm_bytes of the batch engines and of the pooled engine "
        f"over 11a's tenants ({ms_eng.hbm_bytes()}) equal their sets' sums")
    del ms_eng, ms11

    # 17f: phase 12's 64 patches replayed through warmed delta:N graphs.
    # A value's fate is set by the last delta that names it, so the
    # replayed sequence must leave the image as the eager patches left it.
    # As in 12a no host twin rides along (advancing one is host work of its
    # own); the twin is held on a set of 256 below
    deltas = state12["deltas"]
    before = ds.words.clone()
    ds._host_cache = None
    rep = smoke.main_path("17f warmup_delta(64)", lambda: ds.warmup_delta(64))
    progs = list(ds._delta_programs.values())
    require(rep["compiled"] and rep["rungs"] == [1, 2, 4, 8, 16, 32, 64]
            and len(progs) == 7 and all(p.graph is not None for p in progs),
            f"17f: warmup {rep}")
    graph_ms, plan_ms = [], []

    def replay(set_, stream, times=None, plans=None):
        for adds, removes in stream:
            if plans is not None:
                t1 = time.perf_counter()
                mut_delta.plan_patch(
                    set_, mut_delta._normalize_delta(set_.n, adds),
                    mut_delta._normalize_delta(set_.n, removes))
                plans.append((time.perf_counter() - t1) * 1e3)
            r, ms = sync_ms(lambda: set_.apply_delta(adds=adds,
                                                     removes=removes))
            require(r["mode"] == "patch", f"17f: {r}")
            if times is not None:
                times.append(ms)

    smoke.main_path("17f 64 patches through graphs",
                    lambda: replay(ds, deltas, graph_ms, plan_ms))
    require(torch.equal(ds.words, before),
            "17f: the graph-patched image != the eager patches'")
    del before
    eager_ms, eager_plan = state12["patch_ms"], state12["plan_ms"]
    log(f"  17f: warmup_delta(64) captured {len(progs)} graphs (rungs "
        f"{rep['rungs']}); 12a's 64 deltas replayed through them leave the "
        f"image as the eager patches did; patch median "
        f"{np.median(graph_ms):.3f} ms (graph; min {min(graph_ms):.3f}, max "
        f"{max(graph_ms):.3f}) against {np.median(eager_ms):.3f} ms (12a, "
        f"eager), of which host planning {np.median(plan_ms):.3f} / "
        f"{np.median(eager_plan):.3f} ms (host clock to a synchronize)")
    # the host twin and the repack, on two sets of phase 2's first 256
    # bitmaps (one warmed), each with its twin; 12a-shaped deltas over their
    # keys (a repack of phase 2's whole set first rebuilds the host twin
    # of all 4,096 sources, which the run has no time for)
    warm = DeviceBitmapSet(bms256, layout="dense")
    cold = DeviceBitmapSet(bms256, layout="dense")
    rng = np.random.default_rng(seed + 17)
    live = np.flatnonzero(warm.row_src >= 0)
    stream = []
    hosts = [b.clone() for b in bms256]
    for _ in range(16):
        rows = rng.choice(live, int(rng.integers(1, 33)), replace=False)
        adds, removes = {}, {}
        for r in rows:
            src = int(warm.row_src[r])
            base = np.uint32(int(warm.keys[warm.row_seg[r]])) << np.uint32(16)
            adds.setdefault(src, []).extend(
                (base | rng.integers(0, 1 << 16, 50).astype(np.uint32)).tolist())
            cur = hosts[src].to_array()
            cur = cur[(cur >> np.uint32(16)) == (base >> np.uint32(16))]
            removes.setdefault(src, []).extend(
                rng.choice(cur, min(50, cur.size), replace=False).tolist())
        stream.append((adds, removes))
    twins = [s.host_bitmaps() for s in (warm, cold)]
    warm.warmup_delta(32)
    smoke.main_path("17f 16 patches through graphs, twin riding",
                    lambda: replay(warm, stream))
    replay(cold, stream)
    t_w, t_c = warm.host_bitmaps(), cold.host_bitmaps()
    require(torch.equal(warm.words, cold.words)
            and warm._host_cache[0] == warm.version
            and twins[0] is not t_w
            and all(a.serialize() == b.serialize() for a, b in zip(t_w, t_c)),
            "17f: image or host twin after graph patches != the eager ones")
    # a repack replaces the image: the set's graphs go before it is freed
    _, r_ms = sync_ms(lambda: mut_delta.repack_in_place(warm))
    require(warm._delta_programs == {} and warm._delta_pool is None,
            "17f: the repack kept its graphs")
    adds, removes = stream[-1]
    warm.apply_delta(adds=adds, removes=removes)
    cold.apply_delta(adds=adds, removes=removes)
    require(all(a.serialize() == b.serialize() for a, b in
                zip(warm.host_bitmaps(), cold.host_bitmaps())),
            "17f: a cold patch after the repack is not exact")
    log(f"  17f: on 2's first 256 bitmaps, 16 deltas through graphs with "
        f"the host twin riding: image and twin equal the eager set's; a "
        f"repack ({r_ms:.0f} ms) dropped the graphs and their pool; a cold "
        f"patch afterwards is exact")


def phase18(smoke, bms, abms, union, sbms, price, ts, batches, epool,
            lift) -> None:
    """The rest of the host tier on the card: phase 2's 4,096 bitmaps and
    phase 5's 1,024 (and AND inputs) serialized once and wrapped as
    ``ImmutableRoaringBitmap``s over one memoryview each.  18a the wide ops
    over 1,024 immutables, 18b resident sets of the 4,096 in the dense,
    compact and counts layouts (and the "auto" choice), 18c 7b's expression
    batch over a set of immutables (and an immutable ad-hoc leaf), 18d 9a's
    value batches over an ``ImmutableBitSliceIndex`` "price" and a mapped
    ``RangeBitmap`` "ts", 18e 10a's lifted bitmaps as
    ``Roaring64NavigableMap``s through ``or64`` / ``and64``, 18f
    writer-built bitmaps and ``RoaringBitSet``s through ``or_``.  Each arm
    is bit-equal to its heap-source twin, run beside it, and B1-B5 must
    each launch in the phase."""
    from roaringbitmap_tpu_torch import DeviceBitmapSet, aggregation
    from roaringbitmap_tpu_torch.analytics import BsiColumn, RangeColumn
    from roaringbitmap_tpu_torch.bsi import ImmutableBitSliceIndex
    from roaringbitmap_tpu_torch.buffer import ImmutableRoaringBitmap
    from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64NavigableMap
    from roaringbitmap_tpu_torch.core.bitset import RoaringBitSet
    from roaringbitmap_tpu_torch.core.rangebitmap import RangeBitmap
    from roaringbitmap_tpu_torch.core.writer import RoaringBitmapWriter
    from roaringbitmap_tpu_torch.insights import choose_layout
    from roaringbitmap_tpu_torch.ops import kernels, packing
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine

    launched = {k.name: 0 for k in kernels.KERNELS}

    def run(label, fn):
        """A main-path call, timed; its launches count for the phase."""
        t0 = time.perf_counter()
        out = smoke.main_path(label, fn)
        ms = (time.perf_counter() - t0) * 1e3
        for name, c in smoke.last.items():
            launched[name] += c
        return out, ms

    def twin(label, im_fn, heap_fn, same, kinds=("immutable", "heap")):
        """An arm and its heap-source twin, each through the user entry
        point; returns (the arm's result, the twin's)."""
        got, im_ms = run(f"18 {label} ({kinds[0]})", im_fn)
        want, heap_ms = run(f"18 {label} ({kinds[1]})", heap_fn)
        require(same(got, want), f"18 {label}: {kinds[0]} != {kinds[1]}")
        log(f"    {label}: {kinds[0]} {im_ms:.1f} ms, {kinds[1]} "
            f"{heap_ms:.1f} ms (host clock to a synchronize), bit-equal")
        return got, want

    eq = lambda a, b: a == b     # noqa: E731

    def wrap(src):
        blobs = [b.serialize() for b in src]
        return [ImmutableRoaringBitmap(memoryview(b)) for b in blobs], \
            sum(map(len, blobs))

    t0 = time.perf_counter()
    ims, nbytes = wrap(bms)
    iabms, _ = wrap(abms)
    m = len(abms)
    adhoc, iadhoc = bms[:m], ims[:m]
    log(f"  {len(bms)} + {m} bitmaps serialized ({nbytes} + "
        f"{sum(b.serialized_size_in_bytes() for b in iabms)} bytes) and "
        f"wrapped in {time.perf_counter() - t0:.1f} s")

    # 18a: the wide ops over phase 5's 1,024 as immutables
    log(f"  18a: wide ops over {m} immutables")
    for name, fn, a, b in (("or_", aggregation.or_, iadhoc, adhoc),
                           ("xor", aggregation.xor, iadhoc, adhoc),
                           ("and_", aggregation.and_, iabms, abms)):
        got, _ = twin(name, lambda fn=fn, a=a: fn(a),
                      lambda fn=fn, b=b: fn(b), eq)
        if name == "or_":
            require(got == union, "18a or_ != phase 5's or_")
    twin("or_cardinality", lambda: aggregation.or_cardinality(iadhoc),
         lambda: aggregation.or_cardinality(adhoc), eq)
    require(launched[kernels.B1.name] > 0 and launched[kernels.B2.name] > 0,
            f"18a: launches {launched}")

    # 18b: resident sets of the 4,096 immutables in every layout
    t0 = time.perf_counter()
    auto_im = choose_layout([packing._as_view(b) for b in ims])["layout"]
    auto_heap = choose_layout(bms)["layout"]
    require(auto_im == auto_heap, f"18b: auto chose {auto_im} over "
            f"immutables, {auto_heap} over the heap bitmaps")
    log(f"  18b: layout 'auto' chooses {auto_im} over both sources "
        f"({time.perf_counter() - t0:.1f} s)")
    for layout in ("dense", "compact", "counts"):
        ops = ("or", "xor") if layout == "counts" else ("or", "xor", "and")
        ids, hds = twin(f"{layout} build of {len(bms)}",
                        lambda layout=layout: DeviceBitmapSet(ims,
                                                              layout=layout),
                        lambda layout=layout: DeviceBitmapSet(bms,
                                                              layout=layout),
                        lambda a, b: a.layout == b.layout
                        and a.hbm_bytes() == b.hbm_bytes()
                        and np.array_equal(a.row_src, b.row_src))
        for op in ops:
            twin(f"{layout} {op}", lambda op=op: ids.aggregate(op),
                 lambda op=op: hds.aggregate(op), eq)
        if layout == "counts":
            auto_counts_path = ids.reduce_path
        del ids, hds
        smoke.torch.cuda.empty_cache()
    for k in (kernels.B2, kernels.B3, kernels.B4 if auto_counts_path
              == "counts" else kernels.B7):
        require(launched[k.name] > 0, f"18b: {k.name} did not launch")

    # 18c: 7b's expression batch over a set of the shard's immutables
    isbms, _ = wrap(sbms)
    isds, hsds = twin("shard build", lambda: DeviceBitmapSet(
        isbms, layout="dense"), lambda: DeviceBitmapSet(sbms, layout="dense"),
        lambda a, b: np.array_equal(a.row_src, b.row_src))
    ieng, heng = BatchEngine(isds), BatchEngine(hsds)
    before = launched[kernels.B5.name]
    twin(f"expr x{len(epool)}", lambda: ieng.execute(epool),
         lambda: heng.execute(epool), same_results)
    require(ieng.last_timings["engine"] == "megakernel"
            and launched[kernels.B5.name] == before + 2,
            "18c: the batch did not run as one B5 launch each")
    leaf = [expr.ExprQuery(expr.and_(expr.or_(0, 1), expr.AdHoc(isbms[7])),
                           form="bitmap")]
    got, _ = twin("expr with an immutable ad-hoc leaf",
                  lambda: ieng.execute(leaf), lambda: heng.execute(
                      [expr.ExprQuery(expr.and_(expr.or_(0, 1),
                                                expr.AdHoc(sbms[7])),
                                      form="bitmap")]), same_results)
    require(got[0].bitmap == (sbms[0] | sbms[1]) & sbms[7],
            "18c: the ad-hoc leaf query != the host")

    # 18d: 9a's value batches over mapped columns
    t0 = time.perf_counter()
    blob_p = price.host.serialize_buffer()
    blob_t = ts.host.serialize()
    t1 = time.perf_counter()
    iprice = BsiColumn.from_bsi("price", ImmutableBitSliceIndex(
        memoryview(blob_p)))
    its = RangeColumn.from_range_bitmap("ts", RangeBitmap.map(
        memoryview(blob_t)))
    t2 = time.perf_counter()
    require(np.array_equal(its.values, ts.values)
            and np.array_equal(iprice.slices_np, price.slices_np)
            and np.array_equal(its.slices_np, ts.slices_np),
            "18d: a mapped column's planes or values != the heap column's")
    log(f"  18d: price serialized ({len(blob_p)} bytes) and ts "
        f"({len(blob_t)} bytes) in {(t1 - t0) * 1e3:.0f} ms; the mapped "
        f"columns built in {(t2 - t1) * 1e3:.0f} ms")
    for c in (iprice, its):
        isds.attach_column(c)
    for c in (price, ts):
        hsds.attach_column(c)
    for bi, (batch, _) in enumerate(batches):
        before = launched[kernels.B5.name]
        twin(f"value batch {bi} x{len(batch)}",
             lambda batch=batch: ieng.execute(batch),
             lambda batch=batch: heng.execute(batch), same_results)
        require(launched[kernels.B5.name] == before + 2,
                f"18d value batch {bi}: not one B5 launch each")
    del isds, hsds, ieng, heng

    # 18e: 10a's lifted bitmaps as navigable maps
    l64 = lift(adhoc)
    a64 = lift(abms, bucket=2**31)
    t0 = time.perf_counter()
    nms = [Roaring64NavigableMap.from_roaring64(b) for b in l64]
    anms = [Roaring64NavigableMap.from_roaring64(b) for b in a64]
    log(f"  18e: {len(nms) + len(anms)} Roaring64NavigableMaps built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, a, b in (("or64", nms, l64), ("and64", anms, a64)):
        fn = getattr(aggregation, name)
        got, want = twin(name, lambda fn=fn, a=a: fn(a),
                         lambda fn=fn, b=b: fn(b), eq,
                         ("navigable maps", "Roaring64Bitmaps"))
        require(got.serialize() == want.serialize() and got.cardinality,
                f"18e {name}: bytes differ")

    # 18f: writer-built bitmaps and RoaringBitSets through or_ (the writer
    # rebuilds the first 256 only: all 1,024 take over 10 s on the host)
    t0 = time.perf_counter()
    built = []
    for b in adhoc[:256]:
        w = RoaringBitmapWriter.wizard().optimise_for_runs().get()
        w.add_many(b.to_array())
        built.append(w.get())
    log(f"  18f: {len(built)} bitmaps written in "
        f"{time.perf_counter() - t0:.1f} s")
    twin("or_", lambda: aggregation.or_(built),
         lambda: aggregation.or_(adhoc[:256]), eq, ("writer-built", "heap"))
    sets = [RoaringBitSet(b) for b in adhoc]
    got, _ = twin("or_", lambda: aggregation.or_(sets),
                  lambda: aggregation.or_(adhoc), eq, ("RoaringBitSets",
                                                       "heap"))
    require(got == union, "18f: != phase 5's or_")

    for k in (kernels.B1, kernels.B2, kernels.B3, kernels.B5):
        require(launched[k.name] > 0, f"phase 18: {k.name} did not launch")
    log(f"  phase 18 launches: " + ", ".join(
        f"{n}={c}" for n, c in launched.items() if c))


def gloo_child(rank: int, store: str, seed: int, per: int) -> int:
    """One of phase 16e's two gloo ranks on the card: phase 2's first
    3 x ``per`` bitmaps (the same seed) as tenants 0-2 of ``per``, a
    pod-spanning sharded engine over both ranks (each holds its own row
    shard), 16c's Q64 pool on those tenants; prints ``GLOO16 <json>``."""
    import torch

    from roaringbitmap_tpu_torch import DeviceBitmapSet
    from roaringbitmap_tpu_torch.parallel import (BatchGroup,
                                                  MultiSetBatchEngine,
                                                  ShardedBatchEngine,
                                                  multihost, podmesh)
    from roaringbitmap_tpu_torch.parallel.multiset import random_multiset_pool
    from roaringbitmap_tpu_torch.utils.datasets import synthetic_bitmaps

    multihost.initialize("file://" + store, num_processes=2,
                         process_id=rank, backend="gloo", timeout=300)
    bms = synthetic_bitmaps(3 * per, seed=seed, universe=1 << 24,
                            density=0.0025)
    sets = [DeviceBitmapSet(bms[t * per:(t + 1) * per], layout="dense")
            for t in range(3)]
    pool = [g for g in random_multiset_pool([per] * 16, 64, seed=0xACE,
                                            max_operands=8)
            if g.set_id < 3]
    pod = podmesh.PodMesh.detect(devices=["cuda:0"])
    mesh = pod.pod_mesh()
    eng = ShardedBatchEngine(sets, mesh=mesh, placement="sharded",
                             result_cache=None)
    got = eng.execute(pool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng.execute(pool)
    ms_ = (time.perf_counter() - t0) * 1e3
    ref = MultiSetBatchEngine(sets, result_cache=None).execute(pool)
    require(all(same_results(a, b) for a, b in zip(got, ref)),
            f"gloo rank {rank}: sharded != single-process pooled")
    torch.distributed.barrier()
    print("GLOO16 " + json.dumps({
        "rank": rank, "cards": [[r.cardinality for r in rows]
                                for rows in got],
        "staged_bytes": mesh.comm.staged_bytes,
        "exchanges": mesh.comm.exchanges, "ms": round(ms_, 3),
        "mesh": list(mesh.devices.shape)}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def host_delta(hosts, adds, removes) -> list:
    """A delta applied to host bitmaps in the ``apply_delta`` order (adds,
    then removes)."""
    from roaringbitmap_tpu_torch import RoaringBitmap

    out = list(hosts)
    for src, vals in (adds or {}).items():
        out[src] = out[src] | RoaringBitmap.from_values(
            np.unique(np.asarray(vals, np.uint32)))
    for src, vals in (removes or {}).items():
        out[src] = out[src] - RoaringBitmap.from_values(
            np.unique(np.asarray(vals, np.uint32)))
    return out


def recorded(client) -> list:
    """The tickets of every ``client.submit`` from now on (the replay arms
    keep theirs to themselves); ``del client.submit`` stops recording."""
    got: list = []
    submit = client.submit

    def rec(req):
        t = submit(req)
        got.append(t)
        return t

    client.submit = rec
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bitmaps", type=int, default=4096,
                    help="bitmaps of the dense set (phase 2); the counts set "
                         "(phase 3) holds twice as many")
    ap.add_argument("--gloo-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--gloo-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-per", type=int, default=256,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.gloo_rank is not None:
        # one of phase 16e's two gloo ranks (the script starts them itself)
        return gloo_child(args.gloo_rank, args.gloo_store, args.seed,
                          args.gloo_per)

    from roaringbitmap_tpu_torch import (DeviceBitmap, DeviceBitmapSet,
                                         DevicePairSet, RoaringBitmap,
                                         aggregation, native, obs)
    from roaringbitmap_tpu_torch.analytics import (BsiColumn, RangeColumn,
                                                   two_phase_execute)
    from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap
    from roaringbitmap_tpu_torch.runtime import errors, faults, guard
    from roaringbitmap_tpu_torch.bsi import (DeviceBSI, DeviceRangeBitmap,
                                             Operation,
                                             RoaringBitmapSliceIndex)
    from roaringbitmap_tpu_torch.ops import (build, dense, kernels, megakernel,
                                             packing)
    from roaringbitmap_tpu_torch.ops.words import WORDS32, as_i32, to_u32
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import (
        BatchEngine, BatchQuery, random_query_pool)
    from roaringbitmap_tpu_torch.utils.datasets import (synthetic_bitmaps,
                                                        uscensus_like_values)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)

    t_all = time.perf_counter()

    def unpack(keys, words, cards):
        return packing.unpack_result(keys, to_u32(words), cards.cpu().numpy())

    # ------------------------------------------------------------ phase 1
    log("phase 1: build")
    t_phase = t0 = time.perf_counter()
    reports = build.build()
    log(f"  built {len(reports)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")
    for src, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    for entry, used in ptxas_entries(reports.get("segmented_reduce.cu", "")):
        m_op = re.search(r"chunk_reduce_kernelILi(\d)ELi(\d+)E", entry)
        if m_op:
            log(f"  B1 chunk_reduce_kernel<op {m_op.group(1)}, "
                f"{m_op.group(2)} columns>: {used}")
    smoke = Smoke(torch, kernels)
    guard.reset_dispatch_stats()
    shapes = {}
    phase_time("phase 1", t_phase)

    # ------------------------------------------------------------ phase 2
    n = args.bitmaps
    log(f"phase 2: dense set, {n} bitmaps")
    t_phase = t0 = time.perf_counter()
    bms = synthetic_bitmaps(n, seed=args.seed, universe=1 << 24,
                            density=0.0025)
    log(f"  generated in {time.perf_counter() - t0:.1f} s")
    ds = smoke.main_path("dense build",
                         lambda: DeviceBitmapSet(bms, layout="dense"))
    log(f"  rows {ds.words.shape[0]}, bytes {ds.hbm_bytes()}, "
        f"block {ds.block}, K {ds.keys.size}")
    dense_times = check_set(smoke, "dense", ds, ("or", "xor", "and"), unpack)
    require(ds.reduce_path == "streams",
            f"dense set recorded {ds.reduce_path}, not streams (B7)")
    smoke.main_path("dense xor", lambda: ds.aggregate_device("xor"))
    require(smoke.last[kernels.B7.name] == 1 and smoke.last[kernels.B2.name]
            == 0, f"dense xor: launches {smoke.last}, not one B7")
    shapes["segmented_reduce_blocked"] = (ds.words, ds.blk_seg,
                                          ds.keys.size, ds.block)
    sub = bms[:HOST_CHECK_N]
    t0 = time.perf_counter()
    host = {op: host_fold(op, sub) for op in ("or", "xor", "and")}
    log(f"  host folds of {len(sub)} bitmaps in "
        f"{time.perf_counter() - t0:.1f} s")
    ds_sub = DeviceBitmapSet(sub, layout="dense")
    for op in ("or", "xor", "and"):
        got = smoke.main_path(f"dense[{len(sub)}] {op}",
                              lambda op=op: ds_sub.aggregate(op))
        require(got == host[op], f"dense {op} over {len(sub)} != host fold")
    log(f"    first {len(sub)}: or/xor/and equal the host fold")
    phase_time("phase 2", t_phase)

    # ------------------------------------------------------------ phase 3
    log(f"phase 3: counts set, {2 * n} bitmaps x 4 containers x 4 values")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 1)
    cbms = []
    for _ in range(2 * n):
        keys = rng.choice(1 << 16, 4, replace=False).astype(np.uint32)
        lows = np.stack([rng.choice(1 << 16, 4, replace=False)
                         for _ in range(4)]).astype(np.uint32)
        cbms.append(RoaringBitmap.from_values(
            ((keys[:, None] << np.uint32(16)) | lows).ravel()))
    cds = smoke.main_path("counts build", lambda: DeviceBitmapSet(cbms))
    require(cds.layout == "counts", f"auto chose {cds.layout}, not counts")
    require(cds.reduce_path == "streams",
            f"counts set recorded {cds.reduce_path}, not streams (B7)")
    log(f"  layout auto -> counts, reduce path {cds.reduce_path}; groups "
        f"{cds.counts.shape[0]}, bytes {cds.hbm_bytes()}, K {cds.keys.size}")
    check_set(smoke, "counts", cds, ("or", "xor"), unpack)
    require(smoke.last[kernels.B7.name] == 1 and smoke.last[kernels.B4.name]
            == 0, f"counts xor: launches {smoke.last}, not one B7")
    # a counts set forced over bitmap containers keeps B4 (the rule); phase
    # 6 times B7 against B4 over it
    fbms = bitmap_container_bitmaps(64, 512, args.seed + 3)
    fds = DeviceBitmapSet(fbms, layout="counts")
    require(fds.reduce_path == "counts",
            f"bitmap-container counts set recorded {fds.reduce_path}")
    for op in ("or", "xor"):
        got = smoke.main_path(f"counts over bitmap containers {op}",
                              lambda op=op: fds.aggregate(op))
        require(smoke.last[kernels.B4.name] == 1
                and smoke.last[kernels.B7.name] == 0,
                f"forced counts {op}: launches {smoke.last}, not one B4")
        require(got == host_fold(op, fbms),
                f"forced counts {op} != host fold")
    log(f"    a counts set over bitmap containers ({len(fbms)} bitmaps x "
        f"{fds.keys.size} keys) keeps B4: or/xor equal the host fold")
    del fbms
    shapes["counts_segmented_reduce"] = (cds.counts, cds._grp_seg_counts,
                                         cds.keys.size)
    csub = cbms[:HOST_CHECK_N]
    cds_sub = DeviceBitmapSet(csub)
    require(cds_sub.layout == "counts", "auto subset did not choose counts")
    for op in ("or", "xor"):
        got = smoke.main_path(f"counts[{len(csub)}] {op}",
                              lambda op=op: cds_sub.aggregate(op))
        require(got == host_fold(op, csub),
                f"counts {op} over {len(csub)} != host fold")
    log(f"    first {len(csub)}: or/xor equal the host fold")
    phase_time("phase 3", t_phase)

    # ------------------------------------------------------------ phase 4
    m = min(1024, n)
    log(f"phase 4: compact set, first {m} bitmaps")
    t_phase = time.perf_counter()
    xds = smoke.main_path("compact build",
                          lambda: DeviceBitmapSet(bms[:m], layout="compact"))
    log(f"  chunks {xds._chunks[0].shape[0]}, rows {xds._n_rows}, "
        f"bytes {xds.hbm_bytes()}, K {xds.keys.size}")
    check_set(smoke, "compact", xds, ("or", "xor", "and"), unpack)
    log(f"    traced or: {traced(torch, lambda: xds.aggregate_device('or'))}")
    shapes["densify_chunks"] = (*xds._chunks, xds._n_rows, xds._chunk_bounds)
    xds_sub = DeviceBitmapSet(sub, layout="compact")
    for op in ("or", "xor", "and"):
        got = smoke.main_path(f"compact[{len(sub)}] {op}",
                              lambda op=op: xds_sub.aggregate(op))
        require(got == host[op], f"compact {op} over {len(sub)} != host fold")
    log(f"    first {len(sub)}: or/xor/and equal the host fold")
    phase_time("phase 4", t_phase)

    # ------------------------------------------------------------ phase 5
    log(f"phase 5: ad-hoc calls over {m} bitmaps")
    t_phase = time.perf_counter()
    adhoc = bms[:m]
    for name, fn in (("or_", aggregation.or_), ("xor", aggregation.xor)):
        got = smoke.main_path(name, lambda fn=fn: fn(adhoc))
        want = fn(adhoc, engine="torch")
        require(got == want, f"ad-hoc {name}: cuda != torch")
        log(f"    {name}: cardinality {got.cardinality} (cuda == torch)")
        if name == "or_":
            union = got
    require(smoke.main_path("or_ host", lambda: aggregation.or_(sub))
            == host["or"], "ad-hoc or_ != host fold")
    for name, fn in (("or_cardinality", aggregation.or_cardinality),
                     ("xor_cardinality", aggregation.xor_cardinality)):
        got = smoke.main_path(name, lambda fn=fn: fn(adhoc))
        want = fn(adhoc, engine="torch")
        require(got == want, f"{name}: cuda {got} != torch {want}")
        log(f"    {name}: {got}")
    require(aggregation.or_cardinality(adhoc) == union.cardinality,
            "or_cardinality != or_ cardinality")
    t0 = time.perf_counter()
    packing.pack_blocked_compact(adhoc, block=aggregation.BLOCK,
                                 round_blocks=64, carry_slot=False)
    t1 = time.perf_counter()
    shapes["segmented_reduce"] = packing.pack_for_aggregation(adhoc)
    t2 = time.perf_counter()
    log(f"    host pack: or_/xor streams {(t1 - t0) * 1e3:.1f} ms, "
        f"*_cardinality dense rows {(t2 - t1) * 1e3:.1f} ms")
    rng = np.random.default_rng(args.seed + 2)
    common = rng.integers(0, 1 << 21, 20000)
    abms = [RoaringBitmap.from_values(np.concatenate(
        [common, rng.integers(0, 1 << 21, 20000)]).astype(np.uint32))
        for _ in range(m)]
    got = smoke.main_path("and_", lambda: aggregation.and_(abms))
    want = host_fold("and", abms)
    require(got == want, "ad-hoc and_ != host fold")
    require(got.keys.size > 0 and got.cardinality >= np.unique(common).size,
            "ad-hoc and_ lost the shared values")
    log(f"    and_: K {got.keys.size}, cardinality {got.cardinality} "
        f"(equals the host fold)")
    phase_time("phase 5", t_phase)

    # ------------------------------------------------------------ phase 7
    log("phase 7: batch and expression queries (BatchEngine.execute)")
    t_phase = time.perf_counter()

    def run_batch(label, eng, pool, engine_want):
        """Plan (host, timed), then the batch through the user entry point
        with engine "auto" as a main-path call; returns the results."""
        cached = eng.plan_key(pool) in eng._plans
        t0 = time.perf_counter()
        plan = eng.plan(pool)
        plan_ms = (time.perf_counter() - t0) * 1e3
        got = smoke.main_path(label, lambda: eng.execute(pool))
        cold = eng.last_timings
        require(cold["engine"] == engine_want,
                f"{label}: auto ran {cold['engine']}, not {engine_want}")
        eng.execute(pool)
        warm = eng.last_timings
        log(f"    {label}: engine {cold['engine']}; plan {plan_ms:.1f} ms "
            f"(host{', cached' if cached else ''}); device "
            f"{cold['device_ms']:.3f} ms cold, "
            f"{warm['device_ms']:.3f} ms warm; host unpack "
            f"{warm['unpack_ms']:.3f} ms")
        return plan, got

    # 7a: flat batch on the dense set of phase 2
    eng = BatchEngine(ds)
    flat = [BatchQuery(q.op, q.operands, form="bitmap")
            for q in random_query_pool(n, 64, seed=args.seed)]
    plan, got = run_batch(f"flat x{len(flat)}", eng, flat, "cuda")
    log(f"    buckets {[b.signature[:4] for b in plan]}")
    require(same_results(got, eng.execute(flat, engine="torch")),
            "flat batch: cuda rung != torch rung")
    for q, r in zip(flat[:8], got):
        require(r.bitmap == host_query(q, bms), f"flat {q.op}: != host fold")
    log(f"    equal to the torch rung; first 8 equal the host fold "
        f"(cards {[r.cardinality for r in got[:8]]})")

    # 7b: expression batches on a search-shard-shaped set
    t0 = time.perf_counter()
    sbms = synthetic_bitmaps(n, seed=args.seed, universe=1 << 20,
                             density=1 / 64)
    log(f"  search-shard set: {n} bitmaps generated in "
        f"{time.perf_counter() - t0:.1f} s")
    sds = smoke.main_path("shard build",
                          lambda: DeviceBitmapSet(sbms, layout="dense"))
    log(f"  rows {sds.words.shape[0]}, bytes {sds.hbm_bytes()}, "
        f"K {sds.keys.size}")
    fixed = [expr.ExprQuery(expr.and_(expr.or_(0, 1), expr.not_(2)),
                            form="bitmap"),
             expr.ExprQuery(expr.xor(expr.and_(expr.or_(0, 1),
                                               expr.or_(2, 3)),
                                     expr.andnot(expr.or_(4, 5), 6)),
                            form="bitmap")]

    def fitting_pool(eng_, n_src):
        """The largest power-of-two Q <= 64 whose plan fits B5."""
        for q in (64, 32, 16, 8, 4):
            pool = expr.random_expr_pool(n_src, q, depth=2, seed=args.seed,
                                         form="bitmap") + fixed
            t0 = time.perf_counter()
            mega = eng_.plan(pool).mega
            log(f"    Q {q}: plan {(time.perf_counter() - t0) * 1e3:.1f} ms "
                f"(host), steps {mega.n_steps} (pad {mega.steps_pad}), "
                f"slots {mega.n_slots} (pad {mega.slots_pad}), out rows "
                f"{mega.out_pad}, card rows {mega.card_pad}, "
                f"{'fits' if mega.fits() else 'does not fit: ' + megakernel.capacity_reason(mega)}")
            if mega.fits():
                return q, pool
        raise AssertionError("no expression batch of Q >= 4 fits B5")

    def check_expr(label, eng_, pool, srcs, got):
        """Results equal to the other rungs, each timed on its first (cold)
        and second (warm) execute, and to evaluate_host."""
        rung_ms = {}
        for rung in ("cuda", "torch"):
            require(same_results(got, eng_.execute(pool, engine=rung)),
                    f"{label}: megakernel != {rung} rung")
            cold = eng_.last_timings["device_ms"]
            eng_.execute(pool, engine=rung)
            rung_ms[rung] = (f"{cold:.3f} cold / "
                             f"{eng_.last_timings['device_ms']:.3f} warm")
        log(f"    {label}: device ms of the other rungs {rung_ms}")
        for q, r in zip(pool, got):
            require(r.bitmap == expr.evaluate_host(q.expr, srcs),
                    f"{label}: != evaluate_host")
        log(f"    {label}: equal to the cuda and torch rungs and to "
            f"evaluate_host (cards {[r.cardinality for r in got[:6]]} ...)")

    seng = BatchEngine(sds)
    q_fit, epool = fitting_pool(seng, n)
    eplan, got = run_batch(f"expr x{len(epool)}", seng, epool, "megakernel")
    check_expr("expr", seng, epool, sbms, got)
    shapes["megakernel"] = (eplan.mega, sds.words)

    m7 = min(1024, n)
    xsds = smoke.main_path("shard compact build", lambda: DeviceBitmapSet(
        sbms[:m7], layout="compact"))
    xeng = BatchEngine(xsds)
    _, xpool = fitting_pool(xeng, m7)
    _, got = run_batch(f"compact expr x{len(xpool)}", xeng, xpool,
                       "megakernel")
    check_expr("compact expr", xeng, xpool, sbms[:m7], got)

    # 7c: capacity at K = 256 (the dense set of phase 2)
    pool8 = expr.random_expr_pool(n, 8, depth=2, seed=args.seed,
                                  form="bitmap")
    mega8 = eng.plan(pool8).mega
    reason = megakernel.capacity_reason(mega8)
    log(f"  8 expression queries at K {ds.keys.size}: steps "
        f"{mega8.n_steps}, slots {mega8.n_slots} -> "
        f"{'fits' if reason is None else 'demoted: ' + reason}")
    require(reason == "slots", f"8-query plan: capacity {reason!r}, "
            f"expected 'slots'")
    demoted = obs.counter("rb_mega_capacity_demotions_total",
                          site="batch_engine", reason=reason)
    before = demoted.value
    got = smoke.main_path("expr x8 @K256", lambda: eng.execute(pool8))
    require(eng.last_timings["engine"] == "cuda"
            and demoted.value == before + 1,
            "8-query batch: demotion not counted")
    log(f"    demoted to the cuda rung, counted under {reason!r}")
    require(same_results(got, eng.execute(pool8, engine="torch")),
            "8-query batch != torch rung")
    pool1 = fixed[:1]
    mega1 = eng.plan(pool1).mega
    require(mega1.fits(), f"one depth-2 query at K {ds.keys.size}: "
            f"{megakernel.capacity_reason(mega1)}")
    got = smoke.main_path("expr x1 @K256", lambda: eng.execute(pool1))
    require(eng.last_timings["engine"] == "megakernel", "1 query")
    check_expr("expr x1 @K256", eng, pool1, bms, got)
    log(f"    one depth-2 query (steps {mega1.n_steps}, slots "
        f"{mega1.n_slots}) ran on the megakernel")
    phase_time("phase 7", t_phase)

    # ------------------------------------------------------------ phase 8
    log("phase 8: compact nibble engine, probes, DeviceBitmap, pairwise")
    t_phase = time.perf_counter()

    def device_ms(fn):
        """Host clock around ``fn`` to a synchronize, in ms."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def same_device(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # 8a: compact set with bitmap containers, on the nibble engine
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 3)
    nbms = list(bms)
    for i in range(0, n, 16):
        keys = nbms[i].keys[:8].astype(np.uint32)
        hit = np.flatnonzero(rng.random((keys.size, 1 << 16)) < 1 / 8)
        nbms[i] = nbms[i] | RoaringBitmap.from_values(
            (keys[hit >> 16] << np.uint32(16)) | (hit & 0xFFFF).astype(np.uint32))
    log(f"  8a: every 16th of {n} bitmaps ORed with a 1/8-density block in "
        f"{time.perf_counter() - t0:.1f} s")
    nds = smoke.main_path("nibble compact build",
                          lambda: DeviceBitmapSet(nbms, layout="compact"))
    n_dense = nds._streams[0].shape[0]
    log(f"  dense-wire rows {n_dense}, rows {nds._n_rows}, groups "
        f"{nds._n_groups + 1}, values {nds._total_values}, bytes "
        f"{nds.hbm_bytes()}, block {nds.block}, K {nds.keys.size}")
    require(n_dense > 0, "8a: the dense-wire stream is empty")
    for op in ("or", "xor"):
        got = smoke.main_path(f"nibble {op}", lambda op=op: nds.aggregate(
            op, engine="cuda-nibble"))
        require(kernels.B6.launches == 1 and kernels.B4.launches == 0,
                f"8a {op}: B6 did not launch once")
        nib = nds.aggregate_device(op, engine="cuda-nibble")
        require(same_device(nib, nds.aggregate_device(op, engine="cuda")),
                f"8a {op}: cuda-nibble != cuda")
        require(same_device(nib, nds.aggregate_device(op, engine="torch")),
                f"8a {op}: cuda-nibble != torch")
        require(got == unpack(nds.keys, *nib), f"8a {op}: unpack differs")
        del nib
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (words, cards), dev_ms = device_ms(
            lambda op=op: nds.aggregate_device(op, engine="cuda-nibble"))
        peak = torch.cuda.max_memory_allocated() - base
        t1 = time.perf_counter()
        unpack(nds.keys, words, cards)
        unpack_ms = (time.perf_counter() - t1) * 1e3
        log(f"    {op}: cardinality {got.cardinality} (cuda-nibble == cuda "
            f"== torch); device {dev_ms:.3f} ms, host unpack "
            f"{unpack_ms:.3f} ms, transient peak {peak / 2**30:.2f} GiB "
            f"(int64 counts scratch alone "
            f"{(nds._n_groups + 1) * dense.NIBBLE_WORDS * 8 / 2**30:.2f} GiB)")
    nsub = nbms[:HOST_CHECK_N]
    t0 = time.perf_counter()
    nhost = {op: host_fold(op, nsub) for op in ("or", "xor")}
    log(f"  host folds of {len(nsub)} bitmaps in "
        f"{time.perf_counter() - t0:.1f} s")
    nds_sub = DeviceBitmapSet(nsub, layout="compact")
    for op in ("or", "xor"):
        got = smoke.main_path(f"nibble[{len(nsub)}] {op}",
                              lambda op=op: nds_sub.aggregate(
                                  op, engine="cuda-nibble"))
        require(got == nhost[op], f"8a {op} over {len(nsub)} != host fold")
    log(f"    first {len(nsub)}: or/xor on cuda-nibble equal the host fold")
    shapes["fused_nibble_reduce"] = nds
    del nds_sub, nsub, nhost

    # 8b: steady-state probes
    reps = 8
    probe_sets = (("dense", ds, ("or", "xor", "and"), ("cuda",)),
                  ("counts", cds, ("or", "xor"), ("cuda",)),
                  ("nibble compact", nds, ("or", "xor", "and"),
                   ("cuda", "cuda-nibble")))
    for label, pset, ops, engines in probe_sets:
        for engine in engines:
            for op in ops:
                (words, cards), q_ms = device_ms(
                    lambda: pset.aggregate_device(op, engine=engine))
                card = int(cards.sum())
                del words, cards
                probes = [("chained_aggregate",
                           pset.chained_aggregate(op, reps, engine=engine))]
                if op == "or":
                    probes.append(("chained_wide_or",
                                   pset.chained_wide_or(reps, engine=engine)))
                for name, fn in probes:
                    total = int(smoke.main_path(
                        f"{label} {engine} {name} {op} x{reps}", fn))
                    require(total == (reps * card) % 2**32,
                            f"{label} {engine} {name} {op}: total {total} "
                            f"!= {reps} x {card} mod 2^32")
                    _, p_ms = device_ms(fn)
                    log(f"    {label} {engine} {name} {op}: total == "
                        f"{reps} x {card} mod 2^32; {p_ms / reps:.3f} ms per "
                        f"iteration, single query {q_ms:.3f} ms")

    # 8c: range cardinality and DeviceBitmap on the dense set of phase 2
    t0 = time.perf_counter()
    u_host = ds.aggregate("or", engine="torch")
    k1 = int(ds.keys[ds.keys.size // 3])
    ranges = (((k1 << 16) + 12345, ((k1 + 3) << 16) + 54321),
              (0, 1 << 32), (1 << 20, 1 << 20))
    for a, b in ranges:
        got = smoke.main_path(f"range [{a}, {b})", lambda a=a, b=b:
                              ds.aggregate_range_cardinality("or", a, b))
        want = u_host.range_cardinality(a, b)
        require(got == want, f"range [{a}, {b}): {got} != host {want}")
        log(f"    aggregate_range_cardinality('or', {a}, {b}) = {got} "
            f"(host)")
    comp = smoke.main_path("DeviceBitmap or - xor", lambda: (
        DeviceBitmap.aggregate(ds, "or")
        - DeviceBitmap.aggregate(xds, "xor")))
    comp_host = comp.materialize()
    want = u_host - xds.aggregate("xor", engine="torch")
    require(comp_host == want, "DeviceBitmap or - xor != host difference")
    require(comp.cardinality() == want.cardinality, "DeviceBitmap card")
    members = comp_host.to_array()
    half = 1 << 19
    probes = np.concatenate([
        rng.choice(members, half),
        rng.integers(0, 1 << 32, half, dtype=np.uint64).astype(np.uint32)])
    got = smoke.main_path("contains_batch x2^20",
                          lambda: comp.contains_batch(probes))
    want_in = np.isin(probes, members)
    require(np.array_equal(got, want_in), "contains_batch != host")
    spot = probes[::1024]
    require(np.array_equal(want_in[::1024],
                           [comp_host.contains(int(v)) for v in spot]),
            "host contains != isin")
    log(f"    DeviceBitmap or - xor: K {comp.keys.size}, cardinality "
        f"{comp.cardinality()} (host difference); contains_batch of "
        f"{probes.size} probes: {int(got.sum())} members (host); 8c took "
        f"{time.perf_counter() - t0:.1f} s")
    del comp, u_host

    # 8d: pairwise over consecutive pairs of phase 2's bitmaps
    pairs = list(zip(bms[0::2], bms[1::2]))
    t0 = time.perf_counter()
    and_host = np.array([(a & b).cardinality for a, b in pairs], np.int64)
    card_a = np.array([a.cardinality for a, _ in pairs], np.int64)
    card_b = np.array([b.cardinality for _, b in pairs], np.int64)
    host_cards = {"and": and_host, "or": card_a + card_b - and_host,
                  "xor": card_a + card_b - 2 * and_host,
                  "andnot": card_a - and_host}
    host_ops = {"or": lambda a, b: a | b, "and": lambda a, b: a & b,
                "xor": lambda a, b: a ^ b, "andnot": lambda a, b: a - b}
    head_pairs = pairs[:64]
    host64 = {op: [f(a, b) for a, b in head_pairs]
              for op, f in host_ops.items()}
    log(f"  8d: host cards of {len(pairs)} pairs and results of the first "
        f"{len(head_pairs)} in {time.perf_counter() - t0:.1f} s")
    for layout in ("dense", "compact"):
        ps = smoke.main_path(f"pair {layout} build",
                             lambda layout=layout: DevicePairSet(
                                 pairs, layout=layout))
        log(f"    {layout}: aligned rows {ps._n_rows}, bytes "
            f"{ps.hbm_bytes()}")
        for op in host_ops:
            got = smoke.main_path(f"pair {layout} {op} cards",
                                  lambda op=op: ps.cardinalities(op))
            require(np.array_equal(got, host_cards[op]),
                    f"pair {layout} {op}: cardinalities != host")
            _, q_ms = device_ms(lambda op=op: ps.pairwise_device(op))
            fn = ps.chained_cardinality(op, 4)
            total = int(smoke.main_path(f"pair {layout} chained {op} x4", fn))
            require(total == (4 * int(got.sum())) % 2**32,
                    f"pair {layout} chained {op}: {total}")
            _, p_ms = device_ms(fn)
            log(f"    {layout} {op}: cards == host, sum {int(got.sum())}; "
                f"device {q_ms:.3f} ms per query, chained "
                f"{p_ms / 4:.3f} ms per iteration")
        sub = DevicePairSet(head_pairs, layout=layout)
        for op in host_ops:
            require(sub.pairwise(op) == host64[op],
                    f"pair {layout} {op}: pairwise != host")
        log(f"    {layout}: pairwise of the first {len(head_pairs)} pairs "
            f"equals the host for or/and/xor/andnot")
        del ps, sub
    fn, _ = smoke.main_path("chained_pairwise_cardinality build", lambda:
                            aggregation.chained_pairwise_cardinality(
                                "xor", pairs, 4))
    total = int(smoke.main_path("chained_pairwise_cardinality xor x4", fn))
    require(total == (4 * int(host_cards["xor"].sum())) % 2**32,
            f"chained_pairwise_cardinality xor: {total}")
    log(f"    chained_pairwise_cardinality('xor', pairs, 4) = {total} "
        f"== 4 x host sum mod 2^32")
    del fn
    phase_time("phase 8", t_phase)

    # ------------------------------------------------------------ phase 9
    log("phase 9: value columns (BsiColumn, RangeColumn, DeviceBSI)")
    t_phase = time.perf_counter()
    rows = 1 << 20
    rng = np.random.default_rng(args.seed + 9)
    t0 = time.perf_counter()
    price = smoke.main_path("price column build", lambda: BsiColumn(
        "price", np.arange(rows, dtype=np.uint32),
        rng.integers(0, PRICE_MAX, rows)))
    ts = smoke.main_path("ts column build", lambda: RangeColumn(
        "ts", rng.integers(0, 1 << 40, rows)))
    for c in (price, ts):
        sds.attach_column(c)
        log(f"  {c.name}: {c.kind}, depth {c.depth} (padded {c.depth_pad}), "
            f"K {c.keys.size}, {c.hbm_bytes()} bytes")
    log(f"  columns built in {time.perf_counter() - t0:.1f} s")
    cols = {"price": price, "ts": ts}
    vpool = value_pool(expr, price, ts, sbms)
    batches = fitting_batches(seng, vpool)
    log(f"  9a: {len(vpool)} queries in {len(batches)} batches that fit B5")
    n_vscan = n_vagg = 0
    fused_aggs = {}
    big = None
    for bi, (batch, plan_ms) in enumerate(batches):
        label = f"value batch {bi} x{len(batch)}"
        log(f"    {label}: plan {plan_ms:.1f} ms (host, first plan)")
        plan, got = run_batch(label, seng, batch, "megakernel")
        b5 = smoke.last[kernels.B5.name]
        require(b5 == 1, f"{label}: B5 launched {b5} times, not once")
        mega = plan.mega
        n_vscan += mega.n_vscan
        n_vagg += mega.n_vagg
        log(f"    {label}: steps {mega.n_steps}, slots {mega.n_slots}, "
            f"bank-2 rows {mega.col_rows}, vscan {mega.n_vscan}, vagg "
            f"{mega.n_vagg}; B5 launched once")
        check_value(expr, label, seng, batch, sbms, cols, got)
        for q, r in zip(batch, got):
            if expr.is_agg(q.expr):
                fused_aggs[q] = r
        # phase 6 times the longest plan that holds an aggregate root
        if big is None or (mega.n_vagg > 0, mega.n_steps) > (
                big.n_vagg > 0, big.n_steps):
            big = mega
    require(n_vscan > 0 and n_vagg > 0,
            f"9a: vscan {n_vscan}, vagg {n_vagg} steps; both must run")
    shapes["megakernel_value"] = (big, sds.words)

    # a plan past MAX_STEPS: four top-k roots over the 64-plane column
    over = [expr.ExprQuery(expr.top_k("ts", 100, found=expr.or_(i, i + 1)))
            for i in range(4)]
    mover = seng.plan(over).mega
    reason = megakernel.capacity_reason(mover)
    log(f"  4 top_k(ts) roots: steps {mover.n_steps} (pad "
        f"{mover.steps_pad}), slots {mover.n_slots} -> "
        f"{'fits' if reason is None else 'demoted: ' + reason}")
    require(reason == "steps", f"4 top_k roots: capacity {reason!r}, "
            f"expected 'steps'")
    demoted = obs.counter("rb_mega_capacity_demotions_total",
                          site="batch_engine", reason=reason)
    before = demoted.value
    got = smoke.main_path("top_k(ts) x4", lambda: seng.execute(over))
    require(seng.last_timings["engine"] == "cuda"
            and demoted.value == before + 1,
            "4 top_k roots: demotion not counted")
    log(f"    demoted to the cuda rung, counted under {reason!r}")
    check_value(expr, "top_k(ts) x4", seng, over, sbms, cols, got,
                rungs=("torch",))

    # 9b: the two-phase baseline on the aggregate roots of 9a, each root
    # alone (warm), against the same root fused in one B5 launch
    tp = two_phase_execute(seng, list(fused_aggs))
    for (q, f), r in zip(fused_aggs.items(), tp):
        require((r.cardinality, r.value, r.bitmap) == (
            f.cardinality, f.value, f.bitmap), "9b: two-phase != fused")
    totals = [0.0, 0.0]
    for q in fused_aggs:
        one = [q]
        seng.execute(one)
        two_phase_execute(seng, one)
        f_ms = device_ms(lambda: seng.execute(one))[1]
        t_ms = device_ms(lambda: two_phase_execute(seng, one))[1]
        totals[0] += f_ms
        totals[1] += t_ms
        log(f"    9b {q.expr.kind}({q.expr.col}): fused {f_ms:.3f} ms, "
            f"two-phase {t_ms:.3f} ms (host clock to a synchronize, "
            f"plan and readbacks included, warm)")
    log(f"  9b: two-phase equals the fused answers for {len(fused_aggs)} "
        f"aggregate roots; fused {totals[0]:.3f} ms, two-phase "
        f"{totals[1]:.3f} ms in all")

    # 9c: the device BSI tier over phase 2's 2^24-row universe
    t0 = time.perf_counter()
    big_rows = 1 << 24
    hbsi = RoaringBitmapSliceIndex.from_pairs(
        np.arange(big_rows, dtype=np.uint32),
        rng.integers(0, PRICE_MAX, big_rows))
    log(f"  9c: host BSI over {big_rows} rows built in "
        f"{time.perf_counter() - t0:.1f} s")
    dbsi = smoke.main_path("DeviceBSI build", lambda: DeviceBSI(hbsi))
    log(f"    DeviceBSI: depth {dbsi.depth}, K {dbsi.keys.size}, "
        f"{dbsi.hbm_bytes()} bytes resident")
    stored = int(hbsi.get_value(12345)[0])
    for op, a, b in (("EQ", stored, 0), ("NEQ", stored, 0),
                     ("LT", PRICE_MAX // 3, 0), ("LE", PRICE_MAX // 3, 0),
                     ("GT", PRICE_MAX // 2, 0), ("GE", PRICE_MAX // 2, 0),
                     ("RANGE", PRICE_MAX // 4, PRICE_MAX // 2)):
        bop = Operation[op]
        (got, dev_ms) = device_ms(lambda: dbsi.compare(bop, a, b))
        want = hbsi.compare(bop, a, b)
        require(got == want, f"DeviceBSI {op}: != host")
        card = dbsi.compare_cardinality(bop, a, b)
        require(card == want.cardinality, f"DeviceBSI {op} cardinality")
        log(f"    compare {op}: {card} rows (host); {dev_ms:.3f} ms with "
            f"the unpack")
    (got, dev_ms) = device_ms(dbsi.sum)
    require(got == hbsi.sum(), "DeviceBSI sum != host")
    log(f"    sum: {got[0]} over {got[1]} rows (host); {dev_ms:.3f} ms")
    (got, dev_ms) = device_ms(lambda: dbsi.top_k(1000))
    require(got == hbsi.top_k(1000), "DeviceBSI top_k != host")
    log(f"    top_k(1000): equals the host; {dev_ms:.3f} ms")
    reps = 8
    probes = (
        ("chained_compare GE", dbsi.chained_compare_cardinality(
            Operation.GE, PRICE_MAX // 2, reps),
         dbsi.compare_cardinality(Operation.GE, PRICE_MAX // 2)),
        ("chained_sum", dbsi.chained_sum_cardinality(reps),
         hbsi.sum()[0] % 2**32),
        ("chained_topk 1000", dbsi.chained_topk_cardinality(1000, reps),
         int(dbsi.chained_topk_cardinality(1000, 1)())))
    drb = smoke.main_path("DeviceRangeBitmap build",
                          lambda: DeviceRangeBitmap(ts.host))
    tmax = ts.max_value
    for op, a in (("lte", tmax // 3), ("lt", tmax // 3), ("gte", tmax // 2),
                  ("gt", tmax // 2), ("eq", int(ts.values[77])),
                  ("neq", int(ts.values[77])), ("between", tmax // 4)):
        extra = (tmax // 2,) if op == "between" else ()
        got, dev_ms = device_ms(lambda: getattr(drb, op)(a, *extra))
        want = getattr(ts.host, op)(a, *extra)
        require(got == want, f"DeviceRangeBitmap {op}: != host")
        require(getattr(drb, f"{op}_cardinality")(a, *extra)
                == want.cardinality, f"DeviceRangeBitmap {op} cardinality")
        log(f"    DeviceRangeBitmap {op}: {want.cardinality} rows (host); "
            f"{dev_ms:.3f} ms with the unpack")
    probes += (("range chained between",
                drb.chained_cardinality("between", tmax // 4, tmax // 2,
                                        reps),
                drb.between_cardinality(tmax // 4, tmax // 2)),)
    for name, fn, single in probes:
        total = int(smoke.main_path(f"{name} x{reps}", fn))
        require(total == (reps * single) % 2**32,
                f"{name}: {total} != {reps} x {single} mod 2^32")
        _, p_ms = device_ms(fn)
        log(f"    {name}: total == {reps} x {single} mod 2^32; "
            f"{p_ms / reps:.3f} ms per iteration")
    bsi9 = (hbsi, dbsi, ts.host, drb)     # phase 16b shards them
    del dbsi, drb, hbsi
    phase_time("phase 9", t_phase)

    # ------------------------------------------------------------ phase 10
    log("phase 10: the 64-bit tier, the guard and native ingest")
    t_phase = time.perf_counter()

    def lift(src, bucket=None):
        """32-bit bitmaps as Roaring64Bitmaps with values (b << 32) | v,
        b = BUCKETS[i % 4] (or ``bucket``), reusing their containers."""
        return [Roaring64Bitmap(
            (np.uint64(BUCKETS[i % 4] if bucket is None else bucket)
             << np.uint64(16)) | b.keys.astype(np.uint64), list(b.containers))
            for i, b in enumerate(src)]

    # 10a: the resident 64-bit set: phase 2's bitmaps in four buckets
    l64 = lift(bms)
    ds64 = smoke.main_path("64-bit dense build",
                           lambda: DeviceBitmapSet(l64, layout="dense"))
    require(ds64.keys.dtype == np.uint64 and int(ds64.keys[-1]) >> 16
            == BUCKETS[-1], "64-bit set: keys are not u48 keys past 2^63")
    log(f"  rows {ds64.words.shape[0]}, bytes {ds64.hbm_bytes()}, block "
        f"{ds64.block}, K {ds64.keys.size} (u48 keys {int(ds64.keys[0])} "
        f"... {int(ds64.keys[-1])})")
    t64 = check_set(smoke, "64-bit dense", ds64, ("or", "xor", "and"),
                    unpack)
    for op in ("or", "xor", "and"):
        log(f"    {op}: device {t64[op][0]:.3f} ms, unpack "
            f"{t64[op][1]:.3f} ms at K {ds64.keys.size}, against phase "
            f"2's {dense_times[op][0]:.3f} / {dense_times[op][1]:.3f} ms at "
            f"K {ds.keys.size} (the same rows)")
    sub64 = l64[:HOST_CHECK_N]
    t0 = time.perf_counter()
    host64 = {op: host_fold(op, sub64) for op in ("or", "xor", "and")}
    log(f"  host folds of {len(sub64)} Roaring64Bitmaps in "
        f"{time.perf_counter() - t0:.1f} s")
    ds64_sub = DeviceBitmapSet(sub64, layout="dense")
    for op in ("or", "xor", "and"):
        got = smoke.main_path(f"64-bit dense[{len(sub64)}] {op}",
                              lambda op=op: ds64_sub.aggregate(op))
        require(type(got) is Roaring64Bitmap and got == host64[op],
                f"64-bit dense {op} over {len(sub64)} != host fold")
    log(f"    first {len(sub64)}: or/xor/and equal the host fold of "
        f"Roaring64Bitmaps")
    xds64 = smoke.main_path("64-bit compact build", lambda: DeviceBitmapSet(
        l64[:m], layout="compact"))
    log(f"  compact set of the first {m}: chunks "
        f"{xds64._chunks[0].shape[0]}, rows {xds64._n_rows}, "
        f"K {xds64.keys.size}")
    check_set(smoke, "64-bit compact", xds64, ("or",), unpack)
    got = smoke.main_path(f"64-bit compact[{len(sub64)}] or", lambda: (
        DeviceBitmapSet(sub64, layout="compact").aggregate("or")))
    require(got == host64["or"], "64-bit compact or != host fold")
    del ds64_sub

    # 10b: ad-hoc 64-bit calls, a flat batch, an expression batch, probes
    ad64 = l64[:m]
    for name, fn in (("or64", aggregation.or64),
                     ("xor64", aggregation.xor64)):
        got = smoke.main_path(name, lambda fn=fn: fn(ad64))
        require(got == fn(ad64, engine="torch"), f"{name}: cuda != torch")
        log(f"    {name}: cardinality {got.cardinality} (cuda == torch)")
    require(smoke.main_path("or64 host", lambda: aggregation.or64(sub64))
            == host64["or"], "or64 != host fold")
    a64 = lift(abms, bucket=2**31)
    got = smoke.main_path("and64", lambda: aggregation.and64(a64))
    want = lift([aggregation.and_(abms)], bucket=2**31)[0]
    require(got == want and int(got.first()) >= 2**63,
            "and64 != the lifted 32-bit and_")
    log(f"    and64 over {len(a64)} bitmaps at 2^63: cardinality "
        f"{got.cardinality} (the lifted and_)")

    eng64 = BatchEngine(ds64)
    flat64 = [BatchQuery(q.op, q.operands, form="bitmap")
              for q in random_query_pool(n, 64, seed=args.seed)]
    _, got = run_batch(f"64-bit flat x{len(flat64)}", eng64, flat64, "cuda")
    require(same_results(got, eng64.execute(flat64, engine="torch")),
            "64-bit flat batch: cuda rung != torch rung")
    for q, r in zip(flat64[:8], got):
        require(type(r.bitmap) is Roaring64Bitmap
                and r.bitmap == host_query(q, l64),
                f"64-bit flat {q.op}: != host fold")
    log(f"    equal to the torch rung; first 8 equal the host fold (cards "
        f"{[r.cardinality for r in got[:8]]})")
    s64 = lift(sbms)
    sds64 = smoke.main_path("64-bit shard build", lambda: DeviceBitmapSet(
        s64, layout="dense"))
    log(f"  64-bit search-shard set: rows {sds64.words.shape[0]}, K "
        f"{sds64.keys.size}")
    seng64 = BatchEngine(sds64)
    _, epool64 = fitting_pool(seng64, n)
    _, got = run_batch(f"64-bit expr x{len(epool64)}", seng64, epool64,
                       "megakernel")
    require(smoke.last[kernels.B5.name] == 1, "64-bit expr: not one B5")
    check_expr("64-bit expr", seng64, epool64, s64, got)

    union64 = ds64.aggregate("or", engine="torch")
    comp64 = DeviceBitmap.aggregate(ds64, "or")
    members = union64.to_array()
    half = 1 << 19
    probes = np.concatenate([rng.choice(members, half), rng.integers(
        0, 2**64 - 1, half, dtype=np.uint64)])
    got = smoke.main_path("64-bit contains_batch x2^20",
                          lambda: comp64.contains_batch(probes))
    want_in = np.isin(probes, members)
    require(np.array_equal(got, want_in), "64-bit contains_batch != host")
    spot = probes[::1024]
    require(np.array_equal(want_in[::1024],
                           [union64.contains(int(v)) for v in spot]),
            "64-bit host contains != isin")
    sprobes = probes.view(np.int64)     # every probe >= 2^63 is negative
    got_s = comp64.contains_batch(sprobes)
    require(np.array_equal(got_s, want_in & (sprobes >= 0)),
            "64-bit contains_batch of int64 probes != host")
    log(f"    contains_batch of {probes.size} u64 probes: {int(got.sum())} "
        f"members, {int((probes >= np.uint64(2**63)).sum())} probes >= "
        f"2^63 (host); as int64, {int((sprobes < 0).sum())} negative "
        f"probes all absent")
    del comp64, union64, sds64, seng64

    # 10c: the guard: nothing demoted so far, then injected faults
    stats = guard.dispatch_stats()
    require(all(r["demotions"] == 0 and r["sequential"] == 0
                for r in stats.values()),
            f"a guarded call demoted or landed on the host: {stats}")
    log(f"  10c: after phases 2-10b the guard counted no demotion and no "
        f"sequential landing ({stats or 'no events at any site'})")
    guard.reset_dispatch_stats()

    # "aggregation/pallas": how the "cuda" rung is drawn
    spec = fires_first(faults, lambda sd: f"transient@aggregation=0.5:{sd}",
                       "aggregation/pallas", 0.5, 1)
    with faults.inject(spec):
        got = smoke.main_path(f"or_ under {spec}", lambda: aggregation.or_(
            adhoc, engine="cuda"))
    require(got == union and guard.dispatch_stats("aggregation") == {
        "retries": 1, "demotions": 0, "sequential": 0},
        f"transient: {guard.dispatch_stats('aggregation')}")
    log(f"    {spec}: retried once on cuda, equal result")
    guard.reset_dispatch_stats()

    def lowered():
        try:
            aggregation.or_(adhoc, engine="cuda")
        except errors.EngineLoweringError as exc:
            return exc
        return None

    with faults.inject("lowering@cuda:1"):
        raised = smoke.main_path("or_ under lowering@cuda", lowered)
    require(raised is not None and not any(smoke.last.values())
            and not any(v for row in guard.dispatch_stats().values()
                        for v in row.values()),
            f"lowering@cuda: raised {raised!r}, launches {smoke.last}, "
            f"events {guard.dispatch_stats()}")
    log(f"    lowering@cuda: or_ raised {type(raised).__name__} on the card "
        f"(no demotion to torch or the host, no launch)")
    guard.reset_dispatch_stats()
    pair = epool[:2]
    clean = seng.execute(pair)
    dump = out_path("10c-oom.jsonl")
    stop = trace_into(obs, dump)
    try:
        with faults.inject("oom@megakernel:1"):
            got = smoke.main_path("expr x2 under oom@megakernel",
                                  lambda: seng.execute(pair))
    finally:
        stop()
    ev = [(e["engine_from"], e["engine_to"]) for sp in read_spans(dump)
          if sp["name"] == "guard.dispatch" for e in sp["events"]
          if e["name"] == "demote"]
    require(same_results(got, clean) and seng.last_timings["engine"] == "cuda"
            and ("megakernel", "cuda") in ev
            and guard.dispatch_stats("batch_engine")["sequential"] == 0,
            f"oom@megakernel: {ev}, {guard.dispatch_stats()}, "
            f"{seng.last_timings['engine']}")
    log(f"    oom@megakernel: the batch was halved ({seng.split_count} "
        f"splits so far) and each half demoted to cuda (counted: {ev}); "
        f"equal result")
    guard.reset_dispatch_stats()
    # the shadow check re-runs every query on the host rung, which first
    # rebuilds the sources from the resident rows: a set of 256, not 4,096
    shadow = guard.GuardPolicy(shadow_rate=1.0)
    n_sh = min(256, n)
    eng_sh = BatchEngine(DeviceBitmapSet(l64[:n_sh], layout="dense"))
    pool_sh = [BatchQuery(q.op, q.operands, form="bitmap")
               for q in random_query_pool(n_sh, 8, seed=args.seed)]
    got = smoke.main_path("flat x8 under shadow 1.0", lambda: eng_sh.execute(
        pool_sh, policy=shadow))
    require(same_results(got, eng_sh.execute(pool_sh, engine="torch")),
            "shadow 1.0 on a clean batch changed a result")
    try:
        with faults.inject("silent@batch_engine:3"):
            eng_sh.execute(pool_sh, policy=shadow)
        caught = False
    except errors.ShadowMismatch as exc:
        caught = True
        log(f"    silent@batch_engine under shadow 1.0: ShadowMismatch "
            f"({exc})")
    require(caught, "silent corruption under shadow 1.0 was not caught")
    log("    shadow 1.0 passed on the clean batch")

    # 10d: native ingest of phase 5's bitmaps as serialized bytes
    blobs = [b.serialize() for b in adhoc]
    native.reset_calls()

    def pack_bytes():
        return packing.pack_blocked_compact(
            blobs, block=aggregation.BLOCK, round_blocks=64,
            carry_slot=False)

    def best_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return out, best

    t0 = time.perf_counter()
    pack_bytes()                       # the first call builds the library
    build_s = time.perf_counter() - t0
    p_nat, nat_ms = best_ms(pack_bytes)
    os.environ["RB_NATIVE"] = "0"
    try:
        p_np, np_ms = best_ms(pack_bytes)
    finally:
        del os.environ["RB_NATIVE"]
    for f in ("keys", "blk_seg", "block", "n_blocks", "seg_sizes",
              "seg_offsets", "carry_row", "row_src"):
        require(np.array_equal(getattr(p_nat, f), getattr(p_np, f)),
                f"native pack: {f} != NumPy")
    for f in ("n_rows", "dense_words", "dense_dest", "values", "val_counts",
              "val_dest"):
        require(np.array_equal(getattr(p_nat.streams, f),
                               getattr(p_np.streams, f)),
                f"native pack: streams.{f} != NumPy")
    require(native.CALLS["native"] > 0 and native.CALLS["numpy"] == 3,
            f"native counts {native.CALLS}")
    log(f"    pack_blocked_compact of {len(blobs)} serialized bitmaps "
        f"({sum(map(len, blobs))} bytes): native {nat_ms:.1f} ms, NumPy "
        f"{np_ms:.1f} ms (host, best of 3; the first native call built "
        f"the library and packed in {build_s:.1f} s); array for array "
        f"equal; counts {native.CALLS}")
    got = smoke.main_path("native compact set or", lambda: DeviceBitmapSet(
        blobs, layout="compact").aggregate("or"))
    require(got == union, "the set of native-packed bytes: or != or_")
    log(f"    or over the native-packed set: cardinality {got.cardinality} "
        f"(equals phase 5's or_)")
    del ds64, xds64, eng64, eng_sh, l64, s64
    phase_time("phase 10", t_phase)

    # ------------------------------------------------------------ phase 11
    log("phase 11: the pooled multi-tenant engine (MultiSetBatchEngine)")
    t_phase = time.perf_counter()
    tenants11 = phase11(smoke, bms, sbms, price, lift, args.seed, shapes)
    phase_time("phase 11", t_phase)

    # ------------------------------------------------------------ phase 13
    log("phase 13: the compile vocabulary (lattice warmup, sealed graphs)")
    t_phase = time.perf_counter()
    phase13(smoke, args.seed, ds, bms, sds, sbms, xsds, q_fit, fixed,
            tenants11)
    phase_time("phase 13", t_phase)

    # ------------------------------------------------------------ phase 12
    log("phase 12: mutable tenants (deltas, repacks, the result cache)")
    t_phase = time.perf_counter()
    state12 = phase12(smoke, args.seed, ds, bms, eng, xds, sds, sbms, seng,
                      epool, price, cols, batches, tenants11)
    phase_time("phase 12", t_phase)

    # ------------------------------------------------------------ phase 14
    log("phase 14: the serving stack (ServingLoop, the ring lane, the wire, "
        "durable tenants)")
    t_phase = time.perf_counter()
    state14 = phase14(smoke, args.seed, tenants11)
    phase_time("phase 14", t_phase)

    # ------------------------------------------------------------ phase 15
    log("phase 15: observability (spans, cost and memory events, SLO, "
        "flight, statusz)")
    t_phase = time.perf_counter()
    fractions15, sets15 = phase15(smoke, args.seed, state14, ds, sds, epool,
                                  bms)
    phase_time("phase 15", t_phase)

    # ------------------------------------------------------------ phase 16
    log("phase 16: mesh and pod (sharded wide ops and value columns, the "
        "sharded engine, the pod front door, migration, process groups)")
    t_phase = time.perf_counter()
    phase16(smoke, args.seed, shapes, adhoc, abms, lift, bsi9, sbms, price,
            sets15, state14[0], state14[1])
    del state14, sets15, bsi9
    torch.cuda.empty_cache()
    phase_time("phase 16", t_phase)

    # ------------------------------------------------------------ phase 18
    log("phase 18: the rest of the host tier (immutable sources on the wide "
        "path, resident sets and value columns; navigable maps; the writer "
        "and RoaringBitSet)")
    t_phase = time.perf_counter()
    phase18(smoke, bms, abms, union, sbms, price, ts, batches, epool, lift)
    torch.cuda.empty_cache()
    phase_time("phase 18", t_phase)

    # ------------------------------------------------------------ phase 17
    log("phase 17: the engine leftovers (flagship, evaluate, the chained "
        "batch probe, torch-vmap, node at a time, explain, delta graphs)")
    t_phase = time.perf_counter()
    phase17(smoke, args.seed, shapes, union, adhoc, ds, bms[:256], eng,
            flat, sds, seng, epool, xsds, xpool, tenants11, state12)
    del state12
    torch.cuda.empty_cache()
    phase_time("phase 17", t_phase)

    # ------------------------------------------------------------ phase 6
    log("phase 6: each kernel against its plain version "
        "(tolerance: bit-exact, max_abs_err must be 0)")
    t_phase = time.perf_counter()
    # what the host's share of a timed call runs beside
    import gc
    import threading
    others = sorted(t.name for t in threading.enumerate()
                    if t is not threading.main_thread())
    log(f"  the process: {len(others)} other Python threads {others[:6]}, "
        f"{len(gc.get_objects())} objects under gc, load "
        f"{os.getloadavg()[0]:.2f} on {os.cpu_count()} cores")
    rows_out = []
    #: each kernel's share of its bound at its first phase 6 shape
    bound_share: dict = {}

    def row_bytes(starts, ends, per_row):
        return int((ends - starts).sum()) * per_row

    #: the port's PR 14 times of B1's and B2's rows (PERF.md; NVIDIA H100
    #: 80GB HBM3, 700.00 W), printed beside this run's
    pr14_ms = {"segmented_reduce": 0.4493, "segmented_reduce@1024": 0.1632,
               "segmented_reduce@512": 0.1866,
               "segmented_reduce@256": 0.1731,
               "segmented_reduce_blocked": 1.2557}

    def record(kernel, run, plain, bytes_moved, ops, shape_note, emit=True,
               steps=None, name=None, launches=None, b1_args=None):
        """Hold ``run`` bit-equal to ``plain``, time them, and add the
        kernel's row to the kernels line (``name`` / ``launches`` for a
        variant's row: B1 at a narrow width, B5 in combine mode)."""
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        require(err == 0, f"{kernel.name}: kernel != plain (max err {err})")
        ms = timed_ms(torch, run, 20)
        plain_ms = timed_ms(torch, plain, 3)
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        bound_share.setdefault(name or kernel.name, bound / ms)
        per_step = f", {ms * 1e3 / steps:.4f} us a step" if steps else ""
        before = pr14_ms.get(name or kernel.name)
        then = (f" (PR 14: {before:.4f} ms, {bound / before:.1%})"
                if before else "")
        if b1_args:
            # the host's share of the call (the same launch from a graph),
            # the host's own time, and the device part at half and twice
            # the wrapper's blocks an SM (chunk rows of twice and half as
            # many SMs)
            alone = graph_ms(torch, run, 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                run()
            host_us = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            op_, w_, s_, k_ = b1_args
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            per_sm = []
            for label, n in (("half", sms // 2), ("twice", 2 * sms)):
                rows_ = kernels.b1_chunk_rows(w_.shape[0], w_.shape[1],
                                              k_, n)

                def other(rows_=rows_):
                    return kernels._launch_chunked(kernels.B1, op_, w_, s_,
                                                   k_, rows_)
                err_o = max_abs_err(torch, other(), want)
                require(err_o == 0, f"{name or kernel.name}: {label} the "
                        f"blocks an SM != plain (max err {err_o})")
                per_sm.append(f"{label}: {graph_ms(torch, other, 20):.4f} "
                              f"ms at {rows_} rows a chunk")
            then += (f", device part alone {alone:.4f} ms "
                     f"({bound / alone:.1%}, one graph replay at "
                     f"{kernels.b1_chunk_rows(w_.shape[0], w_.shape[1], k_, sms)}"
                     f" rows a chunk; "
                     f"{'; '.join(per_sm)}), host {host_us:.1f} us a call")
        log(f"  {name or kernel.name} [{shape_note}]: {ms:.4f} ms{then}, "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bytes_moved} bytes), {bound / ms:.1%} of bound{per_step}")
        if emit:
            rows_out.append({
                "name": name or kernel.name, "route": "cuda",
                "source": f"roaringbitmap_tpu_torch/ops/csrc/{kernel.source}",
                "replaces": kernel.replaces,
                "launches": (smoke.launches[kernel.name] if launches is None
                             else launches),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None})

    # B1: ragged reduce at the or_cardinality shape
    pk = shapes["segmented_reduce"]
    w1, s1 = as_i32(pk.words, "cuda"), as_i32(pk.seg_ids, "cuda")
    k1 = pk.num_keys
    b1 = pk.m * 8192 + s1.numel() * 4 + k1 * (8192 + 4)
    record(kernels.B1,
           lambda: kernels.segmented_reduce("or", w1, s1, k1),
           lambda: kernels.segmented_reduce_plain("or", w1, s1, k1),
           b1, pk.m * 2048, f"rows {pk.words.shape[0]}, K {k1}",
           b1_args=("or", w1, s1, k1))
    # B1 at the row widths a "lanes" axis hands each shard (16a)
    for width in (1024, 512, 256):
        wn, sn, kn, shape = shapes.pop(f"segmented_reduce_w{width}")
        wn, sn = as_i32(wn, "cuda"), as_i32(sn, "cuda")
        bn = (wn.shape[0] * width * 4 + sn.numel() * 4
              + kn * (width * 4 + 4))
        record(kernels.B1,
               lambda wn=wn, sn=sn, kn=kn:
               kernels.segmented_reduce("or", wn, sn, kn),
               lambda wn=wn, sn=sn, kn=kn:
               kernels.segmented_reduce_plain("or", wn, sn, kn),
               bn, wn.shape[0] * width,
               f"width {width} words: {wn.shape[0]} rows, K {kn} (a shard "
               f"of 16a's {shape} mesh over its dense pack)",
               name=f"segmented_reduce@{width}",
               launches=smoke.variants.get((kernels.B1.name, width), 0),
               b1_args=("or", wn, sn, kn))
    # B1 at the largest op group of 11a's Q 64 pooled launch
    opp, wp, sp, kp = shapes.pop("segmented_reduce_pooled")
    runs = torch.bincount(sp.long(), minlength=kp + 1)[:kp]
    record(kernels.B1,
           lambda: kernels.segmented_reduce(opp, wp, sp, kp),
           lambda: kernels.segmented_reduce_plain(opp, wp, sp, kp),
           wp.shape[0] * 8192 + sp.numel() * 4 + kp * (8192 + 4),
           wp.shape[0] * 2048,
           f"11a Q64 pooled op group ({opp}): {wp.shape[0]} rows, "
           f"{kp} segments of {int(runs.min())}-{int(runs.max())} rows",
           name="segmented_reduce@pooled",
           launches=shapes.pop("segmented_reduce_pooled_launches"),
           b1_args=(opp, wp, sp, kp))
    del wp, sp
    # B2: blocked reduce at the dense set's shape
    w2, blk2, k2, block2 = shapes["segmented_reduce_blocked"]
    real2 = int((blk2 < k2).sum()) * block2
    b2 = real2 * 8192 + blk2.numel() * 4 + k2 * (8192 + 4)
    record(kernels.B2,
           lambda: kernels.segmented_reduce_blocked("or", w2, blk2, k2, block2),
           lambda: kernels.segmented_reduce_blocked_plain("or", w2, blk2, k2,
                                                          block2),
           b2, real2 * 2048,
           f"rows {w2.shape[0]}, block {block2}, K {k2}")
    # B3: chunk densify at the compact set's shape
    cv3, cr3, nrows3, bounds3 = shapes["densify_chunks"]
    b3 = cv3.numel() * 4 + cr3.numel() * 4 + nrows3 * 8192
    record(kernels.B3,
           lambda: (kernels.densify_chunks(cv3, cr3, nrows3, bounds3),),
           lambda: (kernels.densify_chunks_plain(cv3, cr3, nrows3),),
           b3, cv3.numel() * 4,
           f"chunks {cv3.shape[0]}, rows {nrows3}; wrapper with the set's "
           f"bounds, as the main path calls it: the kernel alone, no zero "
           f"fill")
    # B4: counts reduce at the counts set's shape
    c4, g4, k4 = shapes["counts_segmented_reduce"]
    st4, en4 = kernels.segment_ranges(g4, k4)
    b4 = row_bytes(st4, en4, 4 * 8192) + g4.numel() * 4 + k4 * (8192 + 4)
    record(kernels.B4,
           lambda: kernels.counts_segmented_reduce("xor", c4, g4, k4),
           lambda: kernels.counts_segmented_reduce_plain("xor", c4, g4, k4),
           b4, int((en4 - st4).sum()) * 2048 * 40,
           f"groups {c4.shape[0]}, K {k4}")
    # B7: stream reduce at the uscensus2000_like cell's shape (109 segments
    # of 200 bitmaps over 600 keys), beside B4 over the same set's counts
    t0 = time.perf_counter()
    uds = DeviceBitmapSet([RoaringBitmap.from_values(v)
                           for v in uscensus_like_values(109)])
    plan7, k7, s7 = uds._stream_plan, uds.keys.size, uds._streams
    require(uds.layout == "counts" and uds.reduce_path == "streams",
            f"B7's set: {uds.layout} layout, {uds.reduce_path} path")
    log(f"  B7's set: {uds.n} bitmaps, K {k7}, {plan7.values} values, "
        f"{plan7.dense_rows} dense rows, {plan7.pieces.shape[0]} pieces, "
        f"groups {uds.counts.shape[0]}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    smoke.main_path("B7's set xor", lambda: uds.aggregate_device("xor"))
    require(smoke.last[kernels.B7.name] == 1,
            f"B7's set xor: launches {smoke.last}")

    def run7():
        return kernels.stream_segmented_reduce("xor", *s7, uds.seg_ids,
                                               plan7, k7)
    b7 = kernels.b7_launch_bytes(plan7.values, plan7.dense_rows, k7)
    record(kernels.B7, run7,
           lambda: kernels.stream_segmented_reduce_plain("xor", *s7,
                                                         uds.seg_ids, k7),
           b7, plan7.values,
           f"K {k7}, {plan7.values} values, {plan7.dense_rows} dense rows "
           f"(uscensus2000_like)")
    # B7 against B4, each alone, on both sides of the rule: B7's set, and
    # phase 3's counts set over bitmap containers, where the rule keeps B4
    b7_and_b4_alone(torch, kernels, uds, "B7's set")
    b7_and_b4_alone(torch, kernels, fds, "phase 3's bitmap-container set")
    del uds, s7, plan7, fds
    torch.cuda.empty_cache()
    # B6: fused nibble reduce at the 8a set's shape (or)
    nds = shapes.pop("fused_nibble_reduce")
    c6 = dense.nibble_counts_impl(*nds._streams[2:], nds._n_groups,
                                  nds._total_values)
    dp6 = dense.dense_partial_impl("or", nds._streams[0], nds._dseg,
                                   *nds._dmeta, nds.keys.size)
    g6, k6 = nds._grp_seg, nds.keys.size
    del nds
    st6, en6 = kernels.segment_ranges(g6, k6)
    b6 = (row_bytes(st6, en6, 4 * 8192) + g6.numel() * 4
          + k6 * 8192 + k6 * (8192 + 4))
    record(kernels.B6,
           lambda: kernels.fused_nibble_reduce("or", c6, dp6, g6, k6),
           lambda: kernels.fused_nibble_reduce_plain("or", c6, dp6, g6, k6),
           b6, int((en6 - st6).sum()) * 2048 * 40,
           f"groups {c6.shape[0]}, K {k6}")
    del c6, dp6

    # B5: the 7b plan, then a random stream over all 20 opcodes
    mega5, words5 = shapes["megakernel"]
    banks5 = (words5, mega5.device_arrays(words5.device)["extra"],
              torch.zeros((1, WORDS32), dtype=torch.int32,
                          device=words5.device))
    record(kernels.B5, lambda: megakernel.raw_call(mega5, *banks5),
           lambda: megakernel.raw_call_plain(mega5, *banks5),
           megakernel.stream_bytes(mega5), mega5.n_steps * WORDS32,
           f"7b plan, {mega5.n_steps} steps, {mega5.n_slots} slots",
           steps=mega5.n_steps)
    megac, *banksc = shapes.pop("megakernel_combine")
    record(kernels.B5, lambda: megakernel.raw_call(megac, *banksc),
           lambda: megakernel.raw_call_plain(megac, *banksc),
           megakernel.stream_bytes(megac), megac.n_steps * WORDS32,
           f"16c combine-mode plan, {megac.n_steps} steps, "
           f"{megac.n_slots} slots, bank 0 {banksc[0].shape[0]} head rows, "
           f"{megac.leaf_rows} leaf rows", steps=megac.n_steps,
           name="megakernel@combine",
           launches=smoke.variants.get((kernels.B5.name, "combine"), 0))
    mega9, words9 = shapes.pop("megakernel_value")
    arrs9 = mega9.device_arrays(words9.device)
    banks9 = (words9, arrs9["extra"], arrs9["cols"])
    record(kernels.B5, lambda: megakernel.raw_call(mega9, *banks9),
           lambda: megakernel.raw_call_plain(mega9, *banks9),
           megakernel.stream_bytes(mega9), mega9.n_steps * WORDS32,
           f"9a plan, {mega9.n_steps} steps, {mega9.n_slots} slots, "
           f"{mega9.col_rows} bank-2 rows, {mega9.n_vscan} vscan, "
           f"{mega9.n_vagg} vagg", emit=False, steps=mega9.n_steps)
    rmega, rbanks = megakernel.random_plan(
        args.seed, n_steps=4096, slots_pad=1024, out_pad=64, card_pad=256,
        bank_rows=(1024, 64, 64))
    rbanks = [as_i32(b, "cuda") for b in rbanks]
    record(kernels.B5, lambda: megakernel.raw_call(rmega, *rbanks),
           lambda: megakernel.raw_call_plain(rmega, *rbanks),
           megakernel.stream_bytes(rmega), rmega.n_steps * WORDS32,
           f"random all-opcode stream, {rmega.n_steps} steps", emit=False,
           steps=rmega.n_steps)
    phase_time("phase 6", t_phase)
    for label, ks, frac, raw in fractions15:
        log(f"  15b beside 6 [{card_line}]: {label}: roofline fraction of "
            f"the whole dispatch {frac} (raw {raw}) against "
            + ", ".join(f"{k} alone {bound_share[k]:.1%} of its bound"
                        for k in ks))

    # ------------------------------------------------------------ phase 19
    log("phase 19: B8 at the dense cells' full builds")
    t_phase = time.perf_counter()
    rows_out += phase19(torch, kernels, packing, args.seed)
    phase_time("phase 19", t_phase)

    for name, c in smoke.launches.items():
        require(c > 0, f"kernel {name} was never launched on the main path")
    for key in ((kernels.B1.name, 1024), (kernels.B1.name, 512),
                (kernels.B1.name, 256), (kernels.B5.name, "combine")):
        require(smoke.variants.get(key, 0) > 0,
                f"kernel variant {key} was never launched on the main path")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows_out}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
