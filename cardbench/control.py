"""The control of the check: the plain reference put in the program's place,
breaking the one guarantee the configurations state (exact results: every
container of every resident bitmap counts).  It has to come out as not
correct, on every seed, at the cell's own size.

The reference answers every op over the set with one container left out,
drawn from the seed (a layout or a pack that drops a row).

    python3 -m cardbench.control --workload <name> --seeds 11,12,13

prints, for each seed, the numbers ``check`` compares and whether they
pass their limits.  It runs on the host alone; the benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import check, gen, reference


def wide_answers(ops: list, dec, seed: int):
    """The control's answers to ``ops``, in the form the harness hands the
    check: (answers, keys).  One container of the set, drawn from the
    seed, is left out of every op."""
    rng = gen._rng(seed, 0xD20)
    lossy = dec.without(int(rng.integers(0, dec.keys.size)))
    results = {op: reference.wide(op, lossy) for op in sorted(set(ops))}
    keys = np.unique(np.concatenate([r[0] for r in results.values()]))
    heads = {}
    for op in results:
        j = ops.index(op)
        rk, rw, rc = results[op]
        w = np.zeros((keys.size, reference.WORDS32), np.uint32)
        c = np.zeros(keys.size, np.int64)
        idx = np.searchsorted(keys, rk)
        w[idx], c[idx] = rw, rc
        heads[j] = (w, c)
    answers = {"ops": list(ops),
               "cards": [int(results[op][2].sum()) for op in ops],
               "heads": heads}
    return answers, keys


def readings(cell, seed: int, n_ops: int = 32) -> dict:
    """The control's numbers for one seed of ``cell``."""
    dec = reference.decode_set(gen.dataset_bytes(cell.config, seed))
    ops = gen.wide_ops(cell.traffic, seed, n_ops)
    answers, keys = wide_answers(ops, dec, seed)
    return check.wide(answers, keys, dec)


def main(argv=None) -> int:
    from . import spec

    ap = argparse.ArgumentParser(prog="cardbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    for s in (int(x) for x in args.seeds.split(",")):
        nums = readings(cell, s)
        print(json.dumps({"workload": cell.name, "seed": s,
                          "correct": check.verdict(nums), "checks": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
