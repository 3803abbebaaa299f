"""Whether what the timed path produced is correct: the program's answers
against the plain reference (``reference.py``), compared exactly.

Every number compared counts answers that differ, or that never came, so
each limit is 0: the configurations guarantee exact results.

A wide cell compares every op's cardinality (``card_mismatch``); the
per-key heads and cardinalities of the kept ops, one of each kind drawn
from the seed and the window's last, against the reference's, word by word
over the union of both key sets (``word_mismatch``, ``key_card_mismatch``);
and ops with no answer (``unanswered``).  An XOR over the whole set is the
parity of every resident container's bits, so any bit the set-up lost or
added in any row shows there.
"""

from __future__ import annotations

import numpy as np

from . import reference

LIMITS = {"card_mismatch": 0, "word_mismatch": 0, "key_card_mismatch": 0,
          "unanswered": 0}


def _heads_gap(keys: np.ndarray, words: np.ndarray, cards: np.ndarray,
               ref) -> tuple[int, int]:
    """(differing words, differing per-key cardinalities) between the
    program's heads over ``keys`` and the reference's result, over the
    union of both key sets (a key one side lacks reads as zeros there)."""
    rk, rw, rc = ref
    o = np.argsort(keys, kind="stable")
    keys, words, cards = keys[o].astype(np.int64), words[o], cards[o]
    rk = rk.astype(np.int64)
    if np.array_equal(keys, rk):
        return (int(np.count_nonzero(words != rw)),
                int(np.count_nonzero(cards != rc)))
    mine, theirs = np.isin(keys, rk), np.isin(rk, keys)
    dw = (np.count_nonzero(words[mine] != rw[theirs])
          + np.count_nonzero(words[~mine]) + np.count_nonzero(rw[~theirs]))
    dc = (np.count_nonzero(cards[mine] != rc[theirs])
          + np.count_nonzero(cards[~mine]) + np.count_nonzero(rc[~theirs]))
    return int(dw), int(dc)


def wide(answers: dict, keys: np.ndarray, dec) -> dict:
    """The wide cell's numbers.  ``answers['heads']`` holds host copies:
    {op index: (u32[K, 2048] words, i64[K] cards)} over ``keys``."""
    ops, cards = answers["ops"], answers["cards"]
    refs = {op: reference.wide(op, dec) for op in sorted(set(ops))}
    totals = {op: int(r[2].sum()) for op, r in refs.items()}
    card_bad = sum(1 for op, c in zip(ops, cards) if c != totals[op])
    word_bad = key_bad = 0
    for j, (w, c) in answers["heads"].items():
        dw, dc = _heads_gap(keys, w, c, refs[ops[j]])
        word_bad += dw
        key_bad += dc
    return {"card_mismatch": card_bad, "word_mismatch": word_bad,
            "key_card_mismatch": key_bad,
            "unanswered": len(ops) - len(cards)}


def verdict(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())


def lines(numbers: dict) -> list[str]:
    return [f"{k} {v} (limit {LIMITS[k]})" for k, v in numbers.items()]


def as_json(numbers: dict) -> dict:
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
