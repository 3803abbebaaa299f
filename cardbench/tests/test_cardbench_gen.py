"""The generator is deterministic from the seed, every seed gives the same
sizes, and each configuration has the shape its file records."""

import json

import numpy as np

from cardbench import gen, reference

import minibench


def _cfg(name):
    return json.loads((minibench.REPO / "cardbench" / "configs"
                       / f"{name}.json").read_text())


def _headers(blob, lens):
    """Each bitmap's (keys, cardinality - 1) from one segment's bytes."""
    out, pos = [], 0
    for n in lens.tolist():
        b = blob[pos:pos + n].tobytes()
        k = reference.parse(b)
        out.append((k[0], k[1] - 1))
        pos += n
    return out


def test_same_seed_same_bytes_and_sizes_fixed():
    for name in ("census1881_like", "uscensus2000_like"):
        cfg = _cfg(name)
        a, la = gen.segment_bytes(cfg, 5, minibench.SEED)
        b, lb = gen.segment_bytes(cfg, 5, minibench.SEED)
        c, lc = gen.segment_bytes(cfg, 5, minibench.SEED + 1)
        assert np.array_equal(a, b) and np.array_equal(la, lb)
        assert not np.array_equal(a, c)
        # the shapes do not follow the seed: each bitmap's container keys
        # and array cardinalities are the same
        for (kx, cx), (ky, cy) in zip(_headers(a, la), _headers(c, lc)):
            assert np.array_equal(kx, ky)
            small = cx < 4096
            assert np.array_equal(cx[small], cy[small])


def test_views_over_one_buffer_decode_alike():
    cfg = dict(_cfg("census1881_like"), segments=2, attributes=12)
    src = gen.dataset_bytes(cfg, 9)
    assert len(src) == 24
    assert len({id(v.obj) for v in src}) == 1
    blob, lens = gen.segment_bytes(cfg, 1, 9)
    assert b"".join(bytes(v) for v in src[12:]) == blob.tobytes()
    assert [len(v) for v in src[12:]] == lens.tolist()


def test_uscensus2000_like_has_the_recorded_shape():
    """About 0.03 MB serialized and ~5,700 values a segment, every key of
    its span held, a median of 1 container a key and none past 8."""
    cfg = _cfg("uscensus2000_like")
    for s in (0, cfg["segments"] - 1):
        shape = gen.segment_shape(cfg, s)
        blob, _ = gen.segment_bytes(cfg, s, minibench.SEED)
        _, per_key = np.unique(shape.keys, return_counts=True)
        assert per_key.size == cfg["universe_keys"]
        assert np.median(per_key) == 1 and per_key.max() <= 8
        assert 25_000 <= blob.size <= 35_000
        assert 5_000 <= shape.card.sum() <= 6_500
        assert shape.n_cont.min() >= 1
    assert cfg["segments"] * cfg["segment_span_keys"] <= 1 << 16


def test_wide_ops_follow_the_seed():
    w = gen.wide_ops({"ops": {"or": 2, "xor": 1}}, 9, 3000)
    assert w == gen.wide_ops({"ops": {"or": 2, "xor": 1}}, 9, 3000)
    assert w != gen.wide_ops({"ops": {"or": 2, "xor": 1}}, 10, 3000)
    assert 0.6 < w.count("or") / len(w) < 0.73


def test_large_seeds():
    cfg = _cfg("census1881_like")
    assert gen.segment_bytes(cfg, 0, 2**40 + 3)[0].size
    assert gen.segment_bytes(cfg, 0, -5)[0].size
