"""The generator is deterministic from the seed, every seed gives the same
sizes, and each configuration has the shape its file records."""

import hashlib
import json

import numpy as np
import pytest

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


#: sha256 of ``segment_bytes``' bytes and then its lengths as i64, made by
#: the generator before it could write run containers: the configurations
#: without run keys keep their bytes
FROZEN = {
    ("census1881_like", 0, 7): "16398e64004520dee2311a08602d9940147ce26139f9a1634c46117b408887f6",
    ("census1881_like", 0, 2147483659): "ef2d281c75eca33fd18cdbeb21d4ad201e8b7ce179864ef69fda1ac6b385c503",
    ("census1881_like", 0, 1099511627779): "e7749ae6dc499657d74e0c18d86797b9d156e903b076e86cffe390ecea98d529",
    ("census1881_like", 127, 7): "651655412d2ad55e946b20caf24872c182d54c59e93f64c1e9e180f79063d28f",
    ("census1881_like", 127, 2147483659): "7353a52e93d14551742845cbab29a8ee904d6e066da7ee5f76653ba195f337bc",
    ("census1881_like", 127, 1099511627779): "2f8aa23591ea290e085eaaa010d5b33621452bd2de1a411e38575aa7b0ee5e77",
    ("uscensus2000_like", 0, 7): "27a9d0fe0aac71594fa7c1c7eabbe0c6b9443469c838bac0dfb51653e0affd00",
    ("uscensus2000_like", 0, 2147483659): "0b80f91d148b89662eff8d92ec97aecf36844730f7ef4f377fe2edf08270e642",
    ("uscensus2000_like", 0, 1099511627779): "dd4ee93a71f2b58ceb4d58dd5932d91ad7d78f40286382290593e1340b8ac66b",
    ("uscensus2000_like", 108, 7): "fcfd07ccaf001a37dc6b59ec0c9afc9c3902f0bd8512169f1846be49326d063d",
    ("uscensus2000_like", 108, 2147483659): "e30ff1ccceb39a20076a252498e37fb3d3fc411396717fb69e94a557e3e8574a",
    ("uscensus2000_like", 108, 1099511627779): "a4975aa7e26a2a77cbd2b1ab19c5b2edfcceedd0fb4f5569d710ca78db52bdc4",
}


@pytest.mark.parametrize("name", ["census1881_like", "uscensus2000_like"])
def test_existing_bytes_are_frozen(name):
    cfg = _cfg(name)
    for (n, s, seed), want in FROZEN.items():
        if n != name:
            continue
        blob, lens = gen.segment_bytes(cfg, s, seed)
        got = hashlib.sha256(blob.tobytes()
                             + lens.astype("<i8").tobytes()).hexdigest()
        assert got == want, (s, seed)


def _bitmaps(cfg, segment, seed):
    """(bytes, the shape's slice) of each bitmap of one segment."""
    shape = gen.segment_shape(cfg, segment)
    blob, lens = gen.segment_bytes(cfg, segment, seed)
    ends, cend = np.cumsum(lens), np.cumsum(shape.n_cont)
    for b, (n, e) in enumerate(zip(lens.tolist(), ends.tolist())):
        c = slice(int(cend[b] - shape.n_cont[b]), int(cend[b]))
        yield blob[e - n:e].tobytes(), shape, c


def _payload_bytes(buf, offs, cards, runs):
    """Each container's payload size, read from its header and payload."""
    return np.array([2 + 4 * int(np.frombuffer(buf, "<u2", 1, o)[0]) if r
                     else (2 * c if c <= gen.ARRAY_MAX else 8192)
                     for o, c, r in zip(offs.tolist(), cards.tolist(),
                                        runs.tolist())], np.int64)


def _headers_card(shape, c, cards):
    """The shape's cardinalities, with those of random bitmap containers
    (drawn with the members) as the header has them."""
    want = shape.card[c].copy()
    want[shape.is_bitmap[c]] = cards[shape.is_bitmap[c]]
    return want


def test_run_bitmaps_parse_with_their_flags():
    """Cookie 12347 and the run flags where a bitmap has a run container,
    12346 elsewhere; the offset header only from 4 containers on; every
    kind of bitmap appears."""
    seen = set()
    for s in range(minibench.RUN_CONFIG["segments"]):
        for buf, shape, c in _bitmaps(minibench.RUN_CONFIG, s, 3):
            keys, cards, offs, runs = reference.parse(buf)
            n = keys.size
            assert np.array_equal(runs, shape.is_run[c])
            assert np.array_equal(cards, _headers_card(shape, c, cards))
            cookie = int(np.frombuffer(buf, "<u4", 1, 0)[0])
            if runs.any():
                assert cookie == gen.COOKIE_RUNS | (n - 1) << 16
                head = 4 + (n + 7) // 8 + 4 * n + (4 * n if n >= 4 else 0)
            else:
                assert cookie == gen.COOKIE_NO_RUNS
                head = 8 + 8 * n
            assert offs[0] == head
            assert len(buf) == head + _payload_bytes(buf, offs, cards,
                                                     runs).sum()
            seen.add((bool(runs.any()), min(n, 4)))
    assert {(True, k) for k in (1, 2, 3, 4)} <= seen
    assert (False, 4) in seen


def test_runs_are_canonical_and_smallest():
    n_run = n_other = 0
    for s in range(minibench.RUN_CONFIG["segments"]):
        for buf, shape, c in _bitmaps(minibench.RUN_CONFIG, s, 2**40 + 9):
            _, cards, offs, runs = reference.parse(buf)
            for o, card, r in zip(offs.tolist(), cards.tolist(),
                                  runs.tolist()):
                if not r:
                    continue
                nr = int(np.frombuffer(buf, "<u2", 1, o)[0])
                pairs = np.frombuffer(buf, "<u2", 2 * nr, o + 2).astype(
                    np.int64).reshape(nr, 2)
                start, end = pairs[:, 0], pairs[:, 0] + pairs[:, 1]
                assert nr >= 1 and end[-1] <= 65535
                assert np.all(start[1:] > end[:-1] + 1)
                assert int((end - start + 1).sum()) == card
                array_form = 2 * card if card <= gen.ARRAY_MAX else 8192
                assert 2 + 4 * nr < min(array_form, 8192)
                n_run += 1
            # drawn as runs but written otherwise: the run form does not pay
            other = (shape.runs[c] > 0) & ~runs
            form = np.where(cards <= gen.ARRAY_MAX, 2 * cards, 8192)
            assert np.all(2 + 4 * shape.runs[c][other] >= form[other])
            n_other += int(other.sum())
    assert n_run > 20 and n_other > 5


def test_run_shapes_do_not_follow_the_seed():
    """Which containers are runs, their cardinalities and run counts are
    the same for two seeds; the members differ."""
    cfg = minibench.RUN_CONFIG
    for s in range(cfg["segments"]):
        a = list(_bitmaps(cfg, s, 11))
        b = list(_bitmaps(cfg, s, 12))
        assert [x[0] for x in a] != [y[0] for y in b]
        for (bx, shape, c), (by, _, _) in zip(a, b):
            kx, cx, ox, rx = reference.parse(bx)
            ky, cy, oy, ry = reference.parse(by)
            assert np.array_equal(kx, ky) and np.array_equal(rx, ry)
            drawn = shape.runs[c] > 0
            assert np.array_equal(cx[drawn], cy[drawn])
            assert [int(np.frombuffer(bx, "<u2", 1, o)[0])
                    for o in ox[rx].tolist()] == \
                [int(np.frombuffer(by, "<u2", 1, o)[0])
                 for o in oy[ry].tolist()]


def test_run_keys_leave_the_other_shapes():
    """The run draw has a generator of its own: the keys, the bitmap
    containers and the cardinalities of the others are those drawn
    without the run keys."""
    cfg = minibench.RUN_CONFIG
    plain = {k: v for k, v in cfg.items() if not k.startswith("run_")}
    for s in range(cfg["segments"]):
        x, y = gen.segment_shape(cfg, s), gen.segment_shape(plain, s)
        assert np.array_equal(x.keys, y.keys)
        assert np.array_equal(x.is_bitmap, y.is_bitmap)
        assert not y.runs.any()
        drawn = x.runs > 0
        assert drawn.any()
        assert np.array_equal(x.card[~drawn], y.card[~drawn])


def test_run_card_past_65536_is_refused():
    cfg = dict(minibench.RUN_CONFIG,
               run_card={"dist": "loguniform", "lo": 1, "hi": 65537})
    with pytest.raises(ValueError):
        gen.segment_shape(cfg, 0)
