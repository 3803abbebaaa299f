"""Run one cell of the benchmark once.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell's resident set from bytes
made from the seed, warms up the cell's own shapes, measures ``--seconds``
of its traffic, then checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from a
``torch.profiler`` trace and the program's spans (``--trace 1``).

It needs a CUDA device: without one, or with fewer than the cell asks for,
it exits with code 2 and prints no result.  The kernels' build cache and
Triton's cache are kept at fixed paths under ``cardbench/.cache``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "roaringbitmap_tpu")


def _fail(msg: str, code: int = 2):
    print(f"cardbench: {msg}", file=sys.stderr)
    sys.exit(code)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _set_caches() -> None:
    """Fixed cache directories inside the checkout, for the program's
    kernel and ingest builds and for Triton."""
    os.environ["ROARING_TPU_COMPILE_CACHE"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    (CACHE / "kernels").mkdir(parents=True, exist_ok=True)
    (CACHE / "triton").mkdir(parents=True, exist_ok=True)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def build(cell, seed: int, torch, device):
    """Set-up: the bytes, the resident set, then the warm-up of the cell's
    own shapes."""
    from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet

    from . import gen, loops, work

    cfg, mix = cell.config, cell.traffic
    if mix["entry"] != "aggregate_device":
        raise ValueError(f"unknown entry {mix['entry']!r}")
    t0 = time.perf_counter()
    sources = gen.dataset_bytes(cfg, seed)
    t1 = time.perf_counter()
    ds = DeviceBitmapSet(sources, layout=cfg["layout"], device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state = {"sources": sources, "ds": ds,
             "phases": {"generate": t1 - t0,
                        "set": time.perf_counter() - t1}}
    t2 = time.perf_counter()
    state["op_bytes"] = work.wide_op_bytes(sources)
    loops.wide(ds, mix, seed, 0.0, 0, torch, warmup=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state["phases"]["warmup"] = time.perf_counter() - t2
    return state


def end_to_end(cell, out, setup_s: float) -> dict:
    """The cell's end-to-end metrics, each from the host clock."""
    values = {"setup_s": setup_s,
              "wide_ops_per_s": out.completed / out.seconds}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(cell, out, dtrace, spans: list, root: Path) -> dict:
    from . import readers, spec

    r = readers.Readings(device=dtrace, work_bytes=out.work_bytes,
                         units=out.units, host_ms=out.host_ms, spans=spans)
    got = {}
    for m in cell.per_layer:
        v = spec.reader(m["name"], root)(r)
        if v is not None:
            got[m["name"]] = {"value": v, "unit": m["unit"]}
    return got


def _host_answers(out) -> None:
    """Copy the kept heads to the host, so the program's state can go."""
    from . import reference

    heads = {}
    for j, (w, c) in out.answers["heads"].items():
        heads[j] = (w.cpu().numpy().view(np.uint32).reshape(
            -1, reference.WORDS32), c.cpu().numpy().astype(np.int64))
    out.answers["heads"] = heads


def run(cell, seed: int, seconds: float, trace: bool, torch, device,
        root: Path, t_start: float = T_START):
    """One run of ``cell`` on ``device``: (result dict, check lines)."""
    from . import check, devtrace, loops, reference

    state = build(cell, seed, torch, device)
    setup_s = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    prof = span_path = None
    if trace:
        from roaringbitmap_tpu_torch.obs import trace as obs_trace
        from torch.profiler import ProfilerActivity, profile

        fd, span_path = tempfile.mkstemp(prefix="cardbench-spans-",
                                         suffix=".jsonl")
        os.close(fd)
        obs_trace.enable(span_path, xprof=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    out = loops.wide(state["ds"], cell.traffic, seed, seconds,
                     state["op_bytes"], torch, trace=trace)
    if cuda:
        torch.cuda.synchronize(device)
    spans, dtrace = [], None
    if trace:
        prof.stop()
        obs_trace.disable()
        with open(span_path) as f:
            spans = [json.loads(line) for line in f if line.strip()]
        os.unlink(span_path)
        dtrace = devtrace.reduce(prof.profiler.kineto_results.events())
        del prof
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    _host_answers(out)
    state["keys"] = np.asarray(state["ds"].keys)
    # the program's state goes before the reference runs
    del state["ds"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.wide(out.answers, state["keys"],
                         reference.decode_set(state["sources"]))
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in state["phases"].items())
    print(f"cardbench: setup {setup_s:.3f} s ({phases}), window "
          f"{out.seconds} s, reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    correct = check.verdict(numbers)
    metrics = (per_layer(cell, out, dtrace, spans, root) if trace
               else end_to_end(cell, out, setup_s))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out.units,
              "failed": numbers.get("unanswered", 0), "metrics": metrics,
              "device": dev}
    if trace and dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.device_ops,
                               "idle_gaps": dtrace.idle_gaps}
    result["checks"] = check.as_json(numbers)
    return result, check.lines(numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cardbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_caches()
    from . import spec

    try:
        cell = spec.resolve(args.workload)
    except (KeyError, OSError) as exc:
        _fail(f"cannot resolve workload: {exc}")
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present")
    try:
        import roaringbitmap_tpu_torch  # noqa: F401
    except ImportError as exc:
        _fail(f"the program is missing: {exc}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, check_lines = run(cell, args.seed, args.seconds,
                              bool(args.trace), torch, device, spec.ROOT)
    bad = forbidden_modules()
    if bad:
        _fail(f"forbidden modules loaded: {', '.join(bad)}", code=3)
    result["device"]["power"] = _power_limit()
    for line in check_lines:
        print(f"check: {line}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
