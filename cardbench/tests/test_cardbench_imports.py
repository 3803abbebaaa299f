"""No module the benchmark loads has the top-level name jax, jaxlib, flax
or roaringbitmap_tpu, compared whole; the reference loads nothing of the
program."""

import subprocess
import sys
import textwrap

from cardbench import run

import minibench


def _python(code: str) -> str:
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=minibench.REPO, capture_output=True, text=True,
                       timeout=600, env={"PATH": "/usr/bin:/bin",
                                         "PYTHONPATH": str(minibench.REPO),
                                         "HOME": "/tmp"})
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_forbidden_module(tmp_path):
    root = minibench.make_root(tmp_path)
    out = _python(f"""
        import time, torch
        from pathlib import Path
        from cardbench import run, spec
        root = Path({str(root)!r})
        for w in {minibench.workloads()!r}:
            cell = spec.resolve(w, root)
            run.run(cell, 5, 0.2, True, torch, torch.device("cpu"), root,
                    t_start=time.perf_counter())
        print(run.forbidden_modules())
    """)
    assert out == "[]"


def test_the_reference_loads_nothing_of_the_program():
    out = _python("""
        import sys
        from cardbench import check, control, gen, reference, work
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"jax", "roaringbitmap_tpu",
                        "roaringbitmap_tpu_torch"}))
    """)
    assert out == "[]"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "roaringbitmap_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "roaringbitmap_tpu.ops", sys)
    assert run.forbidden_modules() == ["roaringbitmap_tpu"]
