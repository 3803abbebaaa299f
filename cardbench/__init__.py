"""The benchmark of ``roaringbitmap_tpu_torch`` on one NVIDIA H100.

``BENCHMARK.json`` at the repository root names the cells; one run of one
cell is ``python3 -m cardbench.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>``.  A configuration is a file under ``configs/``, a
traffic mix a file under ``traffic/``, a per-layer metric a reader under
``metrics/``; ``run.py`` finds each by its name (``spec.py``).  The inputs
(``gen.py``), the work counts (``work.py``), the plain reference
(``reference.py``) and the check (``check.py``) are the benchmark's own and
import nothing of the program.  ``control.py`` is the check's control, and
``tests/`` runs the harness on the CPU at a small size.
"""
