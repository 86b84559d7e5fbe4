"""The benchmark of ``molkgnn_torch`` on one NVIDIA H100.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Each
configuration (``configs/<name>.json``), traffic mix (``traffic/<name>.json``),
set of limits (``checks/<workload>.json``), per-layer metric
(``metrics/<name>.py``) and model family's plain reference
(``reference/<family>.py``) is a file of its own, found by its name.
"""
