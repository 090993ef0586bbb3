"""hpsbench: the benchmark of the PyTorch and CUDA HPS (``hugectr_backend_tpu_torch``).

One run serves one cell of ``BENCHMARK.json`` through the KServe-v2 HTTP
front end and prints one JSON line:

    python3 -m hpsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``configs/<config>.json`` (sizes), ``deploy/<kind>.py``
(how a configuration is written and served), ``traffic/<traffic>.json`` (the
mix), ``limits/<config>.json`` (the limits of the correctness check),
``metrics/<metric>.py`` (one reader per per-layer metric, the part of the
name before the first dot) and ``reference/<kind>.py`` (the plain reference).
Importing this package imports nothing else: the load generator
(``loadgen``) runs in a child process that imports numpy and the standard
library only.
"""
