"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 qbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  What
belongs to one configuration, traffic mix or metric is found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``metrics/<metric>.py``;
a configuration's ``app`` names its glue in ``apps/<app>.py``.

Nothing here imports JAX or the JAX package ``repro``; the references
under ``ref/`` import nothing of the port either.
"""
