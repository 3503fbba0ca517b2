"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py`` and the plain reference of
a configuration's family, ``reference/<family>.py``.
"""
