"""The benchmark of the PyTorch + CUDA port (``astrophotography_tpu_torch``).

``python3 -m stackbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  The cells'
configurations (``configs/``), traffic mixes and their generators
(``traffic/``) and metric readers (``metrics/``) are found by name
(``registry``).  The yardstick lives here too and imports nothing of the
program: the workload made from the seed (``workload``), the count-once
bytes and operations and the card's peaks (``counts``), the plain
reference and the comparison that decides ``correct`` (``reference``).
``limits`` gives the readings each limit is set from.  The CPU tests are
``python -m pytest stackbench/tests``.
"""
