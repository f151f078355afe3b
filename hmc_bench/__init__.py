"""The benchmark of the PyTorch and CUDA port (``schwingermodel_tpu_torch``).

``run.py`` runs one cell; ``BENCHMARK.json`` at the root of the repository
names the cells, whose files live under ``configs/``, ``traffic/``,
``limits/`` and ``metrics/``; ``reference/`` is the plain reference the
check compares with; ``yardstick.py`` holds the peaks and the counts of the
algorithm's work.
"""
