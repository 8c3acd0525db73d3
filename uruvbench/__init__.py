"""uruvbench — the benchmark of the PyTorch port of Uruv (``repro_torch``).

``run.py`` is the command; ``harness`` runs one cell; ``generator`` makes
every key, plan and request from the seed; ``loops`` drives the port's
entry points through the window; ``reference`` is the plain NumPy map
that ``compare`` holds every answer to; ``devtrace`` reads the traced
run's device trace; ``roofline`` counts the least bytes of a plan's
work.  Cells, configurations, traffic mixes and metric readers are data
found by name: ``BENCHMARK.json``, ``configs/``, ``traffic/``,
``metrics/``.  Nothing here imports JAX or the JAX package.
"""
