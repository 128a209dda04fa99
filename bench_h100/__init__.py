"""The benchmark of ``boosting_nerv_torch`` on an NVIDIA H100.

``run.py`` runs one cell once; ``harness`` finds a cell's files by the
names in ``BENCHMARK.json``; ``drivers`` is the generator of every mix;
``inputs`` makes the weights, embeddings and clips from the seed;
``counts`` counts operations and bytes from the configurations' shapes;
``trace`` reads the profiler's trace; ``reference`` is the plain
reference; ``control.py`` reads the program's and the controls' numbers
over many seeds, for setting the limits.  Nothing here imports JAX or
the JAX package, and ``reference`` imports nothing of the program.
"""
