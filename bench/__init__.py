"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``bench/configs/<config>.json`` -- a graph deployment; its ``generator``
  key names the module of ``bench/gen/`` that makes the edge list;
* ``bench/traffic/<mix>.json`` -- the parameters of a query mix, read by
  the one traffic generator (``bench/traffic.py``);
* ``bench/metrics/<metric>.py`` -- the reader of one metric.

The yardstick lives here: the generators, the plain reference
(``reference.py``), the comparison and its limits (``check.py``), the
trace reduction (``trace.py``) and the table of peaks (``peaks.json``).
Nothing in this package imports ``jax`` or the JAX package ``repro``.
"""
