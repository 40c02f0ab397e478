"""Hand-written CUDA kernels of the port, one package per kernel.

* ``pregel_superstep`` — the fused Pregel superstep (gather -> edge
  program -> masked row reduce over the in-neighbor ELL layout); the
  fused variant of connected components, BFS, SSSP and k-core runs on it.
* ``ell_intersect`` — sorted-row intersection counts over an
  ``OrientedELL`` (the ``intersect`` variant of triangle counting).
* ``ell_combine`` — the ELL gather + monoid combine (``ell_spmv``),
  reading each row's mask first and only the live slots' ids and weights.

Each package holds its plain PyTorch version (``ref.py``), the wrapper
(``ops.py``) and the CUDA source (``csrc/``).
``_build`` compiles the sources with nvcc on first use.
"""
