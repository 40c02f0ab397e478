"""Hand-written CUDA kernels of the port, one package per kernel.

* ``pregel_superstep`` — the fused Pregel superstep (gather -> edge
  program -> masked row reduce over the in-neighbor ELL layout); the
  fused variant of connected components, BFS and SSSP runs on it.

Each package holds the CUDA source (``csrc/``), its plain PyTorch version
(``ref.py``) and the wrapper (``ops.py``).  ``_build`` compiles the
sources with nvcc on first use.
"""
