"""Tree helpers and the closed-form cost model.

The reference's ``utils/hlo.py`` and ``utils/compat.py`` are XLA and jax
shims (HLO text parsing, jax version shims) with no torch counterpart;
its ``utils/roofline.py`` reads compiled XLA artifacts and waits for the
port's mesh work (ROADMAP.md §1).
"""
from repro_torch.utils import analytic, tree  # noqa: F401
