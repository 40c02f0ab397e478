"""Tree helpers, the closed-form cost model, partition specs and the
roofline of the dry run.

The reference's ``utils/hlo.py`` and ``utils/compat.py`` are XLA and jax
shims (HLO text parsing, jax version shims) with no torch counterpart;
``utils/roofline.py`` reads the dry run's own counts (``launch/dryrun.py``)
in place of compiled XLA artifacts.
"""
from repro_torch.utils import analytic, tree  # noqa: F401
