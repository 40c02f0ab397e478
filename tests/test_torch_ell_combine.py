"""The ELL gather + combine (``ell_spmv``) against the JAX reference
(``repro.kernels.ell_combine``), as ``tests/test_kernels.py`` holds JAX's
Pallas kernel to its oracle: ragged shapes, empty rows, a dense matmul,
masks with holes and inf/NaN behind dead slots (the contract the card
kernel is held to), and the wrapper's checks.

min/max are exact.  A float sum differs from JAX's only in summation
order, so it is held within 1e-6 of the row's sum of absolute terms (a
few float32 ulps of the largest partial sum; a plain rtol fails where
terms cancel).  For CPU tensors the wrapper runs the plain version and
launches nothing; on the card it launches its own kernel
(``csrc/ell_combine.cu``), held against the plain version by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as JP  # noqa: E402
from repro.kernels.ell_combine.ops import ell_spmv as j_spmv  # noqa: E402
from repro.kernels.ell_combine.ref import ell_combine_ref as j_ref  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core.engines import LocalEngine  # noqa: E402
from repro_torch.kernels.ell_combine import ops  # noqa: E402
from repro_torch.kernels.ell_combine.ref import (  # noqa: E402
    ell_combine_plain, ell_combine_ref)
from repro_torch.kernels.pregel_superstep import ops as superstep_ops  # noqa: E402


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _inputs(v, k, vx, seed):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, vx, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.7
    w = rng.standard_normal((v, k)).astype(np.float32)
    x = rng.standard_normal(vx).astype(np.float32)
    return nbr, mask, w, x


def _check(got, want, op, nbr, mask, w, x):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if op == "sum":
        scale = np.where(mask, np.abs(x[np.clip(nbr, 0, x.size - 1)] * w),
                         0.0).sum(axis=1)
        assert (np.abs(got - want) <= 1e-6 * scale + 1e-30).all()
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("v,k,vx", [(64, 16, 80), (300, 37, 400),
                                    (1024, 128, 1024), (17, 200, 33)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_ell_spmv_matches_reference(v, k, vx, op):
    nbr, mask, w, x = _inputs(v, k, vx, v + k)
    before = (ops.KERNEL_LAUNCHES, superstep_ops.KERNEL_LAUNCHES)
    got = ops.ell_spmv(*(torch.from_numpy(a) for a in (nbr, mask, w, x)),
                       op=op)
    assert (ops.KERNEL_LAUNCHES, superstep_ops.KERNEL_LAUNCHES) == before
    j_args = [jnp.asarray(a) for a in (nbr, mask, w, x)]
    for want in (j_spmv(*j_args, op=op), j_ref(*j_args, op=op)):
        _check(got.numpy(), want, op, nbr, mask, w, x)
    ref = ops.ell_spmv_ref(*(torch.from_numpy(a) for a in (nbr, mask, w, x)),
                           op=op)
    assert torch.equal(ref, got)


def test_empty_rows():
    """Vertices without neighbors get the monoid identity."""
    nbr = torch.zeros((8, 4), dtype=torch.int32)
    mask = torch.zeros((8, 4), dtype=torch.bool)
    w = torch.ones((8, 4))
    x = torch.ones(16)
    assert (ops.ell_spmv(nbr, mask, w, x, op="sum") == 0).all()
    assert torch.isposinf(ops.ell_spmv(nbr, mask, w, x, op="min")).all()
    assert torch.isneginf(ops.ell_spmv(nbr, mask, w, x, op="max")).all()
    none = torch.zeros((5, 0), dtype=torch.int32)
    for op, want in (("sum", 0.0), ("min", float("inf")),
                     ("max", float("-inf"))):
        got = ell_combine_plain(none, none.bool(), none.float(), x, op=op)
        assert got.shape == (5,) and (got == want).all()


def test_ell_spmv_matches_dense_matmul():
    """ELL SpMV == dense A @ x for a random sparse matrix."""
    rng = np.random.default_rng(3)
    v, k, vx = 50, 12, 50
    nbr = rng.integers(0, vx, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.5
    w = rng.standard_normal((v, k)).astype(np.float32)
    dense = np.zeros((v, vx), np.float64)
    np.add.at(dense, (np.repeat(np.arange(v), k)[mask.ravel()],
                      nbr.ravel()[mask.ravel()]), w.ravel()[mask.ravel()])
    x = rng.standard_normal(vx).astype(np.float32)
    got = ops.ell_spmv(torch.from_numpy(nbr), torch.from_numpy(mask),
                       torch.from_numpy(w), torch.from_numpy(x), op="sum")
    np.testing.assert_allclose(got.numpy(), dense @ x, rtol=1e-5, atol=1e-5)


def test_unknown_op_rejected():
    args = [torch.from_numpy(a) for a in _inputs(4, 2, 4, 0)]
    with pytest.raises(ValueError, match="unknown op"):
        ell_combine_ref(*args, op="mean")


def test_local_engine_binds_spmv():
    """``LocalEngine._spmv`` is the wrapper with kernels on, the plain
    version off, as the reference binds ``ell_spmv``/``ell_spmv_ref``."""
    g = TG.build_coo(np.array([0, 1, 2]), np.array([1, 2, 0]), 3,
                     symmetrize=True, device="cpu")
    assert LocalEngine(g, device="cpu")._spmv is ops.ell_spmv
    plain = LocalEngine(g, use_kernels=False, device="cpu")
    assert plain._spmv is ops.ell_spmv_ref
    ell = plain.ell
    x = torch.tensor([1.0, 2.0, 3.0])
    assert plain._spmv(ell.nbr, ell.mask, ell.w, x, "sum").tolist() == \
        [5.0, 4.0, 3.0]
    assert plain.for_pool(None) is plain


def _holey(v, k, vx, seed):
    """Masks with holes (the live slots of a row are not a prefix),
    all-dead rows, and negative and sentinel ids, which the clamp maps to
    the ends of ``x``."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-2, vx + 2, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.4
    mask[::5] = False                     # rows without a live slot
    if k > 1:
        mask[1::5, 0] = False             # a hole before live slots
        mask[1::5, -1] = True
    w = rng.standard_normal((v, k)).astype(np.float32)
    x = rng.standard_normal(vx).astype(np.float32)
    return nbr, mask, w, x


@pytest.mark.parametrize("v,k,vx", [(40, 7, 50), (33, 129, 70), (16, 1, 9),
                                    (6, 3000, 400), (25, 128, 25),
                                    (70, 16, 90), (9, 512, 40),
                                    (31, 33, 20)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_ell_spmv_masks_with_holes_match_reference(v, k, vx, op):
    """The contract the kernel is held to: any slot may be live, not only
    a prefix of the row; ids outside [0, Vx) are clamped."""
    nbr, mask, w, x = _holey(v, k, vx, v * k)
    got = ops.ell_spmv(*(torch.from_numpy(a) for a in (nbr, mask, w, x)),
                       op=op)
    want = j_ref(*(jnp.asarray(a) for a in (nbr, mask, w, x)), op=op)
    _check(got.numpy(), want, op, nbr, mask, w, x)
    ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
    assert (got.numpy()[::5] == ident).all()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_dead_slots_hide_inf_and_nan(op):
    """``x`` holds inf and NaN (and ``w`` inf) only behind dead slots:
    ``where(mask, w * x, id)`` never lets them reach the result, as the
    reference does not."""
    v, k, vx = 64, 16, 80
    nbr, mask, w, x = _inputs(v, k, vx, 21)
    x[vx - 2:] = [np.inf, np.nan]
    nbr[mask] %= vx - 2                   # live slots read finite values
    nbr[~mask] = np.where(np.arange(int((~mask).sum())) % 2, vx - 1, vx - 2)
    w[~mask] = np.inf
    got = ops.ell_spmv(*(torch.from_numpy(a) for a in (nbr, mask, w, x)),
                       op=op).numpy()
    want = np.asarray(j_ref(*(jnp.asarray(a) for a in (nbr, mask, w, x)),
                            op=op))
    live_rows = mask.any(axis=1)
    assert np.isfinite(got[live_rows]).all()
    assert not np.isnan(got).any()
    with np.errstate(invalid="ignore"):   # inf * 0 behind dead slots
        _check(got, want, op, nbr, mask, w, x)


def test_kernel_argument_checks_on_any_device():
    """The wrapper's checks run before the device test, so each is seen
    here on CPU tensors; a layout the kernel takes reaches the device
    test, which is what a CPU tensor fails."""
    nbr, mask, w, x = (torch.from_numpy(a) for a in _inputs(6, 4, 6, 0))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.check(nbr, mask, w, x, "sum")
    bad = [((nbr, mask, w, x.double()), "float32"),
           ((nbr, mask, w, x[None]), "1-D"),
           ((nbr.long(), mask, w, x), "int32"),
           ((nbr, mask.int(), w, x), "bool"),
           ((nbr, mask, w[:, :3], x), "float32"),
           ((nbr.t().contiguous().t(), mask, w, x), "contiguous"),
           ((nbr, mask, w, x[:0]), "empty gather source")]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            ops.check(*args, "min")
    with pytest.raises(ValueError, match="unknown op"):
        ops.check(nbr, mask, w, x, "mean")
    wide = torch.empty((0, ops.MAX_K + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        ops.check(wide, wide.bool(), wide.float(), x, "sum")
