"""The port's xLSTM (``models/xlstm.py``) against the JAX reference, on
the CPU.

``_mlstm`` and ``_slstm`` over S = 300 (more than the 128-step chunk, no
multiple of it: one scan, as in the reference) and S = 256 (two chunks
of 128, checkpointed under autograd), from a zero state and from a
carried one, with gradients through the chunks; the chunked scan equal
to the plain one; then the reduced model against the reference's
(``tests/torch_lm_cases.py``), whose cache is the recurrent state.
Tolerances: float32, 1e-5 relative for the blocks (summation order),
1e-4 for gradients and models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced_config as jreduced  # noqa: E402
from repro.models.xlstm import XLSTMLM as JX  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.models import xlstm as TXM  # noqa: E402
from repro_torch.models.registry import params_from_numpy  # noqa: E402
import torch_lm_cases as C  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(seed=0):
    jcfg = jreduced(jget_config("xlstm_125m"))
    tcfg = CB.reduced_config(CB.get_config("xlstm_125m"))
    jm = JX(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tm = TXM.XLSTMLM(tcfg, device="cpu",
                     params=params_from_numpy(tcfg, tree, "cpu"))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    tp = {k: v[0].detach() for k, v in tm.params["layers"].items()}
    return jm, tm, jp, tp


def _rel(got, want, tol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(C.as_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _x(tm, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, s, tm.cfg.d_model)).astype(np.float32)


def _states(jm, tm, carried):
    """The first pair's state: zeros (m at -1e30), or one carried from a
    16-token run of the reference."""
    jst = jax.tree_util.tree_map(lambda a: a[0], jm._zero_pair_state(2))
    if carried:
        jp = jax.tree_util.tree_map(lambda a: a[0],
                                    jm.init(jax.random.PRNGKey(0))["layers"])
        x = jnp.asarray(_x(tm, 16, 9))
        _, (mc, mn, mm) = jm._mlstm(jp, x, (jst["mC"], jst["mn"],
                                            jst["mm"]))
        _, (sc, sn, sm, sh) = jm._slstm(jp, x, (jst["sc"], jst["sn"],
                                                jst["sm"], jst["sh"]))
        jst = dict(mC=mc, mn=mn, mm=mm, sc=sc, sn=sn, sm=sm, sh=sh)
    return jst, {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [300, 256])
def test_mlstm_matches_reference(s, carried):
    jm, tm, jp, tp = _setup()
    jst, tst = _states(jm, tm, carried)
    x = _x(tm, s, 1)
    jo, jnew = jm._mlstm(jp, jnp.asarray(x), (jst["mC"], jst["mn"],
                                               jst["mm"]))
    to, tnew = tm._mlstm(tp, torch.from_numpy(x), (tst["mC"], tst["mn"],
                                                    tst["mm"]))
    _rel(to, jo)
    for a, b in zip(tnew, jnew):
        assert a.dtype == torch.float32
        _rel(a, b)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [300, 256])
def test_slstm_matches_reference(s, carried):
    jm, tm, jp, tp = _setup()
    jst, tst = _states(jm, tm, carried)
    x = _x(tm, s, 2)
    keys = ("sc", "sn", "sm", "sh")
    jo, jnew = jm._slstm(jp, jnp.asarray(x), tuple(jst[k] for k in keys))
    to, tnew = tm._slstm(tp, torch.from_numpy(x), tuple(tst[k] for k in keys))
    _rel(to, jo)
    for a, b in zip(tnew, jnew):
        _rel(a, b)


@pytest.mark.parametrize("block", ["_mlstm", "_slstm"])
def test_block_gradients_through_the_chunks_match_reference(block):
    """S = 256: two checkpointed chunks of 128 steps in both packages;
    gradients of a weighted sum of the output with respect to the input
    and the block's weights, float32, 1e-4 of each leaf's largest
    magnitude."""
    jm, tm, jp, tp = _setup(3)
    x = _x(tm, 256, 4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    jst = jax.tree_util.tree_map(lambda a: a[0], jm._zero_pair_state(2))
    keys = ("mC", "mn", "mm") if block == "_mlstm" else ("sc", "sn", "sm",
                                                         "sh")

    def jloss(p, x):
        out, _ = getattr(jm, block)(p, x, tuple(jst[k] for k in keys))
        return jnp.sum(out * w)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    tst = tuple(torch.from_numpy(np.array(jst[k])) for k in keys)
    out, _ = getattr(tm, block)(tp, xt, tst)
    (out * torch.from_numpy(w)).sum().backward()
    _rel(xt.grad, jg_x, 1e-4)
    for k, v in tp.items():
        if v.grad is not None:
            _rel(v.grad, jg_p[k], 1e-4)
    assert tp[block[1] + "_down"].grad is not None


def test_chunked_scan_equals_the_plain_scan():
    """Under autograd, 256 steps in two checkpointed chunks: the same
    carry, outputs and gradients as one plain loop (bit for bit: the same
    operations)."""
    def step(carry, xs):
        (h,), (a,) = carry, xs
        h = torch.tanh(h * 0.9 + a)
        return (h,), h
    a = torch.randn(256, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    (h1,), y1 = TXM._chunked_time_scan(step, (torch.zeros(3),), (a,))
    g1, = torch.autograd.grad(y1.sum() + h1.sum(), a)
    (h2,), y2 = TXM._time_scan(step, (torch.zeros(3),), (a,))
    g2, = torch.autograd.grad(y2.sum() + h2.sum(), a)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("check", sorted(C.MODEL_CHECKS))
def test_model_matches_reference(check):
    C.MODEL_CHECKS[check]("xlstm_125m")


def test_cache_is_the_recurrent_state():
    """O(1) in the cache length: the same shapes at any ``cache_len``,
    float32, ``m`` starting at -1e30; decode updates it in place."""
    _, tm, _, _ = _setup()
    a, b = tm.init_cache(2, 16), tm.init_cache(2, 4096)
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    assert all(v.dtype == torch.float32 for v in a.values())
    assert float(a["mm"].max()) == float(a["sm"].max()) == float(
        np.float32(-1e30))
    tok = torch.zeros((2, 1), dtype=torch.int32)
    _, cache = tm.decode_step(tok, a, 0)
    assert cache is a and float(a["mm"].max()) > -1e29
