"""The port's Mamba mixer (``models/mamba.py``) and Hymba hybrid
(``models/hybrid.py``) against the JAX reference, on the CPU.

``mamba_mixer`` (output, final SSM state, conv state) when S is and is
not a multiple of the chunk (the reference then runs one chunk of the
whole sequence), the doubling scan against a plain step-by-step
recurrence, ``mamba_decode`` against the reference's and continuing a
prefill's state into the next tokens, gradients through the
checkpointed chunks; then the reduced Hymba against the reference's
(``tests/torch_lm_cases.py``) and its flash prefill past the window.
Tolerances: the doubling multiplies in another order than XLA's scan
tree, so the mixer is held within 1e-5 relative (float32); models 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced_config as jreduced  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
import torch_lm_cases as C  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, s=16, b=2):
    """Both packages' reduced Hymba config, one layer's Mamba weights
    from the reference's ``mamba_init`` (numpy), and an input."""
    jcfg = jreduced(jget_config("hymba_1p5b"))
    tcfg = CB.reduced_config(CB.get_config("hymba_1p5b"))
    jp = jax.tree_util.tree_map(
        lambda a: a[0], JMB.mamba_init(jax.random.PRNGKey(seed), jcfg, 1))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _rel(got, want, tol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(C.as_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("s,chunk", [(16, 4), (20, 8), (7, 256), (64, 16)])
def test_mamba_mixer_matches_reference(s, chunk):
    """S = 16 in 4 chunks of 4; S = 20 with chunk 8 (20 is no multiple:
    one chunk of 20); S = 7 under the default chunk; S = 64 in 4 chunks.
    Output, final state and conv state."""
    jcfg, tcfg, jp, tp, x = _setup(1, s)
    jy, jh, jc = JMB.mamba_mixer(jp, jnp.asarray(x), jcfg, chunk=chunk)
    ty, th, tc = TMB.mamba_mixer(tp, torch.from_numpy(x), tcfg, chunk=chunk)
    assert th.dtype == torch.float32 and th.shape == tuple(jh.shape)
    assert tc.shape == tuple(jc.shape)
    _rel(ty, jy)
    _rel(th, jh)
    _rel(tc, jc)


def test_doubling_scan_equals_the_recurrence():
    """``h_t = a_t h_{t-1} + b_t`` from 0, step by step in float64,
    against the doubling (float32) over lengths that are and are not
    powers of two; the running products too."""
    rng = np.random.default_rng(2)
    for n in (1, 2, 5, 8, 33):
        a = rng.uniform(0.5, 1.0, (2, n, 3, 4))
        b = rng.standard_normal((2, n, 3, 4))
        h, p = np.zeros((2, 3, 4)), np.ones((2, 3, 4))
        hs, ps = [], []
        for i in range(n):
            h, p = a[:, i] * h + b[:, i], p * a[:, i]
            hs.append(h)
            ps.append(p)
        pa, hb = TMB._doubling_scan(torch.from_numpy(a).float(),
                                    torch.from_numpy(b).float())
        _rel(hb, np.stack(hs, 1), 1e-6)
        _rel(pa, np.stack(ps, 1), 1e-6)


def test_mamba_decode_matches_reference():
    """One step from a prefill's state: the reference's ``mamba_decode``
    on the same state and input."""
    jcfg, tcfg, jp, tp, x = _setup(3, 12)
    _, jh, jc = JMB.mamba_mixer(jp, jnp.asarray(x[:, :11]), jcfg)
    jy, jh2, jc2 = JMB.mamba_decode(jp, jnp.asarray(x[:, 11:]), jcfg, jh, jc)
    ty, th2, tc2 = TMB.mamba_decode(tp, torch.from_numpy(x[:, 11:]), tcfg,
                                    torch.from_numpy(np.array(jh)),
                                    torch.from_numpy(np.array(jc)))
    _rel(ty, jy)
    _rel(th2, jh2)
    _rel(tc2, jc2)


def test_mamba_decode_continues_the_prefill():
    """A prefill of S tokens, then one decode step per further token,
    equals the mixer over all of them (output rows, final states)."""
    _, tcfg, _, tp, x = _setup(4, 24)
    xt = torch.from_numpy(x)
    want, h_all, c_all = TMB.mamba_mixer(tp, xt, tcfg, chunk=8)
    _, h, c = TMB.mamba_mixer(tp, xt[:, :16], tcfg, chunk=8)
    for i in range(16, 24):
        y, h, c = TMB.mamba_decode(tp, xt[:, i:i + 1], tcfg, h, c)
        _rel(y[:, 0], want[:, i].numpy())
    _rel(h, h_all.numpy())
    _rel(c, c_all.numpy())


def test_mamba_gradients_match_reference():
    """Gradients of a scalar of the output with respect to the input and
    every weight, through the chunks (checkpointed in both packages):
    float32, 1e-4 of each leaf's largest magnitude."""
    jcfg, tcfg, jp, tp, x = _setup(5, 32)
    w = np.random.default_rng(6).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JMB.mamba_mixer(p, x, jcfg, chunk=8)[0] * w)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (TMB.mamba_mixer(tp, xt, tcfg, chunk=8)[0]
     * torch.from_numpy(w)).sum().backward()
    _rel(xt.grad, jg_x, 1e-4)
    for k, v in tp.items():
        _rel(v.grad, jg_p[k], 1e-4)


@pytest.mark.parametrize("check", sorted(C.MODEL_CHECKS))
def test_model_matches_reference(check):
    C.MODEL_CHECKS[check]("hymba_1p5b")


def test_flash_prefill_matches_reference():
    """The port's flash path (the plain version on the CPU) against the
    reference's flash (interpret mode, no scan, no remat) at S = 32, past
    the reduced window of 16 on the windowed layer: logits and the
    prefill's last logits, float32, 1e-4.  The reference's own prefill
    scans its layers and cannot run flash (``int()`` of a traced
    window)."""
    jmodel, jparams, tmodel = C.pair("hymba_1p5b", attn_impl="flash",
                                     scan_layers=False, remat=False)
    assert tmodel.windows == [0, 16]
    batch = C.make_batch(tmodel.cfg, 5, s=32)
    del batch["labels"]
    want = jmodel.forward(jparams, C.jb(batch))
    C.close(tmodel.forward(C.tb(batch)), want, 1e-4)
    last, cache = tmodel.prefill(C.tb(batch), cache_len=36)
    C.close(last[:, 0], want[:, -1], 1e-4)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape == (2, 2, tmodel.cfg.ssm_conv - 1,
                                   tmodel.cfg.ssm_expand
                                   * tmodel.cfg.d_model)


def test_decode_past_the_window_matches_forward():
    """Decoding past the window (S = 40 > 16) with the SSM and conv
    states carried: every step's logits equal the teacher-forced ones
    (2e-3, the reference's own decode tolerance)."""
    cfg = dataclasses.replace(CB.reduced_config(CB.get_config("hymba_1p5b")),
                              attn_impl="ref")
    from repro_torch.models.hybrid import HybridLM
    model = HybridLM(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    tok = C.t(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 40))
              .astype(np.int32))
    full = model.forward({"tokens": tok})
    _, cache = model.prefill({"tokens": tok[:, :30]}, cache_len=40)
    for i in range(30, 40):
        lg, cache = model.decode_step(tok[:, i:i + 1], cache, i)
        C.close(lg[:, 0], full[:, i], 2e-3)
