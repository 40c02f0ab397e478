"""The port's MoE family (``models/moe.py``: OLMoE, DBRX) against the JAX
reference, on the CPU.

Module by module on numpy-made inputs and weights: ``_capacity``; the
top-k order on planted ties (the lower expert index first, as
``jax.lax.top_k``); ``moe_apply_block`` at a capacity tight enough that
(token, choice) pairs drop, with planted ties at the top-k boundary
(which pairs drop and the output, against the reference); ``moe_apply``
when S is and is not a multiple of the block; the int8 wire path.  Then
the reduced models against the reference's (``tests/torch_lm_cases.py``:
forward, prefill and decode, loss with ``ce`` and ``aux``, greedy
decoding, one train step) and the flash prefill.  Tolerances: float32,
1e-5 relative for one block (the ``k`` gathered rows are summed in
another order than the reference's one-hot einsum), 1e-4 for models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced_config as jreduced  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
import torch_lm_cases as C  # noqa: E402

ARCHS = ("olmoe_1b_7b", "dbrx_132b")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="olmoe_1b_7b", **changes):
    """The reduced config of both packages (4 experts, top 2), with
    ``changes``."""
    return (dataclasses.replace(jreduced(jget_config(arch)), **changes),
            dataclasses.replace(CB.reduced_config(CB.get_config(arch)),
                                **changes))


def _weights(cfg, seed, tie=None):
    """One layer's router and experts (numpy float32).  ``tie=(a, b)``
    makes experts a and b's router columns equal, so every token's
    probabilities for them tie exactly."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    if tie:
        p["router"][:, tie[1]] = p["router"][:, tie[0]]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _tokens(cfg, seed, g):
    return np.random.default_rng(seed).standard_normal(
        (g, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("tokens,experts,k,factor", [
    (1024, 64, 8, 1.25), (2, 64, 8, 1.25), (4098, 64, 8, 100.0),
    (16, 4, 2, 1.25), (7, 16, 4, 1.0), (0, 8, 2, 1.25)])
def test_capacity_matches_reference(tokens, experts, k, factor):
    got = TM._capacity(tokens, experts, k, factor)
    assert got == JM._capacity(tokens, experts, k, factor)
    assert got % 8 == 0 and got >= 8


def test_top_k_takes_the_lower_index_first_on_ties():
    """Rows of planted ties (every value, some, or across the k-th
    boundary): the same indices in the same order as ``jax.lax.top_k``."""
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.4, 0.1, 0.4],
                     [0.3, 0.2, 0.3, 0.2],
                     [0.0, 0.5, 0.25, 0.25],
                     [0.2, 0.1, 0.3, 0.4]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = TM._top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _reference_keep(jp, xt, cfg, capacity):
    """Which (token, choice) pairs the reference keeps: its own routing
    lines (``moe.py:36-47``) on the same inputs."""
    logits = (xt @ jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, cfg.top_k)
    onehot = jax.nn.one_hot(gate_idx, cfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(-1, cfg.n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat).reshape(onehot.shape)
                  * onehot, axis=-1)
    return np.asarray(gate_idx), np.asarray(pos < capacity)


@pytest.mark.parametrize("tie", [None, (0, 3), (1, 2)], ids=str)
@pytest.mark.parametrize("capacity", [8, 16, 64])
def test_moe_apply_block_matches_reference(capacity, tie):
    """48 tokens, 4 experts, top 2 (96 pairs): at capacity 8 and 16 pairs
    drop.  The chosen experts, which pairs drop, the output (float32,
    1e-5 of its largest magnitude) and the Switch loss (rtol 1e-5)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_weights(tcfg, 0, tie))
    x = _tokens(tcfg, 1, 48)
    want_idx, want_keep = _reference_keep(jp, jnp.asarray(x), jcfg,
                                          capacity)
    _, _, idx, _, _, keep = TM.route(tp, torch.from_numpy(x), tcfg, capacity)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if capacity < 64:
        assert not want_keep.all()
    if tie:              # some tokens' tie straddles the k-th place
        probs = np.sort(np.asarray(jax.nn.softmax(
            jnp.asarray(x) @ jp["router"], axis=-1)), axis=-1)[:, ::-1]
        assert (probs[:, tcfg.top_k - 1] == probs[:, tcfg.top_k]).any()
    jy, jaux = JM.moe_apply_block(jp, jnp.asarray(x), jcfg, capacity)
    ty, taux = TM.moe_apply_block(tp, torch.from_numpy(x), tcfg, capacity)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_apply_block_drops_pass_through_as_zero():
    """A token all of whose choices drop gets no expert output (it passes
    through the residual): its row of y is 0."""
    _, tcfg = _cfgs()
    _, tp = _both(_weights(tcfg, 2))
    x = torch.from_numpy(_tokens(tcfg, 3, 64))
    _, _, _, _, _, keep = TM.route(tp, x, tcfg, 8)
    y, _ = TM.moe_apply_block(tp, x, tcfg, 8)
    gone = ~keep.any(dim=1)
    assert bool(gone.any())
    assert bool((y[gone] == 0).all()) and bool((y[~gone] != 0).any(dim=1)
                                               .all())


@pytest.mark.parametrize("s", [16, 18])
@pytest.mark.parametrize("block_tokens", [8, 1024])
def test_moe_apply_matches_reference(s, block_tokens):
    """B = 2: blocks of 4 positions per row at block_tokens 8 (4 blocks
    at S = 16; S = 18 does not divide and falls back to one block of the
    whole sequence at its capacity), one block at 1024.  Output within
    1e-5 of its largest magnitude, mean Switch loss rtol 1e-5."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, tp = _both(_weights(tcfg, 4))
    x = np.random.default_rng(5).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    jy, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg,
                            block_tokens=block_tokens)
    ty, taux = TM.moe_apply(tp, torch.from_numpy(x), tcfg,
                            block_tokens=block_tokens)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("capacity", [8, 64])
def test_int8_wire_matches_reference(capacity):
    """``moe_wire_int8``: tokens quantised per row before the dispatch,
    scales beside them; the expert inputs are the same products, so the
    output agrees within 1e-5 of its largest magnitude, and differs from
    the unquantised path's by the quantisation."""
    jcfg, tcfg = _cfgs(moe_wire_int8=True)
    jp, tp = _both(_weights(tcfg, 6))
    x = _tokens(tcfg, 7, 48)
    jy, _ = JM.moe_apply_block(jp, jnp.asarray(x), jcfg, capacity)
    ty, _ = TM.moe_apply_block(tp, torch.from_numpy(x), tcfg, capacity)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    plain, _ = TM.moe_apply_block(tp, torch.from_numpy(x),
                                  dataclasses.replace(tcfg,
                                                      moe_wire_int8=False),
                                  capacity)
    diff = float((plain - ty).abs().max())
    assert 0 < diff < 0.05 * float(plain.abs().max())


def test_bf16_block_keeps_the_reference_rounding():
    """bfloat16 tokens and weights: the output within one bf16 rounding
    of the reference's (the router's product in bf16, the gate values
    rounded to bf16 before the combine)."""
    jcfg, tcfg = _cfgs()
    p = _weights(tcfg, 8)
    x = _tokens(tcfg, 9, 48)
    jy, _ = JM.moe_apply_block({k: jnp.asarray(v, jnp.bfloat16)
                                for k, v in p.items()},
                               jnp.asarray(x, jnp.bfloat16), jcfg, 16)
    ty, _ = TM.moe_apply_block({k: torch.from_numpy(v).bfloat16()
                                for k, v in p.items()},
                               torch.from_numpy(x).bfloat16(), tcfg, 16)
    assert ty.dtype == torch.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(jy).max())


@pytest.mark.parametrize("check", sorted(C.MODEL_CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, check):
    C.MODEL_CHECKS[check](arch)


def test_flash_prefill_matches_reference():
    """The port's flash path (the kernel's plain version on the CPU)
    against the reference's flash (its Pallas kernel in interpret mode,
    no scan, no remat) in the teacher-forced logits, and the prefill's
    last logits: float32, 1e-4."""
    jmodel, jparams, tmodel = C.pair("olmoe_1b_7b", attn_impl="flash",
                                     scan_layers=False, remat=False)
    batch = C.make_batch(tmodel.cfg, 5, s=16)
    del batch["labels"]
    want = jmodel.forward(jparams, C.jb(batch))
    C.close(tmodel.forward(C.tb(batch)), want, 1e-4)
    last, _ = tmodel.prefill(C.tb(batch))
    C.close(last[:, 0], want[:, -1], 1e-4)
