"""Shared cases of the port's LM families against the JAX reference (a
helper module of ``tests/test_torch_{moe,hybrid,xlstm,encdec,vlm,
families}.py``; its name keeps pytest from collecting it).

Same numpy-made inputs and the same weights (the reference's
``model.init`` pytree carried over by ``params_from_numpy``) go through
both packages' reduced models (float32, ``attn_impl="chunked"``, the
reference's scanned layers).  ``MODEL_CHECKS`` holds the per-model
comparisons each family's file runs for its architectures: ``forward``,
``prefill`` (logits and every cache entry) with one ``decode_step`` from
its cache, ``loss`` (MoE with its ``ce`` and ``aux``),
``greedy_generate``, and one ``make_train_step`` step.  Tolerances are
stated at each check; float32 differences come from summation order
only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced_config as jreduced
from repro.models.registry import build_model as jbuild
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.serve_step import greedy_generate as jgreedy
from repro.train.train_step import init_train_state as jinit
from repro.train.train_step import make_train_step as jmake
from repro.utils.tree import flatten_with_paths as jflat
from repro_torch.configs import base as CB
from repro_torch.models.registry import build_model, params_from_numpy
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.serve_step import greedy_generate
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils import tree as T

S = 16


def t(a):
    return torch.from_numpy(np.array(a))


def as_np(x):
    """A tensor or array as float64 numpy."""
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def pair(arch, seed=0, **changes):
    """The reference's reduced model, its parameters (``init`` at
    ``seed``), and the port's model on the same weights; ``changes`` go
    to both configs."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **changes)
    tcfg = dataclasses.replace(CB.reduced_config(CB.get_config(arch)),
                               **changes)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = build_model(tcfg, device="cpu",
                         params=params_from_numpy(tcfg, tree, "cpu"))
    return jmodel, jparams, tmodel


def make_batch(cfg, seed, b=2, s=S):
    """Tokens, next-token labels (the last two and a few scattered ones
    masked), and the stub frontend's embeddings (as the reference's
    ``tests/test_models.py::make_batch``)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -2:] = -1
    lab[rng.random((b, s)) < 0.1] = -1
    batch = {"tokens": tok, "labels": lab}
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: t(v) for k, v in batch.items()}


def check_forward(arch):
    """Teacher-forced logits [B, S, V] (text positions only for the VLM);
    float32, 1e-4 (summation order through two layers)."""
    jmodel, jparams, tmodel = pair(arch)
    batch = make_batch(tmodel.cfg, 1)
    want = jmodel.forward(jparams, jb(batch))
    got = tmodel.forward(tb(batch))
    assert got.shape == tuple(want.shape) == (2, S, tmodel.cfg.padded_vocab)
    close(got, want, 1e-4)


def check_prefill_and_decode(arch):
    """Prefill's last logits and every cache entry (names, shapes, dtypes,
    values; a VLM's cache covers prefix and text), then one decode step
    from that cache: float32, 1e-4."""
    jmodel, jparams, tmodel = pair(arch, seed=1)
    cfg = tmodel.cfg
    batch = make_batch(cfg, 2)
    cache_len = S + 4 + cfg.prefix_len
    want, jcache = jmodel.prefill(jparams, jb(batch), cache_len=cache_len)
    got, cache = tmodel.prefill(tb(batch), cache_len=cache_len)
    assert got.shape == tuple(want.shape) == (2, 1, cfg.padded_vocab)
    close(got, want, 1e-4)
    assert sorted(cache) == sorted(jcache)
    for name in jcache:
        assert tuple(cache[name].shape) == tuple(jcache[name].shape), name
        assert str(cache[name].dtype).replace("torch.", "") == \
            str(jcache[name].dtype), name
        close(cache[name], jcache[name], 1e-4)
    nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
    index = S + cfg.prefix_len
    jlg, _ = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache,
                                jnp.int32(index))
    lg, cache2 = tmodel.decode_step(t(nxt), cache, index)
    assert cache2 is cache                       # updated in place
    close(lg, jlg, 1e-4)


def check_loss(arch):
    """Masked-label loss, token count and (MoE) ``ce`` and ``aux``;
    float32, rtol 1e-5."""
    jmodel, jparams, tmodel = pair(arch)
    batch = make_batch(tmodel.cfg, 3)
    want, jm = jmodel.loss(jparams, jb(batch))
    got, tm = tmodel.loss(tb(batch))
    assert set(tm) == set(jm)
    assert int(tm["tokens"]) == int(jm["tokens"]) == int(
        (batch["labels"] >= 0).sum())
    for k in set(jm) - {"tokens"}:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5, err_msg=k)


def check_greedy(arch):
    """Six greedy tokens (a VLM's start index includes its prefix): equal
    token for token."""
    jmodel, jparams, tmodel = pair(arch, seed=2)
    cfg = tmodel.cfg
    batch = make_batch(cfg, 4)
    del batch["labels"]
    cache_len = S + 6 + cfg.prefix_len
    want = jgreedy(jmodel, jparams, jb(batch), steps=6, cache_len=cache_len)
    got = greedy_generate(tmodel, tb(batch), steps=6, cache_len=cache_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def compare_step(jstate, tstate, jmet, tmet, lr):
    """One AdamW step of each package from the same state: metrics
    within rtol 1e-5; ``m`` within rtol 1e-4 and 1e-5 of the leaf's
    largest magnitude; parameters within lr * 1e-3, or 2 lr where the
    gradient is within that tolerance of zero (the first step moves an
    element by about lr * sign(g), so a last-bit difference in g near 0
    changes it by O(lr))."""
    for k in set(jmet) - {"tokens"}:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    for (name, a), (_, b) in zip(jflat(jstate.opt["m"]),
                                 T.flatten_with_paths(tstate.opt["m"])):
        a, b = as_np(a), as_np(b)
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(), err_msg=name)
    jl, tl = jflat(jstate.params), T.flatten_with_paths(tstate.params)
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, a), (_, b), (_, m) in zip(jl, tl, jflat(jstate.opt["m"])):
        g = np.abs(np.asarray(m)) / 0.1          # |g| * scale at step 1
        loose = g <= max(1e3 * 1e-8, 1e-4 * g.max())
        diff = np.abs(as_np(b) - as_np(a))
        assert (diff[~loose] <= lr * 1e-3 + 1e-7 * np.abs(as_np(a))[
            ~loose]).all(), name
        assert (diff[loose] <= 2 * lr * 1.01).all(), name


def check_train_step(arch):
    """One ``make_train_step`` step of each package from the same
    weights: loss, ``grad_norm``, lr (and MoE's ``ce`` / ``aux``), the
    first moments and the updated params.  The port splits every stacked
    group (the layers, Whisper's encoder and cross attention, xLSTM's
    pairs) into per-slice leaves by its own leading size."""
    jmodel, _, tmodel = pair(arch)
    batch = make_batch(tmodel.cfg, 6)
    lr = 1e-3
    jstate, jmet = jax.jit(jmake(jmodel, JAdamW(peak_lr=lr,
                                                warmup_steps=0)))(
        jinit(jmodel, jax.random.PRNGKey(0)), jb(batch))
    tstate, tmet = make_train_step(
        tmodel, AdamWConfig(peak_lr=lr, warmup_steps=0))(
        init_train_state(tmodel), tb(batch))
    assert set(tmet) == set(jmet)
    assert int(tmet["tokens"]) == int(jmet["tokens"])
    compare_step(jstate, tstate, jmet, tmet, lr)


MODEL_CHECKS = {"forward": check_forward,
                "prefill_decode": check_prefill_and_decode,
                "loss": check_loss, "greedy": check_greedy,
                "train_step": check_train_step}
