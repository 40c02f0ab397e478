"""The port's training path against the JAX reference, on the CPU.

Same numpy-made batches and the same weights (the reference's
``DenseLM.init`` pytree carried over by ``params_from_numpy``) go through
both packages' ``loss``, gradients, ``make_train_step`` (AdamW, microbatches,
int8 and top-k compression), checkpoints and the cost model.  The
reference runs as its own tests run it (reduced configs, float32,
``attn_impl="chunked"``, scanned layers).  Tolerances are stated at each
check; float32 differences come from summation order only.  Also the
port's own versions of ``tests/test_train.py``'s tests, the dense cases
of ``tests/test_models.py::test_smoke_forward_and_train_step``, the dense
analytic tests of ``tests/test_roofline.py``, the train CLI and the
import boundary (the other families' train steps are in
``tests/test_torch_families.py`` and ``tests/torch_lm_cases.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced_config as jreduced  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.compression import CompressionConfig as JComp  # noqa: E402
from repro.train.compression import compress_grads as jcompress  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamW  # noqa: E402
from repro.train.optimizer import lr_at as jlr_at  # noqa: E402
from repro.train.train_step import init_train_state as jinit  # noqa: E402
from repro.train.train_step import make_train_step as jmake  # noqa: E402
from repro.train.train_step import state_spec as jstate_spec  # noqa: E402
from repro.utils import analytic as janalytic  # noqa: E402
from repro.utils.tree import flatten_with_paths as jflat  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.data.tokens import (  # noqa: E402
    Prefetcher, SyntheticTokens, shard_for_host)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.train.checkpoint import (  # noqa: E402
    AsyncCheckpointer, latest_step, list_steps, restore_checkpoint,
    save_checkpoint)
from repro_torch.train.compression import (  # noqa: E402
    CompressionConfig, compress_grads, init_error_state)
from repro_torch.train.optimizer import AdamWConfig, lr_at  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainState, init_train_state, make_train_step, state_spec)
from repro_torch.utils import analytic, tree as T  # noqa: E402
from repro_torch.utils.sharding import P as SP  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    these training loops would otherwise take every core from the
    others' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


DENSE = ("gemma2-2b", "smollm-360m", "granite-8b")
S = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    """A tensor or array as float64 numpy (bf16 included)."""
    if torch.is_tensor(x):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _plain(params):
    """A ``ParameterDict`` tree as nested dicts of detached tensors."""
    return {k: _plain(v) if isinstance(v, torch.nn.ParameterDict)
            else v.detach() for k, v in params.items()}


def _pair(arch="smollm-360m", seed=0, **changes):
    """The reference's reduced model and the port's, on the same weights
    (the reference's ``init`` at ``seed``), with ``changes`` to both
    configs."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **changes)
    tcfg = dataclasses.replace(CB.reduced_config(CB.get_config(arch)),
                               **changes)
    jmodel = jbuild(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(seed)))
    tmodel = DenseLM(tcfg, device="cpu",
                     params=params_from_numpy(tcfg, tree, "cpu"))
    return jmodel, tmodel


def _batch(cfg, seed, b=4, s=S, masked=True):
    """Random tokens, their next-token labels, and (``masked``) the last
    three labels of each row and a few scattered ones set to -1."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    if masked:
        lab[:, -3:] = -1
        lab[rng.random((b, s)) < 0.1] = -1
    return {"tokens": tok, "labels": lab}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _leaves_close(jtree, ttree, rtol, atol):
    jl, tl = jflat(jtree), T.flatten_with_paths(ttree)
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(_np(b), _np(a), rtol=rtol, atol=atol,
                                   err_msg=name)


# ------------------------------------------------------------- utils/tree

def test_flatten_with_paths_names_like_the_reference():
    tree = {"b": [np.zeros(2), (np.ones(1), np.ones(3))],
            "a": {"z": np.zeros(1), "y": np.zeros(2)}, "c": None}
    assert [n for n, _ in T.flatten_with_paths(tree)] == \
        [n for n, _ in jflat(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compression", [None, "int8"])
def test_init_train_state_layout_matches_reference(dtype, compression):
    """Leaf names (``[<flat index i>]/...``), shapes and dtypes of the
    train state, bf16 params with a float32 master included."""
    jmodel, tmodel = _pair("gemma2-2b", dtype=dtype)
    comp = compression and CompressionConfig(kind=compression)
    jstate = jinit(jmodel, jax.random.PRNGKey(0),
                   compression=compression and JComp(kind=compression))
    tstate = init_train_state(tmodel, compression=comp)
    assert isinstance(tstate, TrainState)
    assert (tstate.err is None) == (compression is None)
    got = [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for n, x in T.flatten_with_paths(tstate)]
    want = [(n, tuple(x.shape), str(x.dtype)) for n, x in jflat(jstate)]
    assert got == want
    if dtype == "bfloat16":
        assert ("[<flat index 1>]/master/layers/mlp/w_up", (2, 64, 256),
                "float32") in got
    # the model now runs on the state's params, and the master holds the
    # float32 values
    assert tmodel.params["embedding"].data_ptr() == \
        tstate.params["embedding"].data_ptr()
    _leaves_close(jstate, tstate, 0, 0)


def test_tree_helpers():
    tree = {"w": torch.ones(2, 3), "b": {"x": torch.full((4,), 2.0)}}
    assert T.param_count(tree) == 10
    assert T.param_bytes(T.tree_cast(tree, torch.bfloat16)) == 20
    assert float(T.global_norm(tree)) == pytest.approx(np.sqrt(6 + 16))
    assert not bool(T.has_nan(tree))
    assert bool(T.has_nan(T.tree_add(tree, {"w": torch.zeros(2, 3),
                                            "b": {"x": torch.tensor(
                                                [0, float("nan"), 0, 0])}})))
    z = T.tree_zeros_like(T.tree_scale(tree, 3.0))
    assert float(T.global_norm(z)) == 0.0


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_reference(arch, remat):
    """Masked-label loss and token count; float32, rtol 1e-5 (the same
    operations in another summation order)."""
    jmodel, tmodel = _pair(arch, remat=remat)
    batch = _batch(tmodel.cfg, 1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    want, jm = jmodel.loss(jparams, _jb(batch))
    got, tm = tmodel.loss(_tb(batch))
    assert got.dtype == torch.float32 and tm["tokens"].dtype == torch.int32
    assert int(tm["tokens"]) == int(jm["tokens"]) == int(
        (batch["labels"] >= 0).sum())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("vocab_chunk", [1, 3, 8])
def test_loss_vocab_chunks_match_reference(vocab_chunk):
    """S = 16: 1 and 8 chunks divide it, 3 falls back to one chunk."""
    jmodel, tmodel = _pair("gemma2-2b")
    batch = _batch(tmodel.cfg, 2)
    want, _ = jmodel.loss(jmodel.init(jax.random.PRNGKey(0)), _jb(batch),
                          vocab_chunk=vocab_chunk)
    got, _ = tmodel.loss(_tb(batch), vocab_chunk=vocab_chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _jgrads(jmodel, batch, seed=0):
    params = jmodel.init(jax.random.PRNGKey(seed))
    return jax.grad(lambda p: jmodel.loss(p, _jb(batch))[0])(params)


def _tgrads(tmodel, batch):
    params = T.tree_map(lambda p: p.clone().requires_grad_(),
                        _plain(tmodel.params))
    loss, _ = tmodel.loss(_tb(batch), params=params)
    leaves = T.tree_leaves(params)
    return T.tree_unflatten(params, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_gradients_match_reference(arch, remat):
    """Every gradient leaf; float32, within 1e-5 of the leaf's largest
    magnitude (summation order through two layers' backward)."""
    jmodel, tmodel = _pair(arch, remat=remat)
    batch = _batch(tmodel.cfg, 3)
    want = _jgrads(jmodel, batch)
    got = _tgrads(tmodel, batch)
    jl, tl = jflat(want), T.flatten_with_paths(got)
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        np.testing.assert_allclose(_np(b), a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)


def test_remat_on_equals_off():
    """Remat recomputes the same operations: loss and gradients equal
    bit for bit on the CPU."""
    _, off = _pair("gemma2-2b", remat=False)
    _, on = _pair("gemma2-2b", remat=True)
    batch = _batch(off.cfg, 4)
    g_off, g_on = _tgrads(off, batch), _tgrads(on, batch)
    for a, b in zip(T.tree_leaves(g_off), T.tree_leaves(g_on)):
        assert torch.equal(a, b)


def test_attention_flash_raises_under_autograd():
    """The flash kernel is forward only: with grad enabled and an input
    that requires grad it raises; under ``no_grad`` it runs."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((1, 32, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 32, 2, 16)).astype(np.float32))
    v = _t(rng.standard_normal((1, 32, 2, 16)).astype(np.float32))
    pos = torch.arange(32)
    with pytest.raises(RuntimeError, match="forward only"):
        TL.attention_output(q.requires_grad_(), k, v, pos, pos, "flash")
    with torch.no_grad():
        assert TL.attention_output(q, k, v, pos, pos, "flash").shape == \
            q.shape
    _, tmodel = _pair("smollm-360m", attn_impl="flash")
    with pytest.raises(RuntimeError, match="forward only"):
        tmodel.loss(_tb(_batch(tmodel.cfg, 0)))


# ------------------------------------------------------------ train step

def _compare_step(jstate, tstate, jmet, tmet, lr, flip_steps=None):
    """One AdamW step of each package from the same state.

    Metrics within rtol 1e-5; ``m`` (linear in g) within the gradients'
    tolerance (rtol 1e-4, 1e-5 of the leaf's largest magnitude) and ``v``
    (in g^2, which doubles relative errors) within rtol 2e-4 and 1e-5 of
    its largest.  Parameters and masters: the first step moves
    each by about lr * sign(g), so an element whose scaled gradient lies
    within that tolerance (or 1e3 * eps) of zero may differ by up to 2 lr
    (a last-bit difference in g changes its update by O(lr)); every other
    element within lr * 1e-3.

    ``flip_steps`` (compressed steps): leaf name -> the compressor's
    step there (one int8 quantum, or the top-k threshold).  A last-bit
    difference in g can move an element across a rounding boundary or
    the threshold, changing its wire value by up to that step: at most
    1e-3 of a leaf's elements may do so, their ``m`` within 0.1 of the
    step, their parameters within 2 lr.  Returns the flip masks."""
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    assert int(tstate.opt["step"]) == int(jstate.opt["step"])
    flips = {}
    for key in ("m", "v"):
        for (name, a), (_, b) in zip(jflat(jstate.opt[key]),
                                     T.flatten_with_paths(tstate.opt[key])):
            a, b = _np(a), _np(b)
            rtol = 1e-4 if key == "m" else 2e-4
            bad = np.abs(b - a) > rtol * np.abs(a) + 1e-5 * np.abs(a).max()
            if key == "m" and flip_steps is not None:
                flips[name] = bad.copy()
                assert bad.mean() <= 1e-3, (name, bad.mean())
                assert (np.abs(b - a)[bad]
                        <= 0.1 * flip_steps[name] * 1.01).all(), name
            bad &= ~flips.get(name, np.zeros_like(bad))
            assert not bad.any(), f"{key}/{name}: {np.abs(b - a).max()}"
    for (name, a), (_, b), (_, m) in zip(jflat(jstate.params),
                                         T.flatten_with_paths(tstate.params),
                                         jflat(jstate.opt["m"])):
        g = np.abs(np.asarray(m)) / 0.1          # |g| * scale at step 1
        loose = g <= max(1e3 * 1e-8, 1e-4 * g.max())
        loose |= flips.get(name, np.zeros_like(loose))
        diff = np.abs(_np(b) - _np(a))
        assert (diff[~loose] <= lr * 1e-3 + 1e-7 * np.abs(_np(a))[
            ~loose]).all(), name
        assert (diff[loose] <= 2 * lr * 1.01).all(), name
    return flips


@pytest.mark.parametrize("arch", DENSE)
def test_one_train_step_matches_reference(arch):
    jmodel, tmodel = _pair(arch)
    batch = _batch(tmodel.cfg, 6)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0)
    jopt = JAdamW(peak_lr=1e-3, warmup_steps=0)
    jstate, jmet = jax.jit(jmake(jmodel, jopt))(
        jinit(jmodel, jax.random.PRNGKey(0)), _jb(batch))
    tstate, tmet = make_train_step(tmodel, opt)(init_train_state(tmodel),
                                                _tb(batch))
    assert set(tmet) == set(jmet)
    assert int(tmet["tokens"]) == int(jmet["tokens"])
    _compare_step(jstate, tstate, jmet, tmet, 1e-3)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatched_step_matches_reference(microbatches):
    jmodel, tmodel = _pair("gemma2-2b")
    batch = _batch(tmodel.cfg, 7, b=8)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0)
    jopt = JAdamW(peak_lr=1e-3, warmup_steps=0)
    jstate, jmet = jax.jit(jmake(jmodel, jopt, microbatches=microbatches))(
        jinit(jmodel, jax.random.PRNGKey(0)), _jb(batch))
    tstate, tmet = make_train_step(tmodel, opt, microbatches=microbatches)(
        init_train_state(tmodel), _tb(batch))
    assert set(tmet) == set(jmet) == {"loss", "lr", "grad_norm"}
    _compare_step(jstate, tstate, jmet, tmet, 1e-3)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_step_matches_reference(kind):
    """A step with compressed gradients: metrics, params, moments and the
    error-feedback state (float32, within 1e-5 of the gradient's largest
    magnitude, but where an element crossed a rounding boundary or the
    top-k threshold: see ``_compare_step``)."""
    jmodel, tmodel = _pair("smollm-360m")
    batch = _batch(tmodel.cfg, 8)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0)
    jopt = JAdamW(peak_lr=1e-3, warmup_steps=0)
    jcomp, comp = JComp(kind=kind, topk_fraction=0.25), \
        CompressionConfig(kind=kind, topk_fraction=0.25)
    jstate, jmet = jax.jit(jmake(jmodel, jopt, compression=jcomp))(
        jinit(jmodel, jax.random.PRNGKey(0), compression=jcomp), _jb(batch))
    tstate, tmet = make_train_step(tmodel, opt, compression=comp)(
        init_train_state(tmodel, compression=comp), _tb(batch))
    assert tmet["compression_ratio"] == jmet["compression_ratio"]
    # the compressor's step a leaf: an int8 quantum is at most twice the
    # largest error it leaves, a dropped top-k element at most the
    # threshold, itself at most the largest kept... bounded the same way
    grads = {n: _np(m) / 0.1 for n, m in jflat(jstate.opt["m"])}
    errs = dict((n, _np(e)) for n, e in jflat(jstate.err))
    steps = {n: 2 * np.abs(errs[n]).max() + 1e-30 for n in errs}
    flips = _compare_step(jstate, tstate, jmet, tmet, 1e-3, steps)
    for (name, a), (_, b) in zip(jflat(jstate.err),
                                 T.flatten_with_paths(tstate.err)):
        a, b = _np(a), _np(b)
        tol = 1e-5 * (np.abs(grads[name]).max() + np.abs(a).max())
        bad = np.abs(b - a) > tol
        assert not (bad & ~flips[name]).any(), name
        assert (np.abs(b - a)[bad] <= steps[name] * 1.01).all(), name


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compress_grads_matches_reference(kind):
    """Same gradients and error state in, same wire and new error state
    out: exact for int8 (the same float32 operations), and top-k on
    distinct magnitudes (ties would break differently from
    ``lax.top_k``)."""
    rng = np.random.default_rng(9)
    shapes = {"a": (64, 48), "b": {"c": (300,), "d": (7, 5, 3)}}
    grads = jax.tree_util.tree_map(
        lambda s: rng.permutation(np.prod(s)).reshape(s).astype(np.float32)
        * (rng.choice([-1.0, 1.0], s) / np.prod(s)), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    err = jax.tree_util.tree_map(
        lambda g: (rng.standard_normal(g.shape) * 1e-3).astype(np.float32),
        grads)
    jc, tc = JComp(kind=kind, topk_fraction=0.1), \
        CompressionConfig(kind=kind, topk_fraction=0.1)
    jw, je, js = jcompress(jax.tree_util.tree_map(jnp.asarray, grads),
                           jax.tree_util.tree_map(jnp.asarray, err), jc)
    tw, te, ts = compress_grads(T.tree_map(_t, grads), T.tree_map(_t, err),
                                tc)
    assert ts == js
    _leaves_close(jw, tw, 0, 1e-9)
    _leaves_close(je, te, 0, 1e-9)


def test_compression_none_passes_through():
    g = {"w": torch.ones(3)}
    e = init_error_state(g)
    wire, err, stats = compress_grads(g, e, CompressionConfig(kind="none"))
    assert wire is g and err is e and stats == {"compression_ratio": 1.0}


def test_loss_trajectory_matches_reference():
    """20 steps of each package on the synthetic stream: every loss within
    rtol 1e-4 (float32; AdamW's near-sign updates let last-bit
    differences grow a little step by step)."""
    jmodel, tmodel = _pair("smollm-360m")
    data = SyntheticTokens(tmodel.cfg.vocab_size, S, 8, seed=0)
    opt = dict(peak_lr=3e-3, warmup_steps=5, total_steps=20)
    jstep = jax.jit(jmake(jmodel, JAdamW(**opt)))
    tstep = make_train_step(tmodel, AdamWConfig(**opt))
    jstate = jinit(jmodel, jax.random.PRNGKey(0))
    tstate = init_train_state(tmodel)
    jl, tl = [], []
    for i in range(20):
        b = data.batch_at(i)
        jstate, jm = jstep(jstate, _jb(b))
        tstate, tm = tstep(tstate, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("step", [0, 5, 10, 50, 99, 150])
def test_lr_at_matches_reference(step):
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JAdamW(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    np.testing.assert_allclose(
        float(lr_at(cfg, torch.tensor(step, dtype=torch.int32))),
        float(jlr_at(jcfg, jnp.int32(step))), rtol=1e-6)


class _OneRankMesh:
    """What the port reads of a 1 x 1 ``DeviceMesh``, with no process
    group (an axis of size 1 issues no collective)."""
    mesh_dim_names = ("data", "model")
    shape = (1, 1)
    device_type = "cpu"

    def get_coordinate(self):
        return [0, 0]


def test_mesh_specs_raise():
    """The mesh arguments are ported: ``state_spec`` is the reference's
    tree; ``dp_spec`` / ``grad_spec`` on a model off a mesh change nothing
    (as the reference's without one), and on a 1 x 1 mesh the step is the
    meshless one bit for bit.  What still raises: ``act_spec`` (sequence
    parallelism, not ported) on a mesh, naming ROADMAP."""
    jmodel, tmodel = _pair()
    got = T.flatten_with_paths(state_spec(tmodel))
    want = jflat(jstate_spec(jmodel))
    assert [(n, tuple(s)) for n, s in got] == \
        [(n, tuple(s)) for n, s in want]
    batch = _tb(_batch(tmodel.cfg, 6))
    runs = []
    for specs, on_mesh in (({}, False), ({"dp_spec": ("data",)}, False),
                           ({"dp_spec": "data"}, True)):
        _, model = _pair()
        if on_mesh:
            model.to_mesh(_OneRankMesh())
        kw = dict(specs, grad_spec=model.param_spec()) if specs else {}
        state, met = make_train_step(model, AdamWConfig(), **kw)(
            init_train_state(model), batch)
        runs.append(([_np(x).tobytes() for _, x in
                      T.flatten_with_paths(state)],
                     {k: float(v) for k, v in met.items()}))
    assert runs[0] == runs[1] == runs[2]
    model.act_spec = SP("data", "model", None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.forward(batch)


# ------------------------------------------ tests/test_train.py, ported

def tiny_model():
    cfg = CB.reduced_config(CB.get_config("smollm_360m"))
    return DenseLM(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0)), cfg


def test_lr_schedule_shape():
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 50, 99]]
    assert lrs[0] < lrs[1] < lrs[2]          # warmup rises
    assert lrs[2] >= lrs[3] >= lrs[4]        # cosine decays
    assert lrs[2] == pytest.approx(1e-3, rel=0.05)


def _train(model, data, steps, compression=None, opt=None):
    opt = opt or AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=300)
    step = make_train_step(model, opt, compression=compression)
    state = init_train_state(model, generator=torch.Generator().manual_seed(0),
                             compression=compression)
    losses = []
    for i in range(steps):
        state, metrics = step(state, _tb(data.batch_at(i)))
        losses.append(float(metrics["loss"]))
    return state, losses


def test_training_reduces_loss():
    """A hundred steps on the synthetic corpus must show learning."""
    model, cfg = tiny_model()
    _, losses = _train(model, SyntheticTokens(cfg.vocab_size, 16, 8, seed=0),
                       120)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7, losses[-5:]


def test_microbatch_equivalence():
    """mb=1 and mb=4 must give (nearly) identical updates."""
    cfg = CB.reduced_config(CB.get_config("smollm_360m"))
    data = SyntheticTokens(cfg.vocab_size, 16, 8, seed=1)
    batch = _tb(data.batch_at(0))
    opt = AdamWConfig(peak_lr=1e-3)
    states = []
    for mb in (1, 4):
        model = DenseLM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        s, _ = make_train_step(model, opt, microbatches=mb)(
            init_train_state(model), batch)
        states.append(s)
    d = [float((a - b).abs().max()) for a, b in
         zip(T.tree_leaves(states[0].params), T.tree_leaves(states[1].params))]
    assert max(d) < 1e-5


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_convergence(kind):
    """Compressed training converges on the synthetic task (error
    feedback keeps the bias bounded)."""
    model, cfg = tiny_model()
    comp = CompressionConfig(kind=kind, topk_fraction=0.25)
    _, losses = _train(model, SyntheticTokens(cfg.vocab_size, 16, 8, seed=2),
                       120, compression=comp)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.75


def test_int8_compression_error_feedback_unbiased():
    grads = {"w": _t(np.random.default_rng(0)
                     .standard_normal((64, 64)).astype(np.float32))}
    err = init_error_state(grads)
    comp = CompressionConfig(kind="int8")
    acc = torch.zeros_like(grads["w"])
    for _ in range(50):
        wire, err, _ = compress_grads(grads, err, comp)
        acc = acc + wire["w"]
    # long-run average of wire grads == true grad (error feedback)
    np.testing.assert_allclose((acc / 50).numpy(), grads["w"].numpy(),
                               atol=2e-3)


def _state(seed=3, dtype="float32"):
    cfg = dataclasses.replace(CB.reduced_config(CB.get_config("smollm_360m")),
                              dtype=dtype)
    model = DenseLM(cfg, device="cpu")
    return init_train_state(model,
                            generator=torch.Generator().manual_seed(seed))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_trees_equal(a, b):
    na, nb = T.flatten_with_paths(a), T.flatten_with_paths(b)
    assert [n for n, _ in na] == [n for n, _ in nb]
    for (name, x), (_, y) in zip(na, nb):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), name


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    root = str(tmp_path / "ckpt")
    save_checkpoint(root, 7, state)
    assert latest_step(root) == 7
    restored, step = restore_checkpoint(root, state)
    assert step == 7
    _assert_trees_equal(state, restored)


def test_checkpoint_gc_keeps_latest(tmp_path):
    state = _state(0)
    root = str(tmp_path / "ckpt")
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(root, s, state, keep=2)
    assert list_steps(root) == [4, 5]


def test_async_checkpointer(tmp_path):
    """The host copy is taken at submit: an in-place update right after
    does not reach the files."""
    state = _state(0)
    want = state.params["embedding"].clone()
    root = str(tmp_path / "ckpt")
    ck = AsyncCheckpointer(root)
    ck.submit(3, state)
    state.params["embedding"].add_(1.0)
    ck.wait()
    assert latest_step(root) == 3
    restored, _ = restore_checkpoint(root, state)
    assert torch.equal(restored.params["embedding"], want)


@pytest.mark.parametrize("target", ["meta device", "float32 over bf16"])
def test_elastic_restore_new_target(tmp_path, target):
    """A checkpoint restores onto another device than the template's (a
    template of meta tensors, ``device="cpu"``) and keeps its own dtypes
    under a template of other dtypes (bf16 leaves under a float32
    template)."""
    root = str(tmp_path / "ckpt")
    if target == "meta device":
        state = _state(0)
        save_checkpoint(root, 1, state)
        template = T.tree_map(lambda t: t.to("meta"), state)
        restored, _ = restore_checkpoint(root, template, device="cpu")
    else:
        state = _state(0, dtype="bfloat16")
        save_checkpoint(root, 1, state)
        template = T.tree_map(lambda t: t.float(), state)
        restored, _ = restore_checkpoint(root, template)
        assert restored.params["embedding"].dtype == torch.bfloat16
    assert restored.params["embedding"].device.type == "cpu"
    _assert_trees_equal(state, restored)


def test_data_pipeline_determinism_and_sharding():
    d1 = SyntheticTokens(100, 8, 4, seed=5)
    d2 = SyntheticTokens(100, 8, 4, seed=5)
    b1, b2 = d1.batch_at(10), d2.batch_at(10)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    s0 = shard_for_host(b1, 2, 0)
    s1 = shard_for_host(b1, 2, 1)
    assert s0["tokens"].shape[0] == 2
    np.testing.assert_array_equal(
        np.concatenate([s0["tokens"], s1["tokens"]]), b1["tokens"])
    from repro.data.tokens import SyntheticTokens as JTokens
    ref = JTokens(100, 8, 4, seed=5).batch_at(10)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b1[k], ref[k])


def test_prefetcher():
    data = SyntheticTokens(50, 4, 2, seed=0)
    it = iter(data)
    pf = Prefetcher(it, depth=2)
    batches = [next(pf) for _ in range(3)]
    assert len(batches) == 3
    pf.close()


# ------------------------------------------------ checkpoint interchange

def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jmodel, tmodel = _pair("gemma2-2b")
    jstate = jinit(jmodel, jax.random.PRNGKey(4))
    root = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(root, 5, jstate)
    restored, step = restore_checkpoint(root, init_train_state(tmodel))
    assert step == 5
    _leaves_close(jstate, restored, 0, 0)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jmodel, tmodel = _pair("gemma2-2b")
    tstate = init_train_state(tmodel, generator=torch.Generator()
                              .manual_seed(4))
    root = str(tmp_path / "ckpt")
    save_checkpoint(root, 6, tstate)
    restored, step = jckpt.restore_checkpoint(
        root, jinit(jmodel, jax.random.PRNGKey(0)))
    assert step == 6
    _leaves_close(restored, tstate, 0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_the_reference_bytes(tmp_path, dtype):
    """Every leaf file the port writes equals the reference's for the same
    state, bf16 leaves (``<V2``) included; the manifests agree but for
    the time."""
    jmodel, tmodel = _pair("gemma2-2b", dtype=dtype)
    jstate = jinit(jmodel, jax.random.PRNGKey(0))
    tstate = init_train_state(tmodel)
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save_checkpoint(a, 2, jstate)
    save_checkpoint(b, 2, tstate)
    da, db = (os.path.join(r, "step_00000002") for r in (a, b))
    files = sorted(os.listdir(da))
    assert files == sorted(os.listdir(db))
    for f in files:
        if f == "MANIFEST.json":
            ma, mb = (json.load(open(os.path.join(d, f))) for d in (da, db))
            assert ma["leaves"] == mb["leaves"] and ma["step"] == mb["step"]
        else:
            assert open(os.path.join(da, f), "rb").read() == \
                open(os.path.join(db, f), "rb").read(), f


def test_bf16_state_roundtrips_bit_equal(tmp_path):
    """A bf16 state after a step (params, master, m, v, step) comes back
    bit for bit; the reference cannot restore bf16 leaves at all."""
    _, tmodel = _pair("gemma2-2b", dtype="bfloat16")
    state = init_train_state(tmodel)
    state, _ = make_train_step(tmodel, AdamWConfig(warmup_steps=0))(
        state, _tb(_batch(tmodel.cfg, 0)))
    assert state.params["embedding"].dtype == torch.bfloat16
    root = str(tmp_path / "ckpt")
    save_checkpoint(root, 1, state)
    restored, _ = restore_checkpoint(root, state)
    _assert_trees_equal(state, restored)


# -------------------- tests/test_models.py smoke, the dense architectures

@pytest.mark.parametrize("arch", ["mistral_large_123b", "gemma2_2b",
                                  "smollm_360m", "granite_8b"])
def test_smoke_forward_and_train_step(arch):
    cfg = CB.reduced_config(CB.get_config(arch))
    model = DenseLM(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = _t(rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32))
    batch = {"tokens": tok, "labels": tok}
    logits = model.forward(batch)
    assert logits.shape == (2, S, cfg.padded_vocab)
    assert bool(torch.isfinite(torch.where(torch.isneginf(logits), 0.0,
                                           logits)).all())
    state = init_train_state(model)
    before = [p.clone() for p in T.tree_leaves(state.params)]
    state, metrics = make_train_step(model, AdamWConfig(peak_lr=1e-3))(
        state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    # params actually moved
    assert any(not torch.equal(a, b)
               for a, b in zip(before, T.tree_leaves(state.params)))


# --------------------------- tests/test_roofline.py, the dense analytics

H100 = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


def test_analytic_dense_train_flops():
    """smollm train_4k: analytic per-chip flops ~= 3 * 2*N*T / chips
    within 2x (attention & vocab add the rest)."""
    cfg = CB.get_config("smollm_360m")
    shape = CB.SHAPES["train_4k"]
    cost = analytic.cost_cell(cfg, shape, {"data": 16, "model": 16},
                              dp_used=("data",))
    n = cfg.param_count()
    t = shape.global_batch * shape.seq_len
    floor = 6 * n * t / 256
    assert cost.flops_hlo_equiv >= floor * 0.8
    assert cost.flops_hlo_equiv <= floor * 4
    terms = cost.terms(**H100)
    assert all(v >= 0 for v in terms.values())


def test_analytic_decode_memory_bound():
    """decode_32k on a dense arch must be memory-dominated (KV cache +
    weights streaming) at the H100's rates too."""
    cfg = CB.get_config("granite_8b")
    cost = analytic.cost_cell(cfg, CB.SHAPES["decode_32k"],
                              {"data": 16, "model": 16}, dp_used=("data",))
    t = cost.terms(**H100)
    assert t["memory_s"] > t["compute_s"]


@pytest.mark.parametrize("shape", sorted(CB.SHAPES))
@pytest.mark.parametrize("arch", ["gemma2_2b", "smollm_360m", "granite_8b",
                                  "mistral_large_123b"])
def test_analytic_matches_reference(arch, shape):
    kw = dict(mesh_sizes={"pod": 2, "data": 8, "model": 4},
              dp_used=("data",), microbatches=2)
    got = analytic.cost_cell(CB.get_config(arch), CB.SHAPES[shape], **kw)
    want = janalytic.cost_cell(jget_config(arch), JSHAPES[shape], **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rates = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    assert got.terms(**rates) == want.terms(**rates)


def test_analytic_needs_the_chip_rates_and_a_dense_config():
    """``terms()`` takes the chip's rates from the caller (no default).
    (The name is kept from when ``cost_cell`` took dense configs only;
    every family's terms are in ``tests/test_torch_families.py``.)"""
    cost = analytic.cost_cell(CB.get_config("gemma2_2b"),
                              CB.SHAPES["train_4k"], {"data": 1})
    with pytest.raises(TypeError):
        cost.terms()


# -------------------------------------------------------------- the CLI

def test_train_cli_on_the_cpu(tmp_path, capsys):
    report = train_cli.main(
        ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
         "--steps", "20", "--batch", "4", "--seq", "16", "--log-every", "5",
         "--ckpt-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert report.restarts == 0 and report.completed_steps == 20
    assert sum(line.startswith("step ") for line in out.splitlines()) == 4
    assert "[done] steps=20 restarts=0 final_loss=" in out
    assert list_steps(str(tmp_path / "run"))[-1] == 20


def test_train_cli_needs_cuda_or_an_explicit_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "2",
                        "--ckpt-dir", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseLM(CB.reduced_config(CB.get_config("smollm_360m")))


def test_training_path_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.train, repro_torch.train.checkpoint\n"
            "import repro_torch.train.compression\n"
            "import repro_torch.train.fault_tolerance\n"
            "import repro_torch.launch.train, repro_torch.data.tokens\n"
            "import repro_torch.utils, repro_torch.utils.analytic\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
