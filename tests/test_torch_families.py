"""The port's other LM families (MoE, hybrid, xLSTM, encoder-decoder, VLM)
against the JAX reference, on the CPU: the cases mirrored across the six
architectures.

The port's own versions of ``tests/test_models.py``'s
``test_smoke_forward_and_train_step``, ``test_decode_matches_forward``,
``test_full_config_param_counts`` and ``test_hymba_three_global_layers``
and of ``tests/test_roofline.py::test_analytic_moe_has_a2a``;
``cost_cell`` equal to the reference's for every architecture and shape;
``params_from_numpy`` for every family's tree; the serve CLI of every
family and its per-family attention default.  Each family's module and
model comparisons against the reference are in its own file
(``tests/test_torch_{moe,hybrid,xlstm,encdec,vlm}.py``, the shared cases
in ``tests/torch_lm_cases.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced_config as jreduced  # noqa: E402
from repro.models.layers import layer_windows as jwindows  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.utils import analytic as janalytic  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    build_model, params_from_numpy)
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_train_state, make_train_step)
from repro_torch.utils import analytic, tree as T  # noqa: E402
from torch_lm_cases import S, close, make_batch, pair, tb  # noqa: E402

ARCHS = ("olmoe_1b_7b", "dbrx_132b", "hymba_1p5b", "xlstm_125m",
         "whisper_large_v3", "paligemma_3b")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------- tests/test_models.py, mirrored

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    cfg = CB.reduced_config(CB.get_config(arch))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    batch = tb(make_batch(cfg, 0))
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
    assert any(not torch.equal(a, b)
               for a, b in zip(before, T.tree_leaves(state.params)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """As the reference's: ``attn_impl="ref"``, MoE capacity raised to
    100 (a decode step's block holds B tokens, a prefill's B * S, so
    drops would differ); prefill of S-1 tokens then one decode step equal
    the teacher-forced logits within 2e-4 / 2e-3."""
    cfg = dataclasses.replace(CB.reduced_config(CB.get_config(arch)),
                              attn_impl="ref", capacity_factor=100.0)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    batch = tb(make_batch(cfg, 1))
    tok = batch["tokens"]
    full = model.forward(batch)
    pre = dict(batch, tokens=tok[:, :S - 1])
    cache_len = S + cfg.prefix_len
    last, cache = model.prefill(pre, cache_len=cache_len)
    close(last[:, 0], full[:, S - 2], 2e-4)
    lg, _ = model.decode_step(tok[:, S - 1:S], cache, S - 1 + cfg.prefix_len)
    close(lg[:, 0], full[:, S - 1], 2e-3)


def test_full_config_param_counts():
    """Full configs hit their nameplate parameter counts (the reference's
    ranges), and the port's count equals the reference's."""
    expected = {
        "olmoe_1b_7b": (6e9, 8e9),
        "dbrx_132b": (120e9, 140e9),
        "xlstm_125m": (0.1e9, 0.2e9),
        "hymba_1p5b": (1.2e9, 2.2e9),
        "whisper_large_v3": (1.2e9, 2.0e9),
        "paligemma_3b": (2.2e9, 3.5e9),
    }
    for arch, (lo, hi) in expected.items():
        n = CB.get_config(arch).param_count()
        assert n == jget_config(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B"
        assert CB.get_config(arch).active_param_count() == \
            jget_config(arch).active_param_count()


def test_hymba_three_global_layers():
    w = np.asarray(TL.layer_windows(CB.get_config("hymba_1p5b")))
    assert (w == 0).sum() == 3
    assert w[0] == 0 and w[15] == 0 and w[31] == 0
    assert w.tolist() == np.asarray(
        jwindows(jget_config("hymba_1p5b"))).tolist()


# --------------------------------- the cost model, every family

H100 = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


def test_analytic_moe_has_a2a():
    cfg = CB.get_config("olmoe_1b_7b")
    cost = analytic.cost_cell(cfg, CB.SHAPES["train_4k"],
                              {"data": 16, "model": 16}, dp_used=("data",))
    assert "moe_a2a" in cost.breakdown["coll"]
    assert cost.breakdown["coll"]["moe_a2a"] > 0
    assert all(v >= 0 for v in cost.terms(**H100).values())


@pytest.mark.parametrize("shape", sorted(CB.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_matches_reference(arch, shape):
    """Every term equal to the reference's (the same float operations)."""
    kw = dict(mesh_sizes={"pod": 2, "data": 8, "model": 4},
              dp_used=("data",), microbatches=2)
    got = analytic.cost_cell(CB.get_config(arch), CB.SHAPES[shape], **kw)
    want = janalytic.cost_cell(jget_config(arch), JSHAPES[shape], **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rates = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    assert got.terms(**rates) == want.terms(**rates)


# ----------------------------------------------------- serving, flash

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "on cpu" in out


@pytest.mark.parametrize("arch,impl", [
    ("olmoe_1b_7b", "flash"), ("hymba_1p5b", "flash"),
    ("xlstm_125m", "chunked"), ("whisper_large_v3", "chunked"),
    ("paligemma_3b", "chunked"), ("gemma2_2b", "flash")])
def test_serve_attention_default_per_family(arch, impl):
    """``flash`` where the kernel takes the family's prefill attention;
    the configs' ``chunked`` for the VLM (prefix-LM zone) and Whisper
    (cross attention over keys of another length), where ``flash``
    raises."""
    model = serve.build(arch, reduced=True, device="cpu")
    assert model.cfg.attn_impl == impl
    if model.cfg.family in ("vlm", "encdec"):
        flash = serve.build(arch, reduced=True, device="cpu",
                            attn_impl="flash")
        batch = serve.prompts(flash.cfg, 2, 8, device="cpu")
        with pytest.raises(ValueError):
            flash.prefill(batch)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "hymba_1p5b",
                                  "xlstm_125m"])
def test_remat_on_equals_off(arch):
    """Remat checkpoints each layer (MoE's with the running router loss
    beside the hidden states; xLSTM's each block pair): the loss, every
    metric and every gradient equal bit for bit."""
    out = []
    for remat in (False, True):
        _, _, tmodel = pair(arch, remat=remat)
        loss, metrics = tmodel.loss(tb(make_batch(tmodel.cfg, 4)))
        grads = torch.autograd.grad(loss, list(tmodel.parameters()))
        out.append([*(metrics[k].detach() for k in sorted(metrics)),
                    *grads])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_checks_the_family_tree(arch):
    """The reference's tree fits its family's model; a tree of another
    family or a wrong shape does not."""
    jmodel, jparams, tmodel = pair(arch)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert T.param_count(params_from_numpy(tmodel.cfg, tree, "cpu")) == \
        sum(np.size(a) for a in jax.tree_util.tree_leaves(tree))
    other = jbuild(jreduced(jget_config(
        "olmoe_1b_7b" if arch == "hymba_1p5b" else "hymba_1p5b")))
    with pytest.raises(ValueError, match="does not fit"):
        params_from_numpy(tmodel.cfg, jax.tree_util.tree_map(
            np.asarray, other.init(jax.random.PRNGKey(0))), "cpu")
    tree["embedding"] = tree["embedding"][:-1]
    with pytest.raises(ValueError, match="does not fit"):
        params_from_numpy(tmodel.cfg, tree, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    """A reference train state of every family, saved by the reference's
    checkpointer, restores into the port's state leaf for leaf (the
    same leaf names and files; float32, bit for bit)."""
    from repro.train import checkpoint as jckpt
    from repro.train.train_step import init_train_state as jinit
    from repro.utils.tree import flatten_with_paths as jflat
    from repro_torch.train.checkpoint import restore_checkpoint
    jmodel, _, tmodel = pair(arch)
    jstate = jinit(jmodel, jax.random.PRNGKey(4))
    root = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(root, 3, jstate)
    restored, step = restore_checkpoint(root, init_train_state(tmodel))
    assert step == 3
    want, got = jflat(jstate), T.flatten_with_paths(restored)
    assert [n for n, _ in want] == [n for n, _ in got]
    for (name, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
