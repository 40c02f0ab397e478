"""The port's LM serving path against the JAX reference, on the CPU.

Same numpy-made inputs and the same weights (the reference's
``DenseLM.init`` pytree carried over by ``params_from_numpy``) go through
both packages: the layers one by one (``rms_norm``, ``rope``, the three
attention forms, ``attn_decode``, ``mlp_apply``), then reduced
``gemma2-2b``, ``smollm-360m`` and ``granite-8b`` ``prefill`` (logits and
caches) and ``greedy_generate``.  The reference runs its flash path as
its own tests run it on the CPU: the Pallas kernel in interpret mode,
with ``scan_layers=False, remat=False`` (under scan or remat the
reference's flash path fails: ``layers.py:301`` calls ``int()`` on a
traced window).  Tolerances: float32 throughout, 2e-5 for single layers
and 1e-4 for whole models (summation order only).  Plus the port's own
decode-matches-forward check, the flash ``prefix`` raise, the configs of
all ten architectures, and the import boundary.  The other families are
held against the reference in ``tests/test_torch_{moe,hybrid,xlstm,
encdec,vlm,families}.py``.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import list_archs as jlist_archs  # noqa: E402
from repro.configs.base import reduced_config as jreduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.train.serve_step import greedy_generate as jgreedy  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import DenseLM  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma2-2b", "smollm-360m", "granite-8b")
S = 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


# ----------------------------------------------------------------- layers

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(TL.rms_norm(_t(x), _t(scale)), JL.rms_norm(_j(x), _j(scale)),
           2e-5)


@pytest.mark.parametrize("pos_shape", ["1d", "batched"])
def test_rope_matches_reference(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32) + 5
    if pos_shape == "batched":
        pos = np.stack([pos, pos * 3])
    _close(TL.rope(_t(x), _t(pos), 10000.0),
           JL.rope(_j(x), _j(pos), 10000.0), 2e-5)


ATTN_KW = [dict(causal=True), dict(causal=False),
           dict(causal=True, window=17), dict(causal=True, softcap=20.0),
           dict(causal=True, prefix=8)]


def _qkv(seed, b=2, s=96, hq=6, hkv=2, dh=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("kw", ATTN_KW, ids=str)
def test_attn_ref_matches_reference(kw):
    q, k, v = _qkv(2)
    pos = np.arange(q.shape[1])
    _close(TL.attn_ref(_t(q), _t(k), _t(v), _t(pos), _t(pos), **kw),
           JL.attn_ref(_j(q), _j(k), _j(v), _j(pos), _j(pos), **kw), 2e-5)


@pytest.mark.parametrize("kw", ATTN_KW, ids=str)
def test_attn_chunked_matches_reference(kw):
    q, k, v = _qkv(3)
    pos = np.arange(q.shape[1])
    got = TL.attn_chunked(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                          chunk_q=32, chunk_k=16, **kw)
    _close(got, JL.attn_chunked(_j(q), _j(k), _j(v), _j(pos), _j(pos),
                                chunk_q=32, chunk_k=16, **kw), 2e-5)
    _close(got, JL.attn_ref(_j(q), _j(k), _j(v), _j(pos), _j(pos), **kw),
           2e-5)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                        window=5),
                                dict(causal=True, softcap=30.0)], ids=str)
@pytest.mark.parametrize("index", [0, 7, "per-row"])
def test_attn_decode_matches_reference(kw, index):
    rng = np.random.default_rng(4)
    b, c, hq, hkv, dh = 3, 24, 4, 2, 16
    q = rng.standard_normal((b, 1, hq, dh)).astype(np.float32)
    kc = rng.standard_normal((b, c, hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, c, hkv, dh)).astype(np.float32)
    idx = np.array([3, 11, 23], np.int32) if index == "per-row" else index
    _close(TL.attn_decode(_t(q), _t(kc), _t(vc),
                          _t(idx) if index == "per-row" else idx, **kw),
           JL.attn_decode(_j(q), _j(kc), _j(vc), _j(idx), **kw), 2e-5)


def test_attention_output_flash_matches_reference_flash():
    q, k, v = _qkv(5, s=64)
    pos = np.arange(64)
    kw = dict(causal=True, window=24, softcap=50.0)
    _close(TL.attention_output(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                               "flash", **kw),
           JL.attention_output(_j(q), _j(k), _j(v), _j(pos), _j(pos),
                               "flash", **kw), 2e-5)


def test_attention_output_flash_refuses_prefix():
    q, k, v = (_t(a) for a in _qkv(6, s=16))
    pos = torch.arange(16)
    with pytest.raises(ValueError, match="prefix"):
        TL.attention_output(q, k, v, pos, pos, "flash", prefix=4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply_matches_reference(act):
    rng = np.random.default_rng(7)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("w_gate", (32, 80)), ("w_up", (32, 80)),
                      ("w_down", (80, 32)))}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    _close(TL.mlp_apply({n: _t(a) for n, a in p.items()}, _t(x), act),
           JL.mlp_apply({n: _j(a) for n, a in p.items()}, _j(x), act), 2e-5)


@pytest.mark.parametrize("arch", ARCHS + ("hymba_1p5b",))
def test_layer_windows_match_reference(arch):
    assert TL.layer_windows(CB.get_config(arch)) == np.asarray(
        JL.layer_windows(jget_config(arch))).tolist()


# ----------------------------------------------------------------- models

def _pair(arch, seed=0):
    """The reference's reduced model (flash, no scan, no remat) and the
    port's on the same weights."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               attn_impl="flash", scan_layers=False,
                               remat=False)
    tcfg = dataclasses.replace(CB.reduced_config(CB.get_config(arch)),
                               attn_impl="flash")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = DenseLM(tcfg, device="cpu",
                     params=params_from_numpy(tcfg, tree, "cpu"))
    return jmodel, jparams, tmodel


def _tokens(cfg, seed, b=2, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jmodel, jparams, tmodel = _pair(arch)
    tok = _tokens(tmodel.cfg, 1)
    want, jcache = jmodel.prefill(jparams, {"tokens": _j(tok)},
                                  cache_len=S + 4)
    got, cache = tmodel.prefill({"tokens": _t(tok)}, cache_len=S + 4)
    assert got.shape == tuple(want.shape) == (2, 1, tmodel.cfg.padded_vocab)
    _close(got, want, 1e-4)
    for name in ("k", "v"):
        assert cache[name].shape == tuple(jcache[name].shape)
        assert cache[name].dtype == torch.float32
        _close(cache[name], jcache[name], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    jmodel, jparams, tmodel = _pair(arch, seed=2)
    tok = _tokens(tmodel.cfg, 3)
    want = jgreedy(jmodel, jparams, {"tokens": _j(tok)}, steps=6,
                   cache_len=S + 6)
    got = greedy_generate(tmodel, {"tokens": _t(tok)}, steps=6,
                          cache_len=S + 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_from_numpy_rejects_a_tree_of_another_config():
    _, jparams, tmodel = _pair("smollm-360m")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="does not fit"):
        params_from_numpy(tmodel.cfg, tree, "cpu")


@pytest.mark.parametrize("impl", ["flash", "chunked", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, impl):
    """The reference's ``test_decode_matches_forward`` on the port: prefill
    of S-1 tokens then one decode step equal the teacher-forced logits."""
    cfg = dataclasses.replace(CB.reduced_config(CB.get_config(arch)),
                              attn_impl=impl)
    gen = torch.Generator().manual_seed(1)
    model = DenseLM(cfg, device="cpu", generator=gen)
    tok = _t(_tokens(cfg, 1))
    full = model.forward({"tokens": tok})
    last, cache = model.prefill({"tokens": tok[:, :S - 1]}, cache_len=S)
    _close(last[:, 0], full[:, S - 2], 2e-4)
    lg, _ = model.decode_step(tok[:, S - 1:S], cache, S - 1)
    _close(lg[:, 0], full[:, S - 1], 2e-3)


def test_serve_cli_on_the_cpu(capsys):
    serve.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "on cpu" in out


# ---------------------------------------------- configs, import boundary

def test_configs_match_reference():
    """All ten architectures, field for field, full and reduced."""
    assert CB.list_archs() == jlist_archs()
    for arch in CB.list_archs():
        assert dataclasses.asdict(CB.get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert CB.get_config(arch).param_count() == \
            jget_config(arch).param_count()
        assert dataclasses.asdict(CB.reduced_config(CB.get_config(arch))) \
            == dataclasses.asdict(jreduced(jget_config(arch)))


def test_serving_path_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.configs\n"
            "import repro_torch.models, repro_torch.models.transformer\n"
            "import repro_torch.models.moe, repro_torch.models.mamba\n"
            "import repro_torch.models.hybrid, repro_torch.models.xlstm\n"
            "import repro_torch.models.encdec, repro_torch.models.vlm\n"
            "import repro_torch.models.registry\n"
            "import repro_torch.train.serve_step\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.kernels.flash_attention\n"
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
