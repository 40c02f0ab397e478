"""The port's ``flash_attention`` against the reference's, on the CPU.

On the CPU the port's wrapper runs its plain version (``mha_plain``); the
reference runs its Pallas kernel in interpret mode (blocks of 64, as
``tests/test_kernels.py`` runs it) and its oracle ``mha_reference``.  The
matrix is the reference's: MHA, GQA and MQA x causal, non-causal, sliding
window and softcap; float32 within 2e-5 (summation order) and bfloat16
within 2e-2 (the reference's own bf16 tolerance).  Ragged S, which the
reference's kernel rejects (S must be a multiple of its block), is held
to ``mha_reference`` alone.  The CUDA kernel itself is checked against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention import mha_reference  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    REL_TOL, flash_attention, mha_plain, rel_err)

SHAPES = [
    (1, 2, 2, 128, 32),     # MHA
    (2, 4, 2, 256, 64),     # GQA
    (1, 8, 1, 128, 64),     # MQA
]
OPTIONS = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=64),
    dict(causal=True, softcap=30.0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _port(arrs, dtype, **kw):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    out = flash_attention(*t, **kw)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    return out.float().numpy()


def _ref(fn, arrs, dtype, **kw):
    j = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    return np.asarray(fn(*j, **kw), dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kw", OPTIONS, ids=str)
def test_flash_matches_reference_kernel_and_oracle(shape, kw, dtype):
    b, hq, hkv, s, d = shape
    arrs = _inputs(*shape, seed=s + hq)
    got = _port(arrs, dtype, **kw)
    tol = TOL[dtype]
    kernel = _ref(lambda *a, **k: jflash(*a, block_q=64, block_k=64, **k),
                  arrs, dtype, **kw)
    np.testing.assert_allclose(got, kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _ref(mha_reference, arrs, dtype, **kw),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(1, 8, 1, 100, 32), (3, 8, 1, 77, 64),
                                   (2, 6, 3, 1, 16)], ids=str)
@pytest.mark.parametrize("kw", OPTIONS + [dict(causal=False, window=5),
                                         dict(causal=True, window=3,
                                              softcap=50.0)], ids=str)
def test_flash_ragged_length_matches_oracle(shape, kw):
    arrs = _inputs(*shape, seed=7)
    np.testing.assert_allclose(_port(arrs, "float32", **kw),
                               _ref(mha_reference, arrs, "float32", **kw),
                               rtol=2e-5, atol=2e-5)


def test_flash_plain_switch_is_the_plain_version():
    arrs = [torch.from_numpy(a) for a in _inputs(2, 4, 2, 64, 32, seed=1)]
    kw = dict(causal=True, window=9, softcap=20.0)
    assert torch.equal(flash_attention(*arrs, use_kernels=False, **kw),
                       mha_plain(*arrs, **kw))


def _torch_inputs(shape, seed, q_scale=1.0):
    q, k, v = (torch.from_numpy(a) for a in _inputs(*shape, seed=seed))
    return q * q_scale, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_err_passes_one_rounding(dtype):
    """The rounding of a float32 result to ``dtype`` stays within
    ``REL_TOL``; the same values compare at 0."""
    want = mha_plain(*_torch_inputs((2, 4, 2, 200, 64), seed=11),
                     causal=True, softcap=50.0)
    assert rel_err(want, want) == 0.0
    assert rel_err(want.to(dtype), want) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_err_sees_a_dropped_softcap_at_large_logits(dtype):
    """q scaled by 10 puts the scaled logits near the cap of 50 (std 10):
    attention without the cap is far outside ``REL_TOL``."""
    q, k, v = (t.to(dtype) for t in _torch_inputs((1, 4, 2, 256, 64),
                                                  seed=12, q_scale=10.0))
    want = mha_plain(q, k, v, causal=True, window=100, softcap=50.0)
    assert rel_err(mha_plain(q, k, v, causal=True, window=100), want) > \
        10 * REL_TOL[dtype]


def test_rel_err_sees_a_dropped_kv_tile_in_long_rows():
    """Dropping the first 64 keys for every query past them (a kv tile
    lost far from the diagonal) moves the long rows' outputs far past
    ``REL_TOL``."""
    q, k, v = _torch_inputs((1, 4, 2, 4096, 64), seed=13)
    want = mha_plain(q, k, v, causal=True)
    fault = torch.cat([want[:, :, :64], mha_plain(
        q[:, :, 64:], k[:, :, 64:], v[:, :, 64:], causal=True)], dim=2)
    long_rows = (slice(None), slice(None), slice(2048, None))
    assert rel_err(fault[long_rows], want[long_rows]) > \
        10 * REL_TOL[torch.bfloat16]


def test_flash_rejects_bad_options():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 2, 1, 16, 16, seed=2)]
    with pytest.raises(ValueError, match="window"):
        flash_attention(*arrs, window=-1)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(*arrs, softcap=-1.0)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 3, 2, 16, 16, seed=3))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", [
    ((1, 4, 2, 200, 64), dict(causal=True, window=40)),
    ((2, 2, 1, 333, 32), dict(causal=True, window=17, softcap=30.0)),
    ((1, 3, 1, 129, 16), dict(causal=False, window=63)),
    ((1, 2, 2, 255, 128), dict(causal=True, window=1)),
], ids=str)
def test_flash_ragged_length_short_window_matches_oracle(shape, kw, dtype):
    """S not a multiple of the card kernel's 128-row query tile, windows
    under one 64-key tile: the plain version the kernel is held to agrees
    with the reference's oracle (in bfloat16 within its own tolerance)."""
    arrs = _inputs(*shape, seed=shape[3] + kw["window"])
    tol = TOL[dtype]
    np.testing.assert_allclose(_port(arrs, dtype, **kw),
                               _ref(mha_reference, arrs, dtype, **kw),
                               rtol=tol, atol=tol)


def test_flash_kernel_argument_checks_on_any_device():
    """The wrapper's checks run before the device test, so each is seen
    here on CPU tensors; a layout the kernel takes (the model's
    transposed [B, S, H, D] views included) reaches the device test."""
    from repro_torch.kernels.flash_attention.ops import _check
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, 4, 2, 64, 64, seed=4))
    with pytest.raises(ValueError, match="unsupported device"):
        _check(q, k, v)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    with pytest.raises(ValueError, match="unsupported device"):
        _check(qt, kt, vt)
    # k and v broadcast over their heads (stride 0): TMA cannot walk them
    kb, vb = (t[:, :1].expand(1, 2, 64, 64) for t in (k, v))
    with pytest.raises(ValueError, match="zero stride"):
        _check(q, kb, vb)
    with pytest.raises(ValueError, match="unsupported device"):
        _check(q.float(), kb.float(), vb.float())   # the FMA kernel reads them
    with pytest.raises(ValueError, match="aligned"):
        _check(q[..., 1:33], k[..., 1:33], v[..., 1:33])
    with pytest.raises(ValueError, match="head dim"):
        _check(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="contiguous"):
        _check(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="dtype"):
        _check(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="do not fit"):
        _check(q, k[:, :, :32], v[:, :, :32])
