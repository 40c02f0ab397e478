"""The port's PaliGemma-style VLM (``models/vlm.py``) against the JAX
reference, on the CPU.

The prefix-LM mask (bidirectional over the image prefix, causal over
the text) in every attention form against the reference's; patch
embeddings before the (scaled) token embeddings; logits and loss over
the text positions only; a cache over prefix and text with decoding
from ``prefix_len + S``; the flash path's refusal of the prefix; then
the reduced model against the reference's (``tests/torch_lm_cases.py``).
Tolerances: float32, 2e-5 for attention, 1e-4 for models.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
import torch_lm_cases as C  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b=2, s=24, hq=4, hkv=1, dh=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, dh)).astype(np.float32)
                 for h in (hq, hkv, hkv))


@pytest.mark.parametrize("prefix", [1, 8, 24])
def test_prefix_mask_matches_reference(prefix):
    """The mask itself, and attention under it (ref and chunked forms)."""
    pos = np.arange(24)
    m = TL._mask(torch.from_numpy(pos), torch.from_numpy(pos), True, 0,
                 prefix)
    want = JL._mask(jnp.asarray(pos), jnp.asarray(pos), True, 0, prefix)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want))
    assert bool(m[:prefix, :prefix].all())            # bidirectional
    assert not bool(m.triu(1)[prefix:].any())         # causal text
    q, k, v = _qkv(prefix)
    for fn, jfn, kw in ((TL.attn_ref, JL.attn_ref, {}),
                        (TL.attn_chunked, JL.attn_chunked,
                         dict(chunk_q=8, chunk_k=8))):
        got = fn(*(torch.from_numpy(a) for a in (q, k, v)),
                 torch.from_numpy(pos), torch.from_numpy(pos), True,
                 prefix=prefix, **kw)
        want = jfn(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos),
                   jnp.asarray(pos), True, prefix=prefix, **kw)
        C.close(got, want, 2e-5)


def test_embeddings_put_the_patches_first():
    """The prefix is the patch embeddings as given (cast), the text the
    token embeddings scaled by sqrt(d_model), as the reference's."""
    jmodel, jparams, tmodel = C.pair("paligemma_3b")
    batch = C.make_batch(tmodel.cfg, 1)
    jx, jpos = jmodel._embed_inputs(jparams, C.jb(batch))
    with torch.no_grad():
        x, pos = tmodel._embed_inputs(tmodel.params, C.tb(batch))
    p = tmodel.cfg.prefix_len
    assert x.shape == (2, p + C.S, tmodel.cfg.d_model)
    np.testing.assert_array_equal(x[:, :p].numpy(), batch["patch_embeds"])
    C.close(x, jx, 1e-6)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_text_logits_see_the_whole_prefix():
    """Changing the last patch changes the first text position's logits
    (and the reference's alike); changing a later token does not change
    an earlier text position's."""
    jmodel, jparams, tmodel = C.pair("paligemma_3b", seed=2)
    batch = C.make_batch(tmodel.cfg, 2)
    del batch["labels"]
    a = tmodel.forward(C.tb(batch))
    moved = dict(batch, patch_embeds=batch["patch_embeds"].copy())
    moved["patch_embeds"][:, -1] += 1.0
    b = tmodel.forward(C.tb(moved))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    C.close(b, jmodel.forward(jparams, C.jb(moved)), 1e-4)
    later = dict(batch, tokens=batch["tokens"].copy())
    later["tokens"][:, -1] = (later["tokens"][:, -1] + 1) % tmodel.cfg.vocab_size
    c = tmodel.forward(C.tb(later))
    assert torch.equal(a[:, :-1], c[:, :-1])


def test_cache_covers_prefix_and_text():
    _, _, tmodel = C.pair("paligemma_3b")
    cfg = tmodel.cfg
    batch = C.make_batch(cfg, 3)
    del batch["labels"]
    _, cache = tmodel.prefill(C.tb(batch))
    assert cache["k"].shape[2] == cfg.prefix_len + C.S
    with pytest.raises(ValueError, match="cache_len"):
        tmodel.prefill(C.tb(batch), cache_len=C.S)


def test_flash_refuses_the_prefix():
    """The kernel has no prefix-LM zone: a flash VLM raises (the
    reference's flash drops the prefix silently)."""
    _, _, tmodel = C.pair("paligemma_3b", attn_impl="flash")
    batch = C.make_batch(tmodel.cfg, 4)
    del batch["labels"]
    with pytest.raises(ValueError, match="prefix"):
        tmodel.prefill(C.tb(batch))


@pytest.mark.parametrize("check", sorted(C.MODEL_CHECKS))
def test_model_matches_reference(check):
    C.MODEL_CHECKS[check]("paligemma_3b")
