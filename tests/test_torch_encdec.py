"""The port's Whisper-style encoder-decoder (``models/encdec.py``)
against the JAX reference, on the CPU.

The sinusoid tables (the prefill's, in float64 then float32, and a
decode step's row, in float32), ``encode`` (non-causal encoder and
``enc_norm``), the decoder with cross attention (``forward``), its cache
(self k / v to ``cache_len``, cross k / v over the encoder's frames),
then the reduced model against the reference's
(``tests/torch_lm_cases.py``).  Tolerances: float32, 1e-5 for the tables
and the encoder, 1e-4 for models.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import encdec as JE  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
import torch_lm_cases as C  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seq,d", [(16, 64), (1500, 1280), (7, 10)])
def test_sinusoid_matches_reference(seq, d):
    got = TE._sinusoid(seq, d, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JE._sinusoid(seq,
                                                                       d)))


@pytest.mark.parametrize("index", [0, 5, 223, 1499])
def test_sinusoid_at_matches_reference_and_the_table(index):
    """A decode step's row in float32 against the reference's (1e-6) and
    against the prefill's float64 table (1e-4 at positions to 1500: the
    float32 angle)."""
    d = 64
    got = TE._sinusoid_at(index, d, torch.float32, "cpu")
    want = JE._sinusoid_at(jnp.int32(index), d, jnp.float32)
    assert got.shape == tuple(want.shape) == (1, 1, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got[0, 0].numpy(),
                               TE._sinusoid(index + 1, d, "cpu")[-1].numpy(),
                               atol=1e-4)


def test_encode_matches_reference():
    """The encoder's output over the reduced 16 frames: bidirectional (a
    frame late in the sequence changes the first frame's output)."""
    jmodel, jparams, tmodel = C.pair("whisper_large_v3")
    audio = C.make_batch(tmodel.cfg, 1)["audio_embeds"]
    want = jmodel.encode(jparams, jnp.asarray(audio))
    audio2 = audio.copy()
    audio2[:, -1] += 1.0
    with torch.no_grad():
        got = tmodel.encode(tmodel.params, C.t(audio))
        moved = tmodel.encode(tmodel.params, C.t(audio2))
    C.close(got, want, 1e-5)
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_decoder_cross_attends_to_the_audio():
    """The decoder's logits depend on the audio through the cross
    attention, and equal the reference's on the changed audio too."""
    jmodel, jparams, tmodel = C.pair("whisper_large_v3", seed=3)
    batch = C.make_batch(tmodel.cfg, 2)
    del batch["labels"]
    a = tmodel.forward(C.tb(batch))
    batch["audio_embeds"] = batch["audio_embeds"][::-1].copy()
    b = tmodel.forward(C.tb(batch))
    assert float((a - b).abs().max()) > 1e-3
    C.close(b, jmodel.forward(jparams, C.jb(batch)), 1e-4)


def test_cache_layout():
    """Self k / v to ``cache_len``; cross k / v over ``encoder_seq``
    frames, written once at prefill and read (not written) by decode."""
    _, _, tmodel = C.pair("whisper_large_v3")
    cfg = tmodel.cfg
    batch = C.make_batch(cfg, 3)
    del batch["labels"]
    _, cache = tmodel.prefill(C.tb(batch), cache_len=C.S + 3)
    assert cache["k"].shape == (cfg.n_layers, 2, C.S + 3, cfg.n_kv_heads,
                                cfg.d_head)
    assert cache["cross_k"].shape == (cfg.n_layers, 2, cfg.encoder_seq,
                                      cfg.n_kv_heads, cfg.d_head)
    assert bool((cache["k"][:, :, C.S:] == 0).all())
    cross = cache["cross_v"].clone()
    tmodel.decode_step(torch.zeros((2, 1), dtype=torch.int32), cache, C.S)
    assert torch.equal(cache["cross_v"], cross)
    assert bool((cache["k"][:, :, C.S] != 0).any())


@pytest.mark.parametrize("check", sorted(C.MODEL_CHECKS))
def test_model_matches_reference(check):
    C.MODEL_CHECKS[check]("whisper_large_v3")


def test_remat_on_equals_off():
    """Remat checkpoints each encoder and decoder layer: loss and
    gradients equal bit for bit."""
    out = []
    for remat in (False, True):
        _, _, tmodel = C.pair("whisper_large_v3", remat=remat)
        loss, _ = tmodel.loss(C.tb(C.make_batch(tmodel.cfg, 4)))
        grads = torch.autograd.grad(loss, list(tmodel.parameters()))
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_train_step_splits_every_stacked_group():
    """The train step hands the loss each stacked group (decoder layers,
    encoder layers, cross attention) as per-slice leaves split by the
    group's own leading size, so no slice's gradient is a full-size
    ``[L, ...]`` tensor; the step's result equals the reference's (the
    ``train_step`` case above)."""
    import dataclasses

    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    _, _, tmodel = C.pair("whisper_large_v3")
    tmodel.cfg = dataclasses.replace(tmodel.cfg, n_encoder_layers=3)
    tmodel.params["enc_layers"] = torch.nn.ParameterDict({
        k: (torch.nn.ParameterDict({kk: torch.nn.Parameter(
            torch.cat([vv, vv[:1]])) for kk, vv in v.items()})
            if isinstance(v, torch.nn.ParameterDict)
            else torch.nn.Parameter(torch.cat([v, v[:1]])))
        for k, v in tmodel.params["enc_layers"].items()})
    seen = {}
    loss = tmodel.loss

    def spy(batch, params=None, **kw):
        seen.update({k: (len(v), {t.shape for s in v
                                  for t in _leaves(s)})
                     for k, v in params.items() if isinstance(v, list)})
        return loss(batch, params=params, **kw)
    tmodel.loss = spy
    state, metrics = make_train_step(tmodel, AdamWConfig())(
        init_train_state(tmodel), C.tb(C.make_batch(tmodel.cfg, 5)))
    assert set(seen) == {"layers", "enc_layers", "cross"}
    assert seen["enc_layers"][0] == 3 and seen["layers"][0] == 2 \
        and seen["cross"][0] == 2
    # a slice of an [L, a, b] stack is 2-D; a whole stack would be 3-D
    assert all(len(shape) <= 2 for _, shapes in seen.values()
               for shape in shapes)
    assert np.isfinite(float(metrics["grad_norm"]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
