"""The ring's backward and ``act_spec`` (sequence parallelism of the
residual stream) against the JAX reference, on the CPU.

One four-rank gloo world (``torch_lm_seqpar_cases.rank_main``, each rank
a fresh interpreter with one thread) runs every case on ``(2, 2)`` and
``(1, 4)`` meshes over ``("data", "model")``; three JAX subprocesses run
the reference on 4 virtual devices.  They start once per module and run
side by side; each has a deadline of 300 s, and every process group of
the world a timeout of 60 s.

Tolerances:

* The gradients of q, k and v through ``attn_ring``: within 5e-5 of
  ``jax.grad`` through the reference's ``attn_ring`` and of autograd
  through the port's ``attn_ref``.
* The train step (the ring's, with and without ``act_spec``, and the
  families' under ``act_spec``): ``tests/test_torch_lm_mesh.py``'s,
  ``torch_lm_mesh_cases._compare_step`` (metrics rtol 1e-5, ``m`` rtol
  1e-4 and 1e-5 of the
  leaf's largest, ``v`` rtol 2e-4, parameters within lr * 1e-3, or 2 lr
  where the gradient is near zero) against the reference; ten times
  tighter against the port's meshless step with chunked attention.
* The prefill under ``act_spec``: logits and cache within 1e-4 of the
  reference and 1e-5 of the meshless port.
* The planted faults (the ring's backward shifting forward; the layer
  gather's gradient sliced where it must be summed) must fall outside
  these.
"""
import dataclasses
import json
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_seqpar_cases as C  # noqa: E402
from torch_lm_mesh_cases import (  # noqa: E402
    _compare_step, _split, make_batch, ring_inputs, weights)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import build_model, params_from_numpy  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_train_state, make_train_step)
from repro_torch.utils import sharding as SH  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402

WORLD_DEADLINE_S = 300.0
GRAD_ATOL = 5e-5


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The four-rank torch world and the JAX reference, side by side."""
    out = tmp_path_factory.mktemp("lm_seqpar")
    ref_dir = out / "reference"
    ref_dir.mkdir()
    refs = C.start_reference(str(ref_dir))
    ranks = C.run_world(str(out), timeout_s=WORLD_DEADLINE_S)
    for ref in refs:
        try:
            ref_out, _ = ref.communicate(timeout=WORLD_DEADLINE_S)
        except subprocess.TimeoutExpired:
            ref.kill()
            ref_out, _ = ref.communicate()
        assert ref.returncode == 0, ref_out[-4000:]
    for r, (rc, o) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{o[-4000:]}"
    got = []
    for r in range(C.WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = dict(z)
        got.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    want, want_meta = {}, {}
    for part in C.REFERENCE_PARTS:
        with np.load(ref_dir / f"reference_{part}.npz") as z:
            want.update(z)
        want_meta.update(json.loads(
            (ref_dir / f"reference_{part}.json").read_text()))
    return got, (want, want_meta)


# --------------------------------------------------------- the ring's grads

def _oracle_grads(case):
    """Autograd through the port's ``attn_ref`` on the whole batch."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in ring_inputs())
    pos = torch.arange(q.shape[1])
    o = TL.attn_ref(q, k, v, pos, pos, **C.RING_CASES[case])
    (o * torch.from_numpy(C.ring_cotangent())).sum().backward()
    return {n: t.grad.numpy() for n, t in zip("qkv", (q, k, v))}


@pytest.mark.parametrize("tag", list(C.MESHES))
@pytest.mark.parametrize("case", list(C.RING_CASES))
def test_ring_gradients_match_reference(worlds, case, tag):
    """Every rank's gradients of its rows, gathered: ``jax.grad``
    through the reference's ``attn_ring`` on the same virtual mesh, and
    autograd through ``attn_ref``."""
    ranks, (want, _) = worlds
    oracle = _oracle_grads(case)
    for arrays, _ in ranks:
        for n in "qkv":
            key = f"ring_grad/{tag}/{case}/{n}"
            np.testing.assert_allclose(arrays[key], want[key], rtol=0,
                                       atol=GRAD_ATOL, err_msg=key)
            np.testing.assert_allclose(arrays[key], oracle[n], rtol=0,
                                       atol=GRAD_ATOL, err_msg=key)


def test_ring_backward_shifting_forward_is_caught(worlds):
    """The planted fault: on 4 ranks of the ring a backward that sends
    each gradient on to the next rank gives dK and dV to the wrong
    blocks, far outside the tolerance."""
    ranks, (want, _) = worlds
    tag = C.FAULT_MESH
    for arrays, _ in ranks:
        for n in "kv":
            bad = arrays[f"ring_grad_fault/{tag}/causal/{n}"]
            assert np.abs(bad - want[f"ring_grad/{tag}/causal/{n}"]).max() \
                > 100 * GRAD_ATOL
        # dQ needs no shift back: the fault leaves it right
        np.testing.assert_allclose(arrays[f"ring_grad_fault/{tag}/causal/q"],
                                   want[f"ring_grad/{tag}/causal/q"],
                                   rtol=0, atol=GRAD_ATOL)


# -------------------------------------------------------- the train steps

def _meshless_step(cfg, seed, batch):
    """The port's step without a mesh on the same weights and batch."""
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, weights(cfg, seed),
                                                 "cpu"))
    state, met = make_train_step(
        model, AdamWConfig(peak_lr=C.LR, warmup_steps=0))(
        init_train_state(model),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return ({n: C._np(x) for n, x in flatten_with_paths(state)},
            {k: float(v) for k, v in met.items()})


def _check_step(worlds, prefix, plain, pmet):
    ranks, (want, want_meta) = worlds
    wstate = _split(want, prefix)
    wmet = want_meta[prefix + "metrics"]
    for arrays, meta in ranks:
        got = _split(arrays, prefix)
        gmet = meta[prefix + "metrics"]
        assert sorted(got) == sorted(wstate) == sorted(plain)
        assert set(gmet) == set(wmet)
        assert gmet["tokens"] == wmet["tokens"] == pmet["tokens"]
        _compare_step(wstate, got, wmet, gmet, C.LR, 1e-5)
        _compare_step(plain, got, pmet, gmet, C.LR, 1e-6, p_tol=1e-5)
        assert gmet == ranks[0][1][prefix + "metrics"]


@pytest.mark.parametrize("tag", list(C.MESHES))
@pytest.mark.parametrize("name", list(C.RING_TRAIN))
def test_ring_train_step_matches_reference(worlds, name, tag):
    """Granite-style (window 0) with ``attn_impl="ring"`` over model, one
    step (``ring_act``: under ``act_spec``, the ring taking the rank's
    chunk directly): the reference's GSPMD step with the same ring and
    ``act_spec``, and the port's meshless chunked step."""
    cfg = C.ring_cfg()
    batch = make_batch(cfg, 14, C.B_TRAIN)
    plain, pmet = _meshless_step(dataclasses.replace(
        cfg, attn_impl="chunked"), 4, batch)
    _check_step(worlds, f"{name}/{tag}/", plain, pmet)


@pytest.mark.parametrize("tag", list(C.MESHES))
@pytest.mark.parametrize("fam", list(C.FAMILIES))
def test_act_spec_train_step_matches_reference(worlds, fam, tag):
    """One step under ``act_spec = P("data", "model", None)``: the
    reference's GSPMD step with the same ``act_spec``, and the port's
    meshless step.  Between layers each rank keeps S / M rows."""
    cfg = C.family_cfg(fam)
    batch = make_batch(cfg, 15, C.B_TRAIN)
    plain, pmet = _meshless_step(cfg, 3, batch)
    _check_step(worlds, f"act/{fam}/{tag}/", plain, pmet)
    m = C.MESHES[tag][1]
    for _, meta in worlds[0]:
        assert meta[f"act/{fam}/{tag}/kept_rows"] == [C.S // m]


def test_act_spec_gather_gradient_sliced_is_caught(worlds):
    """The planted fault: the layer gather's gradient sliced where each
    rank computed only its chunk's share and the shares must be summed.
    The step leaves the tolerance."""
    ranks, (want, want_meta) = worlds
    tag = C.FAULT_MESH
    prefix = f"act/dense/{tag}/"
    wstate = _split(want, prefix)
    for arrays, meta in ranks:
        bad = _split(arrays, f"act_fault/{tag}/")
        with pytest.raises(AssertionError):
            _compare_step(wstate, bad, want_meta[prefix + "metrics"],
                          meta[f"act_fault/{tag}/metrics"], C.LR, 1e-5)


# ------------------------------------------------------------- the prefill

@pytest.mark.parametrize("tag", list(C.MESHES))
@pytest.mark.parametrize("fam", list(C.FAMILIES))
def test_act_spec_prefill_matches_reference(worlds, fam, tag):
    """The prefill's last logits and its whole cache under ``act_spec``:
    the reference's prefill with the same ``act_spec`` and the meshless
    port's."""
    ranks, (want, _) = worlds
    cfg = C.family_cfg(fam)
    model = build_model(cfg, device="cpu", params=params_from_numpy(
        cfg, weights(cfg, 3), "cpu"))
    batch = make_batch(cfg, 16, C.B_SERVE)
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}
    logits, cache = model.prefill(tb, cache_len=C.prefill_cache_len(cfg))
    mine = {"logits": logits.numpy(),
            **{f"cache/{k}": c.numpy() for k, c in cache.items()}}
    prefix = f"act_prefill/{fam}/{tag}/"
    for arrays, _ in ranks:
        for k, v in mine.items():
            got = arrays[prefix + k]
            np.testing.assert_allclose(got, want[prefix + k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


# ------------------------------------------------------------- off a mesh

@pytest.mark.parametrize("fam", list(C.FAMILIES))
def test_act_spec_off_a_mesh_changes_nothing(fam):
    """Without a mesh ``act_spec`` changes the step bit for bit in
    nothing, as the reference ignores it."""
    cfg = C.family_cfg(fam)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, 15, C.B_TRAIN).items()}
    runs = []
    for act in (None, SH.P(*C.ACT)):
        model = build_model(cfg, device="cpu", params=params_from_numpy(
            cfg, weights(cfg, 3), "cpu"))
        model.act_spec = act
        state, met = make_train_step(model, AdamWConfig())(
            init_train_state(model), batch)
        runs.append(([C._np(x).tobytes()
                      for _, x in flatten_with_paths(state)],
                     {k: float(v) for k, v in met.items()}))
    assert runs[0] == runs[1]
