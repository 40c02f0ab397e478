"""The port's LM on a device mesh against the JAX reference, on the CPU.

One four-rank gloo world (``torch_lm_mesh_cases.rank_main``, each rank a
fresh interpreter with one thread) runs every case on ``(2, 2)`` and
``(4, 1)`` meshes over ``("data", "model")``; one JAX subprocess runs the
reference on 8 virtual devices (two subprocesses: the mesh cases and the
serving).  They start once per module and run side by side; each has a
deadline of 300 s, and every process group of the
world a timeout of 60 s.  Both take the same weights (the port's
``init_params`` from a seed, as numpy) and the same numpy batches.

Tolerances:

* ``shard_index``: equal to ``devices_indices_map`` block for block on
  meshes (1, 1), (2, 2), (4, 1), (1, 4) and (2, 2, 2), and refusing
  exactly where JAX refuses.
* ``attn_ring``: within 2e-5 of the reference's ``attn_ring`` and of
  ``attn_ref`` (the reference test's tolerance), on its inputs.
* The train step: against the reference's ``make_train_step`` under
  GSPMD with the same specs, ``tests/test_torch_train.py::
  _compare_step``'s tolerances (metrics rtol 1e-5; ``m`` rtol 1e-4 and
  1e-5 of the leaf's largest; ``v`` rtol 2e-4; parameters within lr *
  1e-3, or 2 lr where the gradient is near zero or an element crossed a
  compressor's rounding boundary or threshold); against the port's
  meshless step, the same checks ten times tighter (float sums that add
  in another order): metrics rtol 1e-6, ``m`` rtol 1e-5 and 1e-6 of the
  leaf's largest, ``v`` rtol 2e-5, parameters within lr * 1e-5.  The
  token count is exact.
* Sharded serving: greedy tokens equal to the meshless port's and the
  reference's; prefill and decode logits within 1e-4 of the reference
  (the families' parity tolerance) and 1e-5 of the meshless port.
* The ring prefill: logits and cache within 1e-5 of the meshless chunked
  prefill.
* The checkpoint: byte-equal leaves after a restore onto another mesh
  and onto none, and the files of the unsharded state.
"""
import json
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_mesh_cases as C  # noqa: E402
from torch_lm_mesh_cases import (  # noqa: E402
    _compare_step, _flip_steps, _split)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import build_model, params_from_numpy  # noqa: E402
from repro_torch.train.compression import CompressionConfig  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_train_state, make_train_step)
from repro_torch.utils import sharding as SH  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402

WORLD_DEADLINE_S = 300.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The four-rank torch world and the JAX reference, side by side."""
    out = tmp_path_factory.mktemp("lm_mesh")
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


# ------------------------------------------------------------- the layout

@pytest.mark.parametrize("tag", list(C.SHARD_MESHES))
def test_shard_index_matches_devices_indices_map(worlds, tag):
    _, (_, want) = worlds
    shape, axes = C.SHARD_MESHES[tag]
    refused = 0
    for i, (arr, spec) in enumerate(C.SHARD_SPECS):
        ref = want[f"shard/{tag}/{i}"]
        if "error" in ref:
            refused += 1
            with pytest.raises(ValueError):
                SH.shard_index(arr, SH.P(*spec), shape, axes,
                               (0,) * len(shape))
            continue
        for coord, blocks in ref["blocks"]:
            got = SH.shard_index(arr, SH.P(*spec), shape, axes, coord)
            assert [[s.start, s.stop] for s in got] == blocks, (i, coord)
    assert refused >= 2          # a non-dividing dimension, a doubled axis


# ------------------------------------------------------------ ring attention

@pytest.mark.parametrize("case", list(C.RING_CASES))
def test_ring_attention_matches_reference(worlds, case):
    """Every rank's rows (its data index's), the whole sequence, against
    the reference's ``attn_ring`` on a (2, 2) virtual mesh and against
    ``attn_ref``."""
    ranks, (want, _) = worlds
    q, k, v = (torch.from_numpy(a) for a in C.ring_inputs())
    pos = torch.arange(q.shape[1])
    oracle = TL.attn_ref(q, k, v, pos, pos, **C.RING_CASES[case]).numpy()
    for arrays, meta in ranks:
        d = meta["coordinate"][0]
        got = arrays[f"ring/{case}"]
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_allclose(got, want[f"ring/{case}"][rows],
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(got, oracle[rows], rtol=0, atol=2e-5)


# ------------------------------------------------------------ the train step

def _meshless(name):
    """The port's step without a mesh on the same weights and batch."""
    arch, _, mb, kind, _, _ = C.TRAIN_CASES[name]
    fsdp, batch = C.train_inputs(name)
    cfg = C.tconfig(arch, fsdp=fsdp)
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, C.weights(cfg), "cpu"))
    comp = CompressionConfig(kind=kind, topk_fraction=C.TOPK)
    state, met = make_train_step(
        model, AdamWConfig(peak_lr=C.LR, warmup_steps=0), microbatches=mb,
        compression=comp)(init_train_state(model, compression=comp),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    return ({n: C._np(x) for n, x in flatten_with_paths(state)},
            {k: float(v) for k, v in met.items()})


@pytest.mark.parametrize("name", list(C.TRAIN_CASES))
def test_train_step_on_mesh_matches_reference(worlds, name):
    """The state after one step, gathered, on every rank: the
    reference's GSPMD step with the same specs, and the port's meshless
    step; the state was laid out by ``state_spec``; every rank reports
    the same metrics."""
    ranks, (want, want_meta) = worlds
    prefix = f"train/{name}/"
    wstate = _split(want, prefix)
    wmet = want_meta[prefix + "metrics"]
    plain, pmet = _meshless(name)
    for arrays, meta in ranks:
        got = _split(arrays, prefix)
        gmet = meta[prefix + "metrics"]
        assert sorted(got) == sorted(wstate) == sorted(plain)
        assert meta[prefix + "placed_by_state_spec"]
        assert set(gmet) == set(wmet)
        if "tokens" in wmet:
            assert gmet["tokens"] == wmet["tokens"] == pmet["tokens"]
        _compare_step(wstate, got, wmet, gmet, C.LR, 1e-5,
                      _flip_steps(wstate))
        _compare_step(plain, got, pmet, gmet, C.LR, 1e-6,
                      _flip_steps(plain), p_tol=1e-5)
        assert gmet == ranks[0][1][prefix + "metrics"]


def test_moe_cases_drop_pairs():
    """At capacity 0.5 the reduced OLMoE's blocks overflow, so routing
    that a rank did from its own rows alone would keep other pairs."""
    from repro_torch.models import moe
    cfg = C.tconfig("olmoe-1b-7b")
    w = C.weights(cfg)
    x = torch.randn(C.B_TRAIN * C.S, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    p = {k: torch.from_numpy(v[0]) for k, v in w["layers"]["mlp"].items()}
    cap = moe._capacity(x.shape[0], cfg.n_experts, cfg.top_k,
                        cfg.capacity_factor)
    keep = moe.route(p, x, cfg, cap)[-1]
    assert 0 < (~keep).float().mean() < 1


# ----------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", list(C.SERVE_ARCHS))
def test_sharded_serving_matches(worlds, arch):
    """Greedy tokens, the prefill's last logits and one decode step's,
    with the params placed by ``param_spec`` and the cache by
    ``cache_spec``: every rank returns the global batch's."""
    ranks, (want, _) = worlds
    cfg = C.tconfig(arch)
    model = build_model(cfg, device="cpu", params=params_from_numpy(
        cfg, C.weights(cfg, 1), "cpu"))
    batch = C.make_batch(cfg, 12, C.B_SERVE)
    del batch["labels"]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    cl = C.serve_cache_len(cfg)
    tokens = greedy_generate(model, tb, C.GEN, cl).numpy()
    logits, cache = model.prefill(tb, cache_len=cl)
    nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    dec, _ = model.decode_step(nxt, cache, C.S + cfg.prefix_len)
    np.testing.assert_array_equal(tokens, want[f"serve/{arch}/tokens"])
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays[f"serve/{arch}/tokens"], tokens)
        for kind, mine in (("prefill", logits), ("decode", dec)):
            got = arrays[f"serve/{arch}/{kind}"]
            np.testing.assert_allclose(got, want[f"serve/{arch}/{kind}"],
                                       rtol=1e-4, atol=1e-4, err_msg=kind)
            np.testing.assert_allclose(got, mine.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=kind)


def test_ring_prefill_matches_the_meshless_prefill(worlds):
    """Granite (window 0) with ``attn_impl="ring"`` over model: the
    prefill's logits and its whole cache against the meshless chunked
    prefill."""
    ranks, _ = worlds
    cfg = C.tconfig(C.RING_ARCH)
    model = build_model(cfg, device="cpu", params=params_from_numpy(
        cfg, C.weights(cfg, 2), "cpu"))
    batch = C.make_batch(cfg, 13, C.B_SERVE)
    logits, cache = model.prefill({"tokens": torch.from_numpy(
        batch["tokens"])}, cache_len=C.S + 2)
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["ring_prefill/logits"],
                                   logits.numpy(), rtol=1e-5, atol=1e-5)
        for k, c in cache.items():
            np.testing.assert_allclose(arrays[f"ring_prefill/cache/{k}"],
                                       c.numpy(), rtol=1e-5, atol=1e-5)


# -------------------------------------------------- checkpoints, refusals

def test_checkpoint_restores_across_mesh_shapes(worlds):
    """Written from the (2, 2) state (rank 0 writes after gathering):
    the files equal the unsharded state's, and restoring onto (4, 1) and
    onto no mesh gives every leaf back byte for byte."""
    ranks, _ = worlds
    assert ranks[0][1]["ckpt/files_equal_unsharded"]
    for _, meta in ranks:
        assert meta["ckpt/restored_4x1_equal"]
        assert meta["ckpt/restored_meshless_equal"]


class _AnyMesh:
    """A mesh object the refusals below are raised before touching."""
    mesh_dim_names = ("data", "model")


def _ring_with_a_window():
    cfg = C.tconfig(C.RING_ARCH, attn_impl="ring", window=8)
    model = build_model(cfg, device="cpu", params=params_from_numpy(
        cfg, C.weights(cfg, 2), "cpu"))
    model.ring_mesh = _AnyMesh()
    model.forward({"tokens": torch.zeros((2, C.S), dtype=torch.int32)})


def _ring_axis_splitting_the_batch():
    q, k, v = (torch.from_numpy(a) for a in C.ring_inputs())
    TL.attn_ring(q, k, v, mesh=_AnyMesh(), axis="model",
                 batch_axes=("data", "model"))


def _threads_on_a_mesh_service():
    from repro_torch.core.graph import build_coo
    from repro_torch.core.service import GraphAnalyticsService
    g = build_coo(np.array([0, 1]), np.array([1, 2]), 3, device="cpu")
    GraphAnalyticsService(workers=2).add_graph("g", g, mesh=_AnyMesh(),
                                               device="cpu")


def _a_dry_run_cell_that_reads_the_host():
    from repro_torch.launch import dryrun as D
    D.measure(D.Program(
        lambda: torch.zeros(4, device="meta").sum().item(), {}))


REFUSALS = {
    "ring_window": (_ring_with_a_window, ValueError, "window 0"),
    "ring_axis_in_batch": (_ring_axis_splitting_the_batch, ValueError,
                           "also splits the batch"),
    "mesh_service_threads": (_threads_on_a_mesh_service, ValueError,
                             "rank to rank"),
    "dryrun_host_read": (_a_dry_run_cell_that_reads_the_host, Exception,
                         "meta"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_act_spec_and_the_ring_under_autograd_raise(case):
    """What still refuses, now that ``act_spec`` and the ring's backward
    are ported: the ring with a window (the reference asserts window 0),
    the ring's axis also splitting the batch, worker threads on a mesh
    service, and a dry-run cell whose path reads the host."""
    fn, err, words = REFUSALS[case]
    with pytest.raises(err, match=words) as info:
        fn()
    if case == "dryrun_host_read":
        from repro_torch.launch.dryrun import HostRead
        assert isinstance(info.value, HostRead)


def test_a_rank_that_skips_a_collective_fails_within_the_timeout(worlds):
    """On a mesh with a 5 s timeout rank 1 runs no train step: every rank
    waiting on it raises within the timeout instead of hanging."""
    ranks, _ = worlds
    for r, (_, meta) in enumerate(ranks):
        if r == 1:
            assert meta["skip/error"] is None
            continue
        assert meta["skip/error"] and "Timed out" in meta["skip/error"]
        assert meta["skip/seconds"] < 3 * C.SKIP_TIMEOUT_S


def test_specs_without_a_mesh_change_nothing():
    """``dp_spec`` / ``grad_spec`` on a model off a mesh: the step is the
    meshless one, bit for bit (the reference ignores them without a
    mesh)."""
    name = "dense_2x2"
    arch = C.TRAIN_CASES[name][0]
    fsdp, batch = C.train_inputs(name)
    cfg = C.tconfig(arch, fsdp=fsdp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = []
    for specs in ({}, {"dp_spec": "data"}):
        model = build_model(cfg, device="cpu", params=params_from_numpy(
            cfg, C.weights(cfg), "cpu"))
        if specs:
            specs["grad_spec"] = model.param_spec()
        state, met = make_train_step(model, AdamWConfig(peak_lr=C.LR),
                                     **specs)(init_train_state(model), tb)
        outs.append(([C._np(x).tobytes() for _, x in
                      flatten_with_paths(state)],
                     {k: float(v) for k, v in met.items()}))
    assert outs[0] == outs[1]
