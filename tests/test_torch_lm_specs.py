"""The port's partition-spec trees against the JAX reference's, on the CPU.

For every architecture of both packages, reduced and at full size, with
``fsdp`` on and off, ``strip_tp`` on and off and ``multi_pod`` True and
False (the dry run's hooks: on a multi-pod mesh the FSDP axes widen to
``("data", "pod")``): ``param_spec``, ``state_spec`` (no compression,
int8, top-k; bf16 and float32) and ``cache_spec`` equal the reference's
leaf for leaf, by ``flatten_with_paths`` name, each compared as a tuple;
``input_specs`` gives the same shapes, dtypes and specs for every
``SHAPES`` entry.  Exact equality everywhere: these are trees of names.
The port's models are built on the meta device, so the full-size ones
(DBRX-132B among them) hold no weights.

Also ``shard_index``'s refusals where JAX refuses (its block map itself
is held against JAX's ``devices_indices_map`` on virtual meshes in
``tests/test_torch_lm_mesh.py``), the ring's refusal off a mesh and its
gradients on a one-rank mesh.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs.base import ARCHS as JARCHS  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced_config as jreduced  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.train.compression import CompressionConfig as JComp  # noqa: E402
from repro.train.train_step import state_spec as jstate_spec  # noqa: E402
from repro.utils.tree import flatten_with_paths as jflat  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import build_model, init_params  # noqa: E402
from repro_torch.train.compression import CompressionConfig  # noqa: E402
from repro_torch.train.train_step import state_spec  # noqa: E402
from repro_torch.utils import sharding as SH  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402

HOOKS = [(fsdp, strip, multi) for fsdp in (False, True)
         for strip in (False, True) for multi in (False, True)]


def _pair(arch, reduced, fsdp, strip, multi, **changes):
    """The reference's model and the port's (weights on the meta device),
    with the dry run's hooks."""
    jcfg = jget_config(arch)
    tcfg = CB.get_config(arch)
    if reduced:
        jcfg, tcfg = jreduced(jcfg), CB.reduced_config(tcfg)
    jcfg = dataclasses.replace(jcfg, fsdp=fsdp, **changes)
    tcfg = dataclasses.replace(tcfg, fsdp=fsdp, **changes)
    jm = jbuild(jcfg)
    tm = build_model(tcfg, device="meta", params=init_params(tcfg, "meta"))
    for m in (jm, tm):
        m.strip_tp = strip
        if multi and fsdp:
            m.fsdp_axes = ("data", "pod")
    return jm, tm


def _same_specs(got, want):
    g = flatten_with_paths(got)
    w = jflat(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert isinstance(a, SH.P) and isinstance(b, JP), name
        assert tuple(a) == tuple(b), (name, a, b)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", JARCHS)
def test_spec_trees_match_reference(arch, reduced):
    """param_spec, state_spec and cache_spec, every hook setting."""
    for fsdp, strip, multi in HOOKS:
        jm, tm = _pair(arch, reduced, fsdp, strip, multi)
        _same_specs(tm.param_spec(), jm.param_spec())
        _same_specs(tm.cache_spec(multi), jm.cache_spec(multi))
        for dtype in ("bfloat16", "float32"):
            jm2, tm2 = _pair(arch, reduced, fsdp, strip, multi, dtype=dtype)
            for kind in ("none", "int8", "topk"):
                _same_specs(state_spec(tm2, CompressionConfig(kind=kind)),
                            jstate_spec(jm2, JComp(kind=kind)))
            _same_specs(state_spec(tm2), jstate_spec(jm2))


_JDTYPES = {jnp.dtype(jnp.int32): torch.int32,
            jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("arch", JARCHS)
def test_input_specs_match_reference(arch):
    for reduced in (True, False):
        jm, tm = _pair(arch, reduced, False, False, False)
        for name, shape in JSHAPES.items():
            tshape = CB.SHAPES[name]
            for multi in (False, True):
                want = jm.input_specs(shape, multi_pod=multi)
                got = tm.input_specs(tshape, multi_pod=multi)
                assert sorted(got["arrays"]) == sorted(want["arrays"])
                for k, a in want["arrays"].items():
                    t = got["arrays"][k]
                    assert t.device.type == "meta", k
                    assert tuple(t.shape) == tuple(a.shape), (name, k)
                    assert t.dtype == _JDTYPES[jnp.dtype(a.dtype)], k
                _same_specs(got["specs"], want["specs"])


# ---------------------------------------------------------- refusals

def test_partition_spec_normalises_as_jax_does():
    for entries in [("model", ("data",)), ((), None), (("data", "pod"),),
                    (None, None, "model"), ()]:
        assert tuple(SH.P(*entries)) == tuple(JP(*entries))
    assert SH.P("a") == SH.P(("a",))
    assert SH.P(("pod", "data")) != SH.P(("data", "pod"))


@pytest.mark.parametrize("shape,spec,match", [
    ((5, 6), (("data", "pod"), "model"), "partitioned 4 times"),
    ((6, 3), (None, "model"), "partitioned 2 times"),
    ((1, 4), ("data",), "partitioned 2 times"),
    ((4,), ("bogus",), "not found in mesh"),
    ((4, 4), ("data", "data"), "more than one dimension"),
    ((4,), (None, "model"), "more named entries"),
])
def test_shard_index_refuses_what_jax_refuses(shape, spec, match):
    with pytest.raises(ValueError, match=match):
        SH.shard_index(shape, SH.P(*spec), (2, 2, 2),
                       ("pod", "data", "model"), (0, 1, 1))


def test_shard_index_accepts_trailing_none_entries():
    assert SH.shard_index((4, 6), SH.P("data", None, None), (2, 2),
                          ("data", "model"), (1, 0)) == (slice(2, 4),
                                                         slice(0, 6))


class _OneRankMesh:
    """What ``attn_ring`` reads of a 1 x 1 ``DeviceMesh`` (an axis of size
    1 issues no collective)."""
    mesh_dim_names = ("data", "model")
    shape = (1, 1)

    def get_coordinate(self):
        return [0, 0]


def test_ring_needs_a_mesh_and_is_forward_only():
    """``impl="ring"`` raises without a mesh, as the reference's does.
    The ring is no longer forward only: on a one-rank mesh its output
    and its gradients of q, k and v are ``attn_ref``'s."""
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="ring"):
        TL.attention_output(q, q, q, torch.arange(4), torch.arange(4),
                            "ring")
    gen = torch.Generator().manual_seed(0)
    ins = [torch.randn(2, 16, 4, 8, generator=gen) for _ in range(3)]
    ins[1], ins[2] = ins[1][:, :, :2], ins[2][:, :, :2]
    pos = torch.arange(16)
    outs = []
    for ring in (True, False):
        ts = [t.clone().requires_grad_() for t in ins]
        o = TL.attn_ring(*ts, mesh=_OneRankMesh(), chunk_k=4) if ring \
            else TL.attn_ref(*ts, pos, pos, causal=True)
        (o * o).sum().backward()
        outs.append([o.detach()] + [t.grad for t in ts])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_hooks_default_as_the_reference():
    jm, tm = _pair("granite-8b", True, True, False, False)
    for hook in ("act_spec", "fsdp_axes", "strip_tp", "ring_mesh",
                 "ring_batch_axes"):
        assert getattr(tm, hook) == getattr(jm, hook), hook
    assert tm.mesh is None and tm._fsdp_ax() == jm._fsdp_ax() == "data"
