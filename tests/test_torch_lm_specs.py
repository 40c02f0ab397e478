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
``tests/test_torch_lm_mesh.py``) and the ring's and ``act_spec``'s
refusals off a mesh.
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


def test_ring_needs_a_mesh_and_is_forward_only():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="ring"):
        TL.attention_output(q, q, q, torch.arange(4), torch.arange(4),
                            "ring")
    with pytest.raises(RuntimeError, match="forward only"):
        TL.attn_ring(q.requires_grad_(), q, q, mesh=None)


def test_hooks_default_as_the_reference():
    jm, tm = _pair("granite-8b", True, True, False, False)
    for hook in ("act_spec", "fsdp_axes", "strip_tp", "ring_mesh",
                 "ring_batch_axes"):
        assert getattr(tm, hook) == getattr(jm, hook), hook
    assert tm.mesh is None and tm._fsdp_ax() == jm._fsdp_ax() == "data"
