"""Graph builders of the PyTorch port against the JAX reference.

The same numpy edge lists (``data/synthetic`` generators, fixed seeds)
go through both packages; every buffer must be byte-identical and the
content digests equal, since the digest keys the service's result
cache and the port keeps the reference's int32/bool/float32 dtypes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core.partition import partition_1d as j_partition_1d  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core.partition import partition, partition_1d  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _follow():
    s, d = synthetic.user_follow_graph(300, mean_degree=6.0, seed=1)
    return s, d, 300


def _identifier():
    sets = synthetic.identifier_edge_sets(500, n_sets=4, mean_degree=1.5,
                                          seed=2)
    return (np.concatenate([s for s, _ in sets]),
            np.concatenate([d for _, d in sets]), 500)


def _bipartite():
    users, ids = synthetic.safety_bipartite_graph(200, 80, seed=3)
    return users, ids + 200, 280


def _rmat():
    s, d, n = synthetic.rmat_graph(8, edge_factor=4, seed=4)
    return s, d, n


GRAPHS = {"follow": _follow, "identifier": _identifier,
          "bipartite": _bipartite, "rmat": _rmat}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _weights(n, seed=0):
    return np.random.default_rng(seed).uniform(0.1, 2.0, n).astype(np.float32)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_build_coo_bytes_and_digest(gname, symmetrize, weighted):
    s, d, n = GRAPHS[gname]()
    w = _weights(s.size) if weighted else None
    j = JG.build_coo(s, d, n, w=w, symmetrize=symmetrize)
    t = TG.build_coo(s, d, n, w=w, symmetrize=symmetrize, device="cpu")
    assert t.src.dtype == torch.int32 and t.w.dtype == torch.float32
    for a, b in ((j.src, t.src), (j.dst, t.dst), (j.w, t.w)):
        assert _bits(a) == _bits(b)
    assert (j.n_edges, j.n_vertices, j.symmetric) == \
        (t.n_edges, t.n_vertices, t.symmetric)
    assert j.content_digest() == t.content_digest()
    assert j.nbytes() == t.nbytes()


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("direction", ["in", "out"])
@pytest.mark.parametrize("max_degree", [1, 7, 64])
def test_build_ell_bytes(gname, direction, max_degree):
    s, d, n = GRAPHS[gname]()
    w = _weights(s.size, seed=1)
    j = JG.build_ell(s, d, n, max_degree, w=w, direction=direction)
    t = TG.build_ell(s, d, n, max_degree, w=w, direction=direction,
                     device="cpu")
    assert t.mask.dtype == torch.bool
    for a, b in ((j.nbr, t.nbr), (j.mask, t.mask), (j.w, t.w)):
        assert _bits(a) == _bits(b)
    assert (j.n_edges, j.n_edges_total) == (t.n_edges, t.n_edges_total)
    assert j.lost_fraction == t.lost_fraction


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_build_csr_and_oriented_bytes(gname):
    s, d, n = GRAPHS[gname]()
    j = JG.build_csr(s, d, n, symmetrize=True)
    t = TG.build_csr(s, d, n, symmetrize=True, device="cpu")
    for a, b in ((j.indptr, t.indptr), (j.indices, t.indices), (j.w, t.w)):
        assert _bits(a) == _bits(b)
    jc = JG.build_coo(s, d, n, symmetrize=True)
    src = np.asarray(jc.src)[: jc.n_edges]
    dst = np.asarray(jc.dst)[: jc.n_edges]
    jo = JG.build_oriented_ell(src, dst, n)
    to = TG.build_oriented_ell(src, dst, n, device="cpu")
    for a, b in ((jo.nbr, to.nbr), (jo.eu, to.eu), (jo.ev, to.ev)):
        assert _bits(a) == _bits(b)
    assert jo.n_edges == to.n_edges


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("n_data", [1, 2, 3])
def test_partition_1d_bytes(gname, n_data):
    s, d, n = GRAPHS[gname]()
    w = _weights(s.size, seed=2)
    j = j_partition_1d(JG.build_coo(s, d, n, w=w, symmetrize=True), n_data)
    t = partition_1d(TG.build_coo(s, d, n, w=w, symmetrize=True,
                                  device="cpu"), n_data)
    for a, b in ((j.src, t.src), (j.dst, t.dst), (j.w, t.w)):
        assert _bits(a) == _bits(b)
    assert (j.e_shard, j.v_local, j.n_pad, j.vertex_layout) == \
        (t.e_shard, t.v_local, t.n_pad, t.vertex_layout)


def test_partition_2d_waits_for_the_mesh_path():
    """The 2-D vertex-cut is the reference's byte for byte, and only a
    mesh runs it (the mesh path itself: tests/test_torch_mesh.py)."""
    from repro.core.partition import partition_2d as j_partition_2d
    from repro_torch.core.pregel import converged_halt, PregelSpec, run_pregel
    s, d, n = _follow()
    g = TG.build_coo(s, d, n, device="cpu")
    t = partition(g, 2, 2)
    j = j_partition_2d(JG.build_coo(s, d, n), 2, 2)
    for a, b in ((j.src, t.src), (j.dst, t.dst), (j.w, t.w)):
        assert _bits(a) == _bits(b)
    assert (j.e_shard, j.v_local, j.n_pad, j.vertex_layout) == \
        (t.e_shard, t.v_local, t.n_pad, "sharded")
    spec = PregelSpec(message=lambda x, w: x, combine="min",
                      apply=lambda old, agg, ids, gv: torch.minimum(old, agg),
                      identity=2**31 - 1, halt=converged_halt)
    with pytest.raises(ValueError, match="needs a mesh"):
        run_pregel(spec, t, torch.arange(t.n_pad, dtype=torch.int32), 3)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_coo_from_numpy_roundtrips_a_reference_graph(gname):
    s, d, n = GRAPHS[gname]()
    j = JG.build_coo(s, d, n, w=_weights(s.size, 3), symmetrize=True)
    t = TG.coo_from_numpy(np.asarray(j.src), np.asarray(j.dst),
                          np.asarray(j.w), j.n_vertices, j.n_edges,
                          j.symmetric, device="cpu")
    for a, b in ((j.src, t.src), (j.dst, t.dst), (j.w, t.w)):
        assert _bits(a) == _bits(b)
    assert t.content_digest() == j.content_digest()
    je = JG.build_ell(s, d, n, 16, direction="in")
    te = TG.ell_from_numpy(np.asarray(je.nbr), np.asarray(je.mask),
                           np.asarray(je.w), je.n_vertices, je.n_edges,
                           je.n_edges_total, device="cpu")
    for a, b in ((je.nbr, te.nbr), (je.mask, te.mask), (je.w, te.w)):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("symmetric", [False, True])
def test_apply_delta_children_match(symmetric):
    s, d, n = _identifier()
    j = JG.build_coo(s, d, n, symmetrize=symmetric)
    t = TG.build_coo(s, d, n, symmetrize=symmetric, device="cpu")
    added = [(0, 499), (3, 250), (17, 18)]
    removed = [(int(s[0]), int(d[0])), (int(s[5]), int(d[5]))]
    jc = j.apply_delta(added=added, removed=removed)
    tc = t.apply_delta(added=added, removed=removed)
    assert tc.content_digest() == jc.content_digest()
    assert tc.parent_digest == jc.parent_digest == j.content_digest()
    for a, b in ((jc.src, tc.src), (jc.dst, tc.dst), (jc.w, tc.w)):
        assert _bits(a) == _bits(b)
    assert _bits(jc.delta.touched) == _bits(tc.delta.touched)
    assert tc.delta.nbytes() == jc.delta.nbytes()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_combine_and_degrees(op):
    s, d, n = _follow()
    j = JG.build_coo(s, d, n, w=_weights(s.size, 4))
    t = TG.build_coo(s, d, n, w=_weights(s.size, 4), device="cpu")
    jv = JG.segment_combine(j.w, j.dst, n, op)
    tv = TG.segment_combine(t.w, t.dst, n, op)
    if op == "sum":
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    else:
        assert _bits(jv) == _bits(tv)
    assert _bits(JG.out_degrees(j)) == _bits(TG.out_degrees(t))
    assert _bits(JG.in_degrees(j)) == _bits(TG.in_degrees(t))


def test_move_keeps_digest_and_lineage():
    s, d, n = _follow()
    t = TG.build_coo(s, d, n, device="cpu").apply_delta(added=[(0, 1)])
    moved = t.to("cpu")
    assert moved is t
    t.content_digest()
    clone = TG.GraphCOO(t.src.clone(), t.dst.clone(), t.w.clone(),
                        t.n_vertices, t.n_edges, t.symmetric)
    assert clone.content_digest() == t.content_digest()


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the CUDA-less default")
def test_builders_default_to_cuda_and_raise_without_it():
    s, d, n = _follow()
    for build in (lambda: TG.build_coo(s, d, n),
                  lambda: TG.build_ell(s, d, n, 4),
                  lambda: TG.coo_from_numpy(s, d, np.ones(s.size), n,
                                            s.size)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
