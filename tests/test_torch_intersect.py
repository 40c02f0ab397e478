"""The sorted-row intersection kernel's plain version and wrappers against
the JAX reference (``repro.kernels.ell_intersect``).

Mirrors ``tests/test_kernels.py``'s ell_intersect section: the row-pair
form on ragged shapes (JAX's Pallas kernel in interpret mode, its
``searchsorted`` reference and Python sets), all-sentinel and identical
rows, then the per-oriented-edge counts over ``OrientedELL``s that both
packages build from the same edges.  Counts are integers: every
comparison is exact.  For CPU tensors the wrappers run the plain version
and launch nothing; the CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.kernels.ell_intersect.ops import (  # noqa: E402
    ell_intersect as j_intersect,
    ell_intersect_counts as j_counts,
    ell_intersect_rows_ref as j_rows_ref,
)
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.ell_intersect import ops  # noqa: E402
from repro_torch.kernels.ell_intersect.ref import (  # noqa: E402
    ell_intersect_counts_plain, ell_intersect_plain)


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _sorted_rows(rng, e, k, vx, fill=0.6):
    """Random sorted, deduped, sentinel-padded rows (the OrientedELL
    row invariant); sentinel == vx."""
    rows = np.full((e, k), vx, dtype=np.int32)
    for i in range(e):
        n = rng.integers(0, int(k * fill) + 1)
        vals = rng.choice(vx, size=min(n, vx), replace=False)
        vals.sort()
        rows[i, : len(vals)] = vals
    return rows


def _sets(a, b, vx):
    return np.array([len(set(ra[ra < vx]) & set(rb[rb < vx]))
                     for ra, rb in zip(a, b)])


@pytest.mark.parametrize("e,k,vx", [(16, 8, 40), (100, 37, 64),
                                    (256, 128, 500), (7, 200, 300),
                                    (30, 1, 5), (5, 3000, 20000)])
def test_rows_match_reference_and_sets(e, k, vx):
    """Ragged shapes, K = 1 and K past the reference's 2048-slot VMEM
    bound: the port equals JAX's kernel, its reference and Python sets."""
    rng = np.random.default_rng(e * k)
    a = _sorted_rows(rng, e, k, vx)
    b = _sorted_rows(rng, e, k, vx)
    want = _sets(a, b, vx)
    before = ops.KERNEL_LAUNCHES
    got = ops.ell_intersect(torch.from_numpy(a), torch.from_numpy(b), vx)
    assert ops.KERNEL_LAUNCHES == before          # CPU: no launch
    assert got.dtype == torch.int32 and got.shape == (e,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ell_intersect_plain(torch.from_numpy(a), torch.from_numpy(b),
                            vx).numpy(), want)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(np.asarray(j_intersect(ja, jb, vx)), want)
    np.testing.assert_array_equal(np.asarray(j_rows_ref(ja, jb, vx)), want)


def test_sentinel_rows_count_zero():
    """All-sentinel rows (padding edges gathering the padding row) count
    nothing — the sentinel never matches the sentinel."""
    vx = 32
    a = np.full((8, 16), vx, dtype=np.int32)
    b = np.full((8, 16), vx, dtype=np.int32)
    b[0, :3] = [1, 5, 9]
    got = ell_intersect_plain(torch.from_numpy(a), torch.from_numpy(b), vx)
    assert (got.numpy() == 0).all()
    want = np.asarray(j_intersect(jnp.asarray(a), jnp.asarray(b), vx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_identical_rows():
    vx = 100
    row = np.array([2, 3, 5, 7, 11, vx, vx, vx], dtype=np.int32)
    a = np.tile(row, (8, 1))
    got = ops.ell_intersect(torch.from_numpy(a), torch.from_numpy(a), vx)
    assert (got.numpy() == 5).all()


def test_empty_rows_and_no_slots():
    assert ell_intersect_plain(torch.zeros((0, 4), dtype=torch.int32),
                               torch.zeros((0, 4), dtype=torch.int32),
                               9).shape == (0,)
    got = ell_intersect_plain(torch.zeros((3, 0), dtype=torch.int32),
                              torch.zeros((3, 0), dtype=torch.int32), 9)
    assert got.dtype == torch.int32 and (got == 0).all()


def _random_edges(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n), n


def _identifier_edges(n, seed):
    sets = synthetic.identifier_edge_sets(n, n_sets=4, mean_degree=1.5,
                                          seed=seed)
    return (np.concatenate([s for s, _ in sets]),
            np.concatenate([d for _, d in sets]), n)


def _star_edges():
    n = 64
    return np.zeros(n - 1, np.int64), np.arange(1, n), n


def _self_loop_edges():
    return np.array([0, 1, 2, 0, 3, 3]), np.array([1, 2, 0, 0, 3, 1]), 4


EDGES = {
    "random": lambda: _random_edges(250, 3),
    "identifier": lambda: _identifier_edges(3000, 7),
    "star": _star_edges,
    "self_loop": _self_loop_edges,
}


def _oriented_pair(src, dst, n):
    jg = JG.build_coo(src, dst, n, symmetrize=True)
    tg = TG.build_coo(src, dst, n, symmetrize=True, device="cpu")
    jo = JG.build_oriented_ell(np.asarray(jg.src)[: jg.n_edges],
                               np.asarray(jg.dst)[: jg.n_edges], n)
    to = TG.build_oriented_ell(tg.src[: tg.n_edges].numpy(),
                               tg.dst[: tg.n_edges].numpy(), n,
                               device="cpu")
    return jo, to


@pytest.mark.parametrize("kind", sorted(EDGES))
@pytest.mark.parametrize("chunk_edges", [1 << 18, 100])
def test_counts_match_reference_per_edge(kind, chunk_edges):
    """Per oriented edge, the port's counts equal JAX's (Pallas in
    interpret mode and its reference), on orientations both packages
    built from the same edges; chunking does not change them."""
    jo, to = _oriented_pair(*EDGES[kind]())
    np.testing.assert_array_equal(to.nbr.numpy(), np.asarray(jo.nbr))
    want = j_counts(jo, use_pallas=False)
    np.testing.assert_array_equal(j_counts(jo, use_pallas=True), want)
    for use_kernels in (True, False):
        got = ops.ell_intersect_counts(to, use_kernels=use_kernels,
                                       chunk_edges=chunk_edges)
        assert got.dtype == torch.int32 and got.shape == (to.n_edges,)
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert int(got.sum(dtype=torch.int64)) == int(want.sum())


def test_padding_edges_count_zero():
    """Padding edges carry eu = ev = V and gather the all-sentinel row."""
    _, to = _oriented_pair(*_random_edges(250, 3))
    assert to.eu.shape[0] > to.n_edges
    full = TG.OrientedELL(to.nbr, to.eu, to.ev, to.n_vertices,
                          int(to.eu.shape[0]))
    counts = ell_intersect_counts_plain(full, chunk_edges=333)
    assert (counts[to.n_edges:] == 0).all()
    assert torch.equal(counts[: to.n_edges],
                       ell_intersect_counts_plain(to))


def test_kernel_path_follows_k_alone():
    """The kernel's path is intersect's own rule (no launch shape borrowed
    from the superstep): rows of 1 to 32 slots staged in shared memory, a
    lane an edge; wider (and empty) rows on the search path, with lanes
    an edge growing with K; the wrapper and the CUDA source agree on the
    limit."""
    assert [ops._lanes_log2(k) for k in (0, 1, 9, 31, 32, 33, 200, 500,
                                         3000)] == [1, 0, 0, 0, 0, 2, 4, 5, 5]
    assert f"kStagedMaxK = {ops.STAGED_MAX_K};" in \
        (ops.CSRC / "intersect.cu").read_text()
    assert "pregel_superstep" not in open(ops.__file__).read()
