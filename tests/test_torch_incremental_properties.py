"""Mirror of ``tests/test_incremental_properties.py``: the algebra of
``GraphCOO.apply_delta``'s canonicalization in the port against the
reference — delta composition, add/remove inversion and equivalence to
a scratch build — on seeded instances and, with hypothesis, generated
edge lists.

Each instance runs the reference property in both packages and holds
the two to the same digests and edge buffers (``torch_parity.both``).
Tolerance: none.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import both, edges  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # optional test dep: seeded cases only
    HAVE_HYPOTHESIS = False

V = 60


def _graph(M, rng, n_edges=120, symmetrize=False):
    src = rng.integers(0, V, n_edges)
    dst = rng.integers(0, V, n_edges)
    return M.build_coo(src, dst, V, symmetrize=symmetrize)


def _pairs(rng, n):
    return np.stack([rng.integers(0, V, n), rng.integers(0, V, n)], axis=1)


def _present_pairs(coo):
    src, dst, _ = edges(coo)
    return set(zip(src.tolist(), dst.tolist()))


def _coo_rec(g):
    s, d, w = edges(g)
    return [g.content_digest(), g.n_edges, g.symmetric, s, d, w]


def _check_batch_equals_split(coo, added):
    batch = coo.apply_delta(added=added)
    rec = [_coo_rec(batch)]
    for cut in sorted({1, len(added) // 2, len(added) - 1}):
        split = coo.apply_delta(added=added[:cut]) \
                   .apply_delta(added=added[cut:])
        assert split.content_digest() == batch.content_digest()
        rec.append(split.content_digest())
    return rec


def _check_add_remove_roundtrip(coo, pairs):
    present = _present_pairs(coo)
    fresh = np.array([p for p in map(tuple, pairs.tolist())
                      if p not in present
                      and (not coo.symmetric or p[::-1] not in present)])
    if fresh.shape[0] == 0:
        return None
    child = coo.apply_delta(added=fresh)
    back = child.apply_delta(removed=fresh)
    assert back.content_digest() == coo.content_digest()
    assert child.content_digest() != coo.content_digest()
    return [_coo_rec(child), _coo_rec(back)]


def _check_scratch_equivalence(M, coo, added, removed):
    child = coo.apply_delta(added=added, removed=removed)
    src, dst, w = edges(coo)
    src, dst = src.astype(np.int64), dst.astype(np.int64)
    add_s, add_d = added[:, 0], added[:, 1]
    rem_s, rem_d = removed[:, 0], removed[:, 1]
    if coo.symmetric:
        add_s, add_d = (np.concatenate([add_s, add_d]),
                        np.concatenate([add_d, add_s]))
        rem_s, rem_d = (np.concatenate([rem_s, rem_d]),
                        np.concatenate([rem_d, rem_s]))
    stride = np.int64(V + 1)
    keep = ~np.isin(src * stride + dst, rem_s * stride + rem_d)
    scratch = M.build_coo(
        np.concatenate([src[keep], add_s]),
        np.concatenate([dst[keep], add_d]), V,
        w=np.concatenate([w[keep], np.ones(add_s.shape[0], np.float32)]))
    scratch.symmetric = coo.symmetric
    assert child.content_digest() == scratch.content_digest()
    return [_coo_rec(child), _coo_rec(scratch)]


# ---------------------------------------------------------------------------
# Seeded deterministic instances — always run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("symmetric", [False, True],
                         ids=["directed", "symmetric"])
def test_delta_composition_seeded(seed, symmetric):
    def case(M):
        rng = np.random.default_rng(seed)
        return _check_batch_equals_split(
            _graph(M, rng, symmetrize=symmetric), _pairs(rng, 12))
    both(case)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("symmetric", [False, True],
                         ids=["directed", "symmetric"])
def test_add_remove_roundtrip_seeded(seed, symmetric):
    def case(M):
        rng = np.random.default_rng(100 + seed)
        return _check_add_remove_roundtrip(
            _graph(M, rng, symmetrize=symmetric), _pairs(rng, 20))
    both(case)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("symmetric", [False, True],
                         ids=["directed", "symmetric"])
def test_scratch_equivalence_seeded(seed, symmetric):
    def case(M):
        rng = np.random.default_rng(200 + seed)
        coo = _graph(M, rng, symmetrize=symmetric)
        src, dst, _ = edges(coo)
        removed = np.stack([src[:4], dst[:4]], axis=1).astype(np.int64)
        return _check_scratch_equivalence(M, coo, _pairs(rng, 10), removed)
    both(case)


# ---------------------------------------------------------------------------
# Hypothesis variants — same properties, generated instances
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:
    edge_lists = st.lists(
        st.tuples(st.integers(0, V - 1), st.integers(0, V - 1)),
        min_size=2, max_size=24).map(lambda e: np.asarray(e, np.int64))

    @given(base=edge_lists, added=edge_lists, symmetric=st.booleans())
    @settings(max_examples=60, deadline=None)
    def test_delta_composition_generated(base, added, symmetric):
        def case(M):
            coo = M.build_coo(base[:, 0], base[:, 1], V,
                              symmetrize=symmetric)
            return _check_batch_equals_split(coo, added)
        both(case)

    @given(base=edge_lists, pairs=edge_lists, symmetric=st.booleans())
    @settings(max_examples=60, deadline=None)
    def test_add_remove_roundtrip_generated(base, pairs, symmetric):
        def case(M):
            coo = M.build_coo(base[:, 0], base[:, 1], V,
                              symmetrize=symmetric)
            return _check_add_remove_roundtrip(coo, pairs)
        both(case)

    @given(base=edge_lists, added=edge_lists, symmetric=st.booleans())
    @settings(max_examples=60, deadline=None)
    def test_scratch_equivalence_generated(base, added, symmetric):
        def case(M):
            coo = M.build_coo(base[:, 0], base[:, 1], V,
                              symmetrize=symmetric)
            return _check_scratch_equivalence(M, coo, added,
                                              base[: len(base) // 2])
        both(case)
