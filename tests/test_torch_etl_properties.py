"""Hypothesis properties of the port's graph layouts: mirrors of
``tests/test_etl_properties.py`` on CPU tensors, each example also held
byte for byte against the JAX reference.

``hypothesis`` is an optional test dependency; the module skips without
it, as the reference's does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="optional test dep: hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import graph as JG  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402

CPU = "cpu"



@settings(max_examples=30, deadline=None)
@given(n_edges=st.integers(1, 300), n_vertices=st.integers(2, 50),
       cap=st.integers(1, 20), seed=st.integers(0, 10**6))
def test_ell_invariants(n_edges, n_vertices, cap, seed):
    """(1) retained <= total; (2) per-row degree <= cap; (3) retained =
    sum of min(indeg, cap); (4) lost_fraction in [0, 1]; and the layout
    is the reference's, byte for byte."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    ell = G.build_ell(src, dst, n_vertices, cap, device=CPU)
    assert ell.n_edges <= ell.n_edges_total == n_edges
    per_row = ell.mask.numpy().sum(axis=1)
    assert (per_row <= cap).all()
    indeg = np.bincount(dst, minlength=n_vertices)
    assert ell.n_edges == int(np.minimum(indeg, cap).sum())
    assert 0.0 <= ell.lost_fraction <= 1.0
    jell = JG.build_ell(src, dst, n_vertices, cap)
    assert ell.nbr.numpy().tobytes() == np.asarray(jell.nbr).tobytes()
    assert ell.mask.numpy().tobytes() == np.asarray(jell.mask).tobytes()


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10**6), n=st.integers(2, 60))
def test_coo_symmetrize_property(seed, n):
    rng = np.random.default_rng(seed)
    e = rng.integers(1, 100)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    g = G.build_coo(src, dst, n, symmetrize=True, device=CPU)
    s = g.src[:g.n_edges].numpy()
    d = g.dst[:g.n_edges].numpy()
    fwd = set(zip(s.tolist(), d.tolist()))
    assert all((b, a) in fwd for a, b in fwd)   # symmetric closure
    jg = JG.build_coo(src, dst, n, symmetrize=True)
    assert g.content_digest() == jg.content_digest()
