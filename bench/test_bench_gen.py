"""The generators: deterministic in the seed, simple undirected graphs."""
from __future__ import annotations

import json

import pytest
import torch

from bench.conftest import REPO, TINY_CONFIG
from bench.gen import idsets, kronecker


def config(name: str) -> dict:
    cfg = json.loads((REPO / "bench" / "configs" / f"{name}.json").read_text())
    return {**cfg, **TINY_CONFIG[name]}


GENERATORS = [("graph500-s21", kronecker), ("idsets-s22", idsets)]


def assert_simple(e, w_low, w_high):
    assert e.lo.dtype == e.hi.dtype == torch.int64
    assert e.w.dtype == torch.float32
    assert bool((e.lo < e.hi).all()), "self-loop or an unordered pair"
    key = e.lo * e.n_vertices + e.hi
    assert torch.unique(key).numel() == key.numel(), "duplicate pair"
    assert int(e.hi.max()) < e.n_vertices and int(e.lo.min()) >= 0
    assert float(e.w.min()) >= w_low and float(e.w.max()) <= w_high


@pytest.mark.parametrize("name,gen", GENERATORS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_generator_is_deterministic_and_simple(name, gen, seed):
    cfg = config(name)
    a = gen.generate(cfg, seed, "cpu")
    b = gen.generate(cfg, seed, "cpu")
    assert torch.equal(a.lo, b.lo) and torch.equal(a.hi, b.hi)
    assert torch.equal(a.w, b.w)
    assert a.n_pairs > a.n_vertices // 2
    assert_simple(a, cfg["weight_low"], cfg["weight_high"])


@pytest.mark.parametrize("name,gen", GENERATORS)
def test_seeds_give_other_inputs(name, gen):
    cfg = config(name)
    a = gen.generate(cfg, 1, "cpu")
    b = gen.generate(cfg, 2, "cpu")
    assert not (a.n_pairs == b.n_pairs and torch.equal(a.lo, b.lo)
                and torch.equal(a.hi, b.hi))


def test_kronecker_seeds_relabel_one_structure():
    """Every seed serves the structure seed's graph, weights and root order
    under other labels."""
    cfg = config("graph500-s21")
    a = kronecker.generate(cfg, 1, "cpu")
    b = kronecker.generate(cfg, 2, "cpu")

    def canonical(e):
        # relabel every vertex by its place in the root order
        rank = torch.empty(e.n_vertices, dtype=torch.int64)
        rank[e.order] = torch.arange(e.n_vertices)
        lo, hi = rank[e.lo], rank[e.hi]
        key = torch.minimum(lo, hi) * e.n_vertices + torch.maximum(lo, hi)
        order = torch.argsort(key)
        return key[order], e.w[order]

    ka, wa = canonical(a)
    kb, wb = canonical(b)
    assert torch.equal(ka, kb) and torch.equal(wa, wb)
    assert not torch.equal(a.order, b.order)


def test_idsets_degree_is_bounded_and_ids_local():
    cfg = config("idsets-s22")
    e = idsets.generate(cfg, 3, "cpu")
    assert int(e.degrees().max()) <= 40
    gap = torch.minimum(e.hi - e.lo, e.n_vertices - (e.hi - e.lo))
    assert float(gap.float().median()) <= 4


def test_idsets_pairs_a_user_are_the_sources():
    """1.50e9 edges over 2.41e9 vertices (arXiv:2204.11338 section IV-C-2):
    0.62 distinct pairs a user."""
    cfg = {**config("idsets-s22"), "n_users": 1 << 16}
    e = idsets.generate(cfg, 4, "cpu")
    assert e.n_pairs / e.n_vertices == pytest.approx(1.50 / 2.41, rel=0.03)
