"""The fused superstep kernel's plain version and wrapper against the JAX
reference oracle (``repro.kernels.pregel_superstep.ref.superstep_ref``).

Mirrors ``tests/test_kernels.py``'s pregel_superstep section: ragged
shapes, empty rows, sentinel neighbors, trailing state dims and the
reduced-precision channel.  min/max are exact (bit-identical); float
sums agree to rtol 1e-5, since only the summation order differs.  For
CPU tensors the wrapper runs the plain version; the CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as JP  # noqa: E402
from repro.kernels.pregel_superstep.ref import superstep_ref  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.kernels.pregel_superstep import ops  # noqa: E402
from repro_torch.kernels.pregel_superstep.ref import superstep_plain  # noqa: E402

INF = float("inf")
IMAX = int(np.iinfo(np.int32).max)


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _j_relax(s, w):
    return s + w


def _inputs(v, k, vx, seed, x_kind="normal"):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, vx, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.7
    w = rng.standard_normal((v, k)).astype(np.float32)
    if x_kind == "normal":
        x = rng.standard_normal(vx).astype(np.float32)
    elif x_kind == "dist":
        x = rng.integers(0, 40, vx).astype(np.float32)
        x[rng.random(vx) < 0.3] = np.inf
    else:
        x = rng.permutation(vx).astype(np.int32)
    return nbr, mask, w, x


def _both(nbr, mask, w, x, t_msg, j_msg, op, identity, message_dtype=None):
    got = superstep_plain(torch.from_numpy(nbr), torch.from_numpy(mask),
                          torch.from_numpy(w), torch.from_numpy(x),
                          message=t_msg, op=op, identity=identity,
                          message_dtype=message_dtype)
    want = superstep_ref(jnp.asarray(nbr), jnp.asarray(mask),
                         jnp.asarray(w), jnp.asarray(x), message=j_msg,
                         op=op, identity=identity,
                         message_dtype=message_dtype)
    return got, np.asarray(want)


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("v,k,vx", [(64, 16, 80), (300, 37, 400),
                                    (1024, 128, 1024), (17, 200, 33)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_superstep_shapes(v, k, vx, op):
    """Plain version vs the reference oracle over ragged shapes."""
    nbr, mask, w, x = _inputs(v, k, vx, v + k)
    identity = 0.0 if op == "sum" else INF * (1 if op == "min" else -1)
    got, want = _both(nbr, mask, w, x, ops.msg_src_plus_w, _j_relax, op,
                      identity)
    assert got.shape == (v,) and got.dtype == torch.float32
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("t_msg,j_msg,x_kind,op,identity", [
    (ops.msg_src, lambda s, w: s, "ids", "min", IMAX),
    (ops.msg_src, lambda s, w: s, "ids", "max", -IMAX - 1),
    (ops.msg_src_plus_one, lambda s, w: s + 1.0, "dist", "min", INF),
    (ops.msg_src_plus_one, lambda s, w: s + 1.0, "ids", "min", INF),
    (ops.msg_src_plus_w, lambda s, w: s + w, "dist", "min", INF),
    (ops.msg_src_times_w, lambda s, w: s * w, "normal", "sum", 0.0),
])
def test_compiled_edge_programs_match_reference(t_msg, j_msg, x_kind, op,
                                                identity):
    """Each compiled edge program computes what the reference's inline
    callable does, including dtype promotion (int32 + 1.0 -> float32)."""
    nbr, mask, w, x = _inputs(257, 13, 300, 5, x_kind)
    got, want = _both(nbr, mask, w, x, t_msg, j_msg, op, identity)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    assert got.dtype == ops.kernel_out_dtype(torch.from_numpy(x), t_msg)
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert got.numpy().tobytes() == want.tobytes()


def test_superstep_empty_rows_get_fill():
    """Vertices with no active in-edges get the dense-path fill: the
    monoid identity for min/max, 0 for sum (segment-sum semantics)."""
    nbr = np.zeros((8, 4), np.int32)
    mask = np.zeros((8, 4), bool)
    w = np.ones((8, 4), np.float32)
    x = np.ones(16, np.float32)
    s, js = _both(nbr, mask, w, x, ops.msg_src_plus_w, _j_relax, "sum", 0.0)
    assert (s.numpy() == 0).all() and (js == 0).all()
    m, jm = _both(nbr, mask, w, x, ops.msg_src_plus_w, _j_relax, "min", INF)
    assert np.isinf(m.numpy()).all() and (m.numpy() > 0).all()
    assert m.numpy().tobytes() == jm.tobytes()


def test_superstep_zero_width_rows_get_fill():
    """A K = 0 layout (no slots at all) returns the fill on every row."""
    nbr = torch.zeros((5, 0), dtype=torch.int32)
    mask = torch.zeros((5, 0), dtype=torch.bool)
    w = torch.zeros((5, 0))
    x = torch.arange(5, dtype=torch.int32)
    got = superstep_plain(nbr, mask, w, x, message=ops.msg_src, op="min",
                          identity=IMAX)
    assert got.dtype == torch.int32 and (got == IMAX).all()
    s = superstep_plain(nbr, mask, w, x.float(), message=ops.msg_src_times_w,
                        op="sum", identity=0.0)
    assert (s == 0).all()


def test_superstep_sentinel_neighbors_masked_out():
    """Padding slots point at the sentinel row (index >= V); masked off,
    they must contribute nothing even though the gather clamps them."""
    vx = 12
    nbr = np.full((4, 8), vx, np.int32)
    nbr[0, 0] = 3
    mask = np.zeros((4, 8), bool)
    mask[0, 0] = True
    w = np.full((4, 8), 100.0, np.float32)
    x = np.arange(vx, dtype=np.float32)
    got, want = _both(nbr, mask, w, x, ops.msg_src_plus_w, _j_relax, "min",
                      INF)
    assert got[0] == 103.0
    assert np.isinf(got[1:].numpy()).all()
    assert got.numpy().tobytes() == want.tobytes()


def test_superstep_trailing_state_dims():
    """[V, C] state reduces per channel in the plain version (the
    fused-batch programs of the next slice ride this signature)."""
    rng = np.random.default_rng(11)
    v, k, vx, c = 32, 5, 40, 3
    nbr = rng.integers(0, vx, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.7
    w = rng.standard_normal((v, k)).astype(np.float32)
    x = rng.standard_normal((vx, c)).astype(np.float32)
    got, want = _both(nbr, mask, w, x, lambda s, w_: s + w_[..., None],
                      lambda s, w_: s + w_[..., None], "min", INF)
    assert got.shape == (v, c)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_superstep_message_dtype_rounds_before_combine(dtype, op):
    """A reduced channel rounds each message identically in both
    packages, so min/max stay bit-identical."""
    rng = np.random.default_rng(13)
    v, k, vx = 96, 7, 96
    nbr = rng.integers(0, vx, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.7
    w = rng.random((v, k)).astype(np.float32)
    x = rng.random(vx).astype(np.float32)
    ident = INF if op == "min" else -INF
    got, want = _both(nbr, mask, w, x, ops.msg_src_plus_w, _j_relax, op,
                      ident, message_dtype=dtype)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_as_np(got).astype(np.float32),
                                  want.astype(np.float32))


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    nbr, mask, w, x = _inputs(100, 9, 120, 3, "dist")
    args = [torch.from_numpy(a) for a in (nbr, mask, w, x)]
    before = ops.KERNEL_LAUNCHES
    got = ops.fused_superstep(*args, message=ops.msg_src_plus_one, op="min",
                              identity=INF)
    want = superstep_plain(*args, message=ops.msg_src_plus_one, op="min",
                           identity=INF)
    assert ops.KERNEL_LAUNCHES == before
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_compiled_programs_and_lane_groups():
    assert all(ops.compiled(f) for f in ops.EDGE_PROGRAMS)
    assert not ops.compiled(lambda s, w: s)
    assert sorted(ops.EDGE_PROGRAMS.values()) == [0, 1, 2, 3]
    # rows a block owns: one piece of 2048 slots, a multiple of 4 from 4
    # up, at least one
    assert [ops._rows_per_tile(k) for k in (0, 1, 16, 19, 128, 600, 1024,
                                            2049, 100000)] == \
        [2048, 2048, 128, 104, 16, 3, 2, 1, 1]
    assert all(ops._rows_per_tile(k) * k <= ops.PIECE_SLOTS
               and (ops._rows_per_tile(k) < 4
                    or ops._rows_per_tile(k) % 4 == 0)
               for k in range(1, 2049))
    x = torch.zeros(3, dtype=torch.int32)
    assert ops.kernel_out_dtype(x, ops.msg_src) == torch.int32
    assert ops.kernel_out_dtype(x, ops.msg_src_plus_one) == torch.float32
    assert ops.kernel_out_dtype(x, ops.msg_src, "bfloat16") == \
        torch.bfloat16


# ------------------------------------- the batched entry's launch geometry

def _batched_walk(v, k, b, geo):
    """How many times the batched kernel (``superstep.cu``'s
    ``superstep_batched_kernel``) reads each slot in each pass of columns
    and writes each (row, column), walking tiles of R rows, pieces of P
    slots and passes of C columns in groups of 4 (vector) or 1."""
    reads = np.zeros((-(-b // geo.cols), v * k), dtype=np.int64)
    writes = np.zeros((v, b), dtype=np.int64)
    vw = 4 if geo.vec else 1
    if k == 0:                          # every (row, column) the fill
        writes += 1
        return reads, writes
    for t in range(-(-v // geo.rows)):
        row0 = t * geo.rows
        rows = min(geo.rows, v - row0)
        n = rows * k
        assert rows == 1 or n <= geo.piece
        for c, c0 in enumerate(range(0, b, geo.cols)):
            cw = min(geo.cols, b - c0)
            assert cw % vw == 0
            for off in range(0, n, geo.piece):
                count = min(geo.piece, n - off)
                reads[c, row0 * k + off: row0 * k + off + count] += 1
                for r in range(rows):
                    rs, re = r * k - off, r * k - off + k
                    if max(rs, 0) < min(re, count) and re <= count:
                        writes[row0 + r, c0: c0 + cw] += 1
    return reads, writes


def test_batched_geometry_fits_shared_memory():
    """Every B from 1 to 1024 (and past it) and K from 0 to 3000: the
    block's dynamic shared memory within the H100's 232,448 bytes, and
    equal to the CUDA source's count (rows of at most ``SHORT_ROW``
    slots in 4-column groups: two tiles' ids and weights, three tiles'
    mask bytes; otherwise ids, weights, P x C values and C carried
    partials)."""
    every_k = {1, 3, 4, 8, 16, 33, 64, 1024}      # the rest: a few K each
    for b in list(range(1, 1025)) + [1025, 4096, 100000]:
        for aligned in (True, False):
            for k in (range(0, 3001) if b in every_k
                      else (0, 1, 2, 5, 19, 64, 65, 128, 2049, 3000)):
                g = ops._batched_geometry(b, k, aligned)
                short = k <= ops.SHORT_ROW and g.vec
                assert g.smem <= ops.MAX_SMEM_BYTES == 232448
                assert g.smem == (19 * g.piece if short else 4 * (
                    2 * g.piece + g.piece * g.cols + g.cols))
                assert g.piece % 4 == 0 and 4 <= g.piece <= (
                    ops.SHORT_PIECE if short else ops.PIECE_SLOTS)
                assert short or g.piece * g.cols <= ops.BATCHED_VALUES
                assert 1 <= g.cols <= min(b, ops.BATCHED_COLS)
                assert g.rows >= 1 and (g.rows < 4 or g.rows % 4 == 0)
                # a short-row tile is one piece; a longer row may be a
                # tile of its own, walked piece by piece
                assert g.rows * k <= g.piece or (g.rows == 1 and not short)


@pytest.mark.parametrize("b", [1, 3, 4, 8, 16, 33, 64, 1024, 1030, 2052])
def test_batched_geometry_covers_every_slot_and_column(b):
    """Pieces cover every slot of every row exactly once in each pass of
    columns; column groups cover every column; each (row, column) is
    written exactly once; V not a multiple of the rows a tile owns."""
    for k in (0, 1, 2, 3, 4, 5, 7, 19, 20, 37, 128, 129, 1000, 2047, 2048,
              2049, 3000):
        for aligned in (True, False):
            geo = ops._batched_geometry(b, k, aligned)
            v = 2 * geo.rows + 3 if geo.rows * k <= 4096 else 3
            if b > 64:
                v = 3
            reads, writes = _batched_walk(v, k, b, geo)
            assert (reads == 1).all(), (b, k, geo)
            assert (writes == 1).all(), (b, k, geo)


def test_batched_geometry_vector_path_only_where_it_may_run():
    """16-byte column loads and stores only for 4-column groups on
    16-byte aligned x and out; every other width and a misaligned view
    take 4-byte loads."""
    for b in range(1, 300):
        assert ops._batched_geometry(b, 19, True).vec == (b % 4 == 0)
        assert not ops._batched_geometry(b, 19, False).vec
    # the main path's fused batch: 128 rows of 19 slots, two 4-column
    # groups each, in the C entry point's argument order
    assert tuple(ops._batched_geometry(8, 19, True)) == \
        (128, 2432, 8, True, 46208)
    # rows past SHORT_ROW: 1024-slot pieces of 8 columns' values
    assert tuple(ops._batched_geometry(8, 65, True)) == \
        (12, 1024, 8, True, 40992)


def test_source_builds_in_parts_that_cover_both_entries():
    """The library compiles ``superstep.cu`` as four parts at once: the
    1-D entry in part 1, the batched entry in part 2 with its int32
    kernels, its float32 kernels in part 3, the CSR entry in part 4; a
    change of parts is a new library (the build's hash covers them)."""
    from repro_torch.kernels import _build
    src = (ops.CSRC / "superstep.cu").read_text()
    assert "#define SUPERSTEP_HAS(part) (SUPERSTEP_PART == 0 || " \
        "SUPERSTEP_PART == (part))" in src
    entry_1d = src.index('extern "C" int pregel_superstep(')
    entry_b = src.index('extern "C" int pregel_superstep_batched(')
    entry_csr = src.index('extern "C" int pregel_superstep_csr(')
    assert src.rindex("#if SUPERSTEP_HAS(1)", 0, entry_1d) > \
        src.rindex("#endif", 0, entry_1d)
    assert src.rindex("#if SUPERSTEP_HAS(4)", 0, entry_csr) > \
        src.rindex("#endif", 0, entry_csr)
    assert src.rindex("#if SUPERSTEP_HAS(2)", 0, entry_b) > \
        src.rindex("#endif", 0, entry_b)
    for part, state in ((2, "int"), (3, "float")):
        body = src.index(f"return batched_by_prog<{state}>(")
        assert src.rindex(f"#if SUPERSTEP_HAS({part})", 0, body) > \
            src.rindex("#endif", 0, body)
    sources = [ops.CSRC / "superstep.cu"]
    parts = [(f"-DSUPERSTEP_PART={p}",) for p in (1, 2, 3, 4)]
    assert _build._digest(sources, parts) == _build._digest(sources, parts)
    assert _build._digest(sources, parts) != _build._digest(sources)
    assert _build._digest(sources, parts[:2]) != \
        _build._digest(sources, parts)


def test_cuda_source_has_every_program_and_dtype():
    """The CUDA source declares the programs, ops and dtypes the wrapper
    indexes (both sides hard-code the numbering)."""
    src = (ops.CSRC / "superstep.cu").read_text()
    assert "enum Dtype { I32 = 0, F32 = 1, BF16 = 2, F16 = 3 };" in src
    assert "enum Op { SUM = 0, MIN = 1, MAX = 2 };" in src
    assert ("enum Prog { SRC = 0, SRC_PLUS_ONE = 1, SRC_PLUS_W = 2, "
            "SRC_TIMES_W = 3 };") in src
    assert 'extern "C" int pregel_superstep(' in src
    assert 'extern "C" int pregel_superstep_batched(' in src
    assert "src/repro/kernels/pregel_superstep/kernel.py:43" in src
    # the batched entry's shared memory count and limits, as
    # _batched_geometry's
    assert "return shrt ? 19LL * P" in src
    assert ": 4 * (2LL * P + static_cast<long long>(P) * C + C);" in src
    for name, value in (("kMaxSmem", ops.MAX_SMEM_BYTES),
                        ("kShortRow", ops.SHORT_ROW),
                        ("kMaxShortPiece", ops.SHORT_PIECE),
                        ("kMaxPieceBatched", ops.PIECE_SLOTS),
                        ("kThreads", ops.THREADS)):
        assert f"constexpr int {name} = {value};" in src, name
