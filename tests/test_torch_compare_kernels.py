"""``compare_kernels.py`` on the CPU: the bound it prints beside each
timing (``chip_smoke._bound`` through ``superstep_bound``, for both
superstep entries) and how it reads each source's launch rule.  The
kernels themselves run only on the card (``python3 compare_kernels.py``
there); these tests keep the script's own code in step with the helpers
it calls from ``chip_smoke.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import compare_kernels as ck  # noqa: E402
from repro_torch.core.pregel import Lifted  # noqa: E402
from repro_torch.kernels.pregel_superstep import ops  # noqa: E402
from repro_torch.kernels.pregel_superstep.ref import superstep_plain  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/pregel_superstep/csrc/superstep.cu"


def _layout(v, k, vx, seed):
    rng = np.random.default_rng(seed)
    nbr = torch.from_numpy(rng.integers(0, vx, (v, k)).astype(np.int32))
    mask = torch.from_numpy(rng.random((v, k)) < 0.4)
    w = torch.from_numpy(rng.uniform(1.0, 4.0, (v, k)).astype(np.float32))
    return nbr, mask, w


@pytest.mark.parametrize("b", [None, 1, 8])
@pytest.mark.parametrize("program,op,ident,x_int", [
    (ops.msg_src, "min", int(np.iinfo(np.int32).max), True),
    (ops.msg_src_plus_one, "min", float("inf"), False),
    (ops.msg_src_plus_w, "min", float("inf"), False),
    (ops.msg_src_times_w, "sum", 0.0, False),
])
def test_superstep_bound_counts_what_the_call_needs(b, program, op, ident,
                                                    x_int):
    """The mask in full, nbr (and w where the program reads it) at the
    live slots, x and the output once, over 3.35 TB/s; the 1-D entry
    (``b`` None) and the batched one, whose message is a batched lift."""
    v, k, vx = 300, 19, 280
    nbr, mask, w = _layout(v, k, vx, seed=k + (b or 0))
    rng = np.random.default_rng(7)
    shape = (vx,) if b is None else (vx, b)
    x = torch.from_numpy(rng.integers(0, vx, shape).astype(np.int32)
                         if x_int else
                         rng.uniform(0, 9, shape).astype(np.float32))
    message = program if b is None else Lifted(program, (-1, None))
    want = superstep_plain(nbr, mask, w, x, message=message, op=op,
                           identity=ident)
    ms, by = ck.superstep_bound(mask, x, want, message)
    live = int(mask.sum())
    reads_w = program in (ops.msg_src_plus_w, ops.msg_src_times_w)
    nbytes = (v * k + live * (8 if reads_w else 4) + 4 * x.numel()
              + 4 * want.numel())
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3,
                               rel=1e-12)
    assert want.shape == ((v,) if b is None else (v, b))


def test_superstep_bound_of_the_main_batched_shape():
    """The batched entry's bound at a small [V, 8] shape: B columns of x
    and out cost B times the bytes of one, the mask and ids do not."""
    nbr, mask, w = _layout(64, 19, 64, seed=3)
    msg = Lifted(ops.msg_src_plus_one, (-1, None))
    one = torch.zeros(64, 1)
    eight = torch.zeros(64, 8)
    b1, _ = ck.superstep_bound(mask, one, superstep_plain(
        nbr, mask, w, one, message=msg, op="min", identity=float("inf")),
        msg)
    b8, _ = ck.superstep_bound(mask, eight, superstep_plain(
        nbr, mask, w, eight, message=msg, op="min", identity=float("inf")),
        msg)
    per_column = 2 * 64 * 4 / cs.HBM_BYTES_PER_S * 1e3
    assert b8 - b1 == pytest.approx(7 * per_column, rel=1e-9)


def test_variants_read_their_launch_rule(tmp_path):
    """``:lanes`` for the 1-D entries (log2 lanes a row); a batched source
    is called with the launch geometry where its signature takes it and
    without where it does not; nothing else."""
    assert ck.Variant(str(SOURCE), "pregel_superstep_batched").geometry
    older = tmp_path / "older.cu"
    older.write_text(
        'extern "C" int pregel_superstep_batched(\n'
        '    const void* nbr, const void* mask, const void* w, const void* x,\n'
        '    void* out, long long V, long long K, long long Vx, long long B,\n'
        '    int state_type, int program, int op, int out_type, double fill,\n'
        '    void* stream) {\n  int rows_per_tile = 0;\n}\n')
    assert not ck.Variant(str(older), "pregel_superstep_batched").geometry
    assert not ck.Variant(str(SOURCE), "pregel_superstep").geometry
    assert ck.Variant(f"{SOURCE}:lanes", "pregel_superstep").lanes
    for spec, entry in ((f"{SOURCE}:warp", "pregel_superstep"),
                        (f"{SOURCE}:warp", "pregel_superstep_batched"),
                        (f"{SOURCE}:lanes", "pregel_superstep_batched"),
                        (f"{SOURCE}:rows", "ell_intersect")):
        with pytest.raises(SystemExit, match="launch rule"):
            ck.Variant(spec, entry)
    with pytest.raises(SystemExit, match="no such source"):
        ck.Variant(str(ROOT / "build" / "missing.cu"), "pregel_superstep")
