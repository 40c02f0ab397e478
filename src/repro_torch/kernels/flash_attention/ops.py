"""Wrapper of the flash attention kernel (``csrc/flash.cu``).

``flash_attention(q, k, v, causal, window, softcap)`` takes q
``[B, Hq, S, D]`` and k/v ``[B, Hkv, S, D]`` and returns ``[B, Hq, S, D]``
in q's dtype.  For tensors on the CPU it runs the plain version
(``ref.mha_plain``).  For CUDA tensors it launches the CUDA kernel or
raises ``ValueError`` for an input the kernel does not take (another
dtype than float32/bfloat16, a head dim other than 16/32/64/128/256,
a last dimension that is not contiguous, misaligned rows, a bfloat16
broadcast view, mismatched shapes or devices): nothing falls back.
Callers that want the plain version on the card (parity runs) pass
``use_kernels=False``.

The kernel reads q, k and v at their own strides, so the transposed
views of the model's ``[B, S, H, D]`` activations go in without a copy;
the kv head of query head ``h`` is ``h // (Hq // Hkv)``, read in place
(the reference repeats k and v per group first).  bfloat16 runs the
Hopper kernel (TMA tensor maps over those strided views, wgmma, a
producer warpgroup beside two consumer warpgroups); float32 runs the FMA
kernel, exact to summation order.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import mha_plain

#: Launches of the CUDA kernel, counted where the wrapper launches it
#: (under a lock, as the other kernels' counts are).
KERNEL_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def library():
    """The built kernel library (compiled on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention", sorted(CSRC.glob("*.cu")))
        fn = lib.flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        _LIB = lib
    return _LIB


def _check(q, k, v):
    """Raise ``ValueError`` for an input the kernel does not take (the
    device last, so the layout rules can be checked on any tensor)."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not "
                         "float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, H, S, D]"
                             f", got {tuple(t.shape)}")
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {dev}")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    # grid: bfloat16 (heads, batch, 128-row query tiles), float32
    # (64-row query tiles, heads, batch)
    max_s = 65535 * 128 if q.dtype == torch.bfloat16 else 2 ** 31 - 1
    if b > 65535 or hq > 65535 or s > max_s:
        raise ValueError(f"flash_attention: B={b}, Hq={hq}, S={s} exceed "
                         "the grid")
    # 16-byte row reads: the last dim contiguous, every row 16-byte aligned
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension "
                             "must be contiguous")
        if t.data_ptr() % 16 or any(t.stride(i) % vec for i in range(3)):
            raise ValueError(f"flash_attention: {name}'s rows are not "
                             "16-byte aligned")
        # the bf16 kernel's TMA copies step through memory by each stride
        if q.dtype == torch.bfloat16 and any(
                t.stride(i) == 0 and t.shape[i] > 1 for i in range(3)):
            raise ValueError(f"flash_attention: {name} has a zero stride "
                             "(a broadcast view); bfloat16 tiles are copied "
                             "by TMA, which needs distinct rows")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")


def _launch(q, k, v, causal: bool, window: int, softcap: float):
    global KERNEL_LAUNCHES
    _check(q, k, v)
    b, hq, s, d = q.shape
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = library()
    # a window of S or more masks nothing: min(window, S) keeps the C int
    # in range
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, k.shape[1], s, d, strides,
            int(bool(causal)), min(window, s), softcap,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES += 1
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, use_kernels: bool = True):
    """q: [B, Hq, S, D], k/v: [B, Hkv, S, D] -> [B, Hq, S, D] in q's dtype.

    ``window > 0`` keeps keys ``j > i - window`` (sliding window);
    ``softcap > 0`` applies ``softcap * tanh(logits / softcap)`` to the
    scaled logits.  Any S (the reference needs S to be a multiple of its
    block).  CPU tensors, or ``use_kernels=False``: the plain version.
    """
    window, softcap = int(window), float(softcap)
    if window < 0 or not softcap >= 0.0:
        raise ValueError(f"flash_attention: window={window}, "
                         f"softcap={softcap} must be >= 0")
    if not use_kernels or q.device.type == "cpu":
        return mha_plain(q, k, v, causal, window, softcap)
    return _launch(q, k, v, causal, window, softcap)
