"""Selective SSM (Mamba/S6) mixer, the SSM half of Hymba's hybrid heads:
the reference's ``models/mamba.py``.

The prefill runs the linear recurrence ``h_t = a_t * h_{t-1} + b_t`` in
chunks of ``chunk`` time steps (one chunk of the whole sequence when S
does not divide), carrying ``h`` [B, di, N] from chunk to chunk as the
reference does.  PyTorch has no associative scan, so inside a chunk the
recurrence runs as a Hillis-Steele doubling: ``log2(ck)`` whole-tensor
steps of ``(a, b) o (a', b') = (a a', b' + a' b)`` on ``[B, ck, di, N]``
float32.  The products come in another order than XLA's scan tree: the
result agrees with the reference's within float32 rounding, not bit for
bit.  Under autograd each chunk is checkpointed, as the reference's
``chunk_step`` is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L


def mamba_init(cfg, layers: int, device, generator) -> dict:
    """The reference's shapes and scales (``mamba_init``)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    r = max(1, d // 16)              # dt low-rank
    kw = cfg.ssm_conv

    def normal(shape, std):
        return L._normal((layers,) + shape, std, device, generator)
    a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    return {
        "w_in": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((kw, di), 0.2),
        "w_b": normal((di, n), di ** -0.5),
        "w_c": normal((di, n), di ** -0.5),
        "w_dt1": normal((di, r), di ** -0.5),
        "w_dt2": normal((r, di), r ** -0.5),
        "dt_bias": torch.zeros((layers, di), device=device),
        "a_log": a.expand(layers, di, n).contiguous(),
        "d_skip": torch.ones((layers, di), device=device),
        "w_out": normal((di, d), di ** -0.5 / max(cfg.n_layers, 1) ** 0.5),
    }


def _causal_conv(x, conv_w, conv_state=None):
    """x [B, S, di]; conv_w [K, di] depthwise; conv_state [B, K-1, di]
    (the previous inputs, for decode continuity) -> (y, new_state)."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # [B, S+K-1, di]
    y = sum(xp[:, i:i + x.shape[1], :] * conv_w[i][None, None, :]
            for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return y, new_state


def _ssm_inputs(p, xc):
    """Per-step SSM coefficients from the (conv'd) input, in float32."""
    xf = xc.float()
    bt = xf @ p["w_b"].float()                        # [B,S,N]
    ct = xf @ p["w_c"].float()                        # [B,S,N]
    dt = F.softplus((xf @ p["w_dt1"].float()) @ p["w_dt2"].float()
                    + p["dt_bias"].float())           # [B,S,di]
    a = -torch.exp(p["a_log"].float())                # [di,N]
    return bt, ct, dt, a


def _doubling_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` from ``h = 0`` along
    axis 1: ``(prod a[..t], h_t)`` for every t, by recursive doubling."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _chunk_step(h, a, xck, bck, cck, dck):
    """One chunk: the state ``h`` [B, di, N] carried in, inputs [B, ck,
    *] -> (the state after the chunk, y [B, ck, di])."""
    a_bar = torch.exp(dck[..., None] * a)             # [B,ck,di,N]
    b_bar = (dck * xck)[..., None] * bck[:, :, None, :]
    a_all, b_all = _doubling_scan(a_bar, b_bar)
    hs = a_all * h[:, None] + b_all                   # [B,ck,di,N]
    y = torch.einsum("bsdn,bsn->bsd", hs, cck)
    return hs[:, -1], y


def mamba_mixer(p, x, cfg, chunk: int = 256):
    """Training / prefill path.  x [B, S, D] -> (y [B, S, D], final state
    [B, di, N] float32, conv state [B, K-1, di])."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    dt_ = x.dtype
    x_in, z = (x @ p["w_in"].to(dt_)).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(x_in, p["conv_w"].to(dt_))
    xc = F.silu(xc)
    bt, ct, dt, a = _ssm_inputs(p, xc)
    xf = xc.float()

    ck = min(chunk, s)
    nck = s // ck if s % ck == 0 else 1
    ck = s // nck
    grad = torch.is_grad_enabled()
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nck):
        part = [t[:, i * ck:(i + 1) * ck] for t in (xf, bt, ct, dt)]
        h, y = (checkpoint(_chunk_step, h, a, *part, use_reentrant=False,
                           preserve_rng_state=False)
                if grad else _chunk_step(h, a, *part))
        ys.append(y)
    y = torch.cat(ys, dim=1)                          # [B,S,di] f32
    y = y + xf * p["d_skip"].float()
    y = y.to(dt_) * F.silu(z)
    return y @ p["w_out"].to(dt_), h, conv_state


def mamba_decode(p, x, cfg, ssm_state, conv_state):
    """Single-token path.  x [B, 1, D]; ssm_state [B, di, N]; conv_state
    [B, K-1, di] -> (y [B, 1, D], new ssm state, new conv state)."""
    dt_ = x.dtype
    x_in, z = (x @ p["w_in"].to(dt_)).chunk(2, dim=-1)
    xc, new_conv = _causal_conv(x_in, p["conv_w"].to(dt_), conv_state)
    xc = F.silu(xc)
    bt, ct, dt, a = _ssm_inputs(p, xc)
    xf = xc.float()[:, 0]
    a_bar = torch.exp(dt[:, 0, :, None] * a)          # [B,di,N]
    b_bar = (dt[:, 0] * xf)[..., None] * bt[:, 0, None, :]
    h = a_bar * ssm_state + b_bar
    y = torch.einsum("bdn,bn->bd", h, ct[:, 0])
    y = y + xf * p["d_skip"].float()
    y = y[:, None].to(dt_) * F.silu(z)
    return y @ p["w_out"].to(dt_), h, new_conv
