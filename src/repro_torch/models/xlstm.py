"""xLSTM LM: alternating mLSTM / sLSTM blocks (arXiv:2405.04517), the
reference's ``models/xlstm.py``.

The layers are stacked as ``n_layers / 2`` pairs, an mLSTM block then an
sLSTM block; ``d_ff = 0``: the blocks are token mixers with up and down
projections and no separate FFN.

* mLSTM: matrix memory C [B, H, dh, dh] with stabilised exponential
  gating, h_t = (C_t q_t) / max(|n_t . q_t|, 1).
* sLSTM: a scalar memory per channel with diagonal recurrent gate
  weights and the same stabiliser.

Both run as the reference's time recurrence (its numerics oracle; the
chunkwise-parallel form is not in the reference), a Python loop over
time steps.  Under autograd the loop is checkpointed every 128 steps
(``_chunked_time_scan``), so the float32 matrix memory is not saved at
every step.  The recurrent state (float32, ``m`` starting at -1e30) is
the whole cache: O(1) in the sequence length.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseLM, dp_axes, remat_loop
from repro_torch.utils.sharding import P

STATE_KEYS = ("mC", "mn", "mm", "sc", "sn", "sm", "sh")


def _time_scan(step, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def _chunked_time_scan(step, carry, xs, tc: int = 128):
    """``step`` over the leading (time) axis of the tensors ``xs``:
    ``(final carry, stacked outputs)``.  Under autograd a sequence of
    more than ``tc`` steps that ``tc`` divides runs in checkpointed chunks
    of ``tc`` steps (backward recomputes a chunk instead of keeping the
    carry of every step), as the reference's scan does."""
    T = xs[0].shape[0]
    nc = T // tc if T % tc == 0 else 1
    if T <= tc or nc <= 1 or not torch.is_grad_enabled():
        return _time_scan(step, carry, xs)

    def chunk(carry, *part):
        return _time_scan(step, carry, part)
    ys = []
    for i in range(nc):
        carry, y = checkpoint(chunk, carry,
                              *(x[i * tc:(i + 1) * tc] for x in xs),
                              use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return carry, torch.cat(ys)


def _mlstm_step(carry, xs):
    C, n, m = carry
    qt, kt, vt, it, ft = xs                             # [B,H,*]
    m_new = torch.maximum(ft + m, it)
    decay = torch.exp(ft + m - m_new)[..., None]
    inp = torch.exp(it - m_new)[..., None]
    kf, vf = kt.float(), vt.float()
    C = decay[..., None] * C + inp[..., None] * (
        vf[..., :, None] * kf[..., None, :])            # [B,H,dh,dh]
    n = decay * n + inp * kf
    qf = qt.float()
    num = torch.einsum("bhij,bhj->bhi", C, qf)
    den = torch.clamp(torch.abs(torch.sum(n * qf, dim=-1)), min=1.0)
    return (C, n, m_new), num / den[..., None]          # [B,H,dh]


class XLSTMLM(DenseLM):
    family = "ssm"

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[dict] = None, use_kernels: bool = True):
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: xLSTM stacks pairs of blocks; "
                             f"n_layers {cfg.n_layers} is odd")
        super().__init__(cfg, device, generator, params, use_kernels)
        self.n_pairs = cfg.n_layers // 2
        self.di = cfg.ssm_expand * cfg.d_model
        self.dh = self.di // cfg.n_heads

    # ------------------------------------------------------------- params
    @staticmethod
    def _init_layers(cfg, device, generator) -> dict:
        d, h = cfg.d_model, cfg.n_heads
        di = cfg.ssm_expand * d
        pr = cfg.n_layers // 2

        def normal(shape, std):
            return L._normal((pr,) + shape, std, device, generator)
        down = di ** -0.5 / max(cfg.n_layers, 1) ** 0.5
        return {
            "m_ln": torch.zeros((pr, d), device=device),
            "m_up": normal((d, 2 * di), d ** -0.5),
            "m_q": normal((di, di), di ** -0.5),
            "m_k": normal((di, di), di ** -0.5),
            "m_v": normal((di, di), di ** -0.5),
            "m_gates": normal((di, 2 * h), di ** -0.5),
            "m_down": normal((di, d), down),
            "s_ln": torch.zeros((pr, d), device=device),
            "s_gates": normal((d, 4 * di), d ** -0.5),
            "s_rec": normal((4, di), 0.1),
            "s_down": normal((di, d), down),
        }

    # ------------------------------------------------------- mLSTM block
    def _mlstm(self, p, x, state):
        """x [B, S, D]; state (C [B, H, dh, dh], n [B, H, dh], m [B, H]) ->
        (out [B, S, D], new state)."""
        b, s, _ = x.shape
        h_, dh, dt = self.cfg.n_heads, self.dh, x.dtype
        hn = L.rms_norm(x, p["m_ln"])
        xm, z = (hn @ p["m_up"].to(dt)).chunk(2, dim=-1)        # [B,S,di]
        q = (xm @ p["m_q"].to(dt)).reshape(b, s, h_, dh)
        k = (xm @ p["m_k"].to(dt)).reshape(b, s, h_, dh) * torch.tensor(
            dh ** -0.5, dtype=dt)
        v = (xm @ p["m_v"].to(dt)).reshape(b, s, h_, dh)
        gates = (xm @ p["m_gates"].to(dt)).float().reshape(b, s, h_, 2)
        i_raw, f_log = gates[..., 0], F.logsigmoid(gates[..., 1])  # [B,S,H]
        xs = tuple(t.transpose(0, 1) for t in (q, k, v, i_raw, f_log))
        state, hs = _chunked_time_scan(_mlstm_step, state, xs)
        hs = hs.transpose(0, 1).reshape(b, s, self.di).to(dt)
        return (hs * F.silu(z)) @ p["m_down"].to(dt), state

    # ------------------------------------------------------- sLSTM block
    def _slstm(self, p, x, state):
        """state (c, n, m, h_prev), each [B, di]."""
        b, s, _ = x.shape
        dt = x.dtype
        hn = L.rms_norm(x, p["s_ln"])
        gates = (hn @ p["s_gates"].to(dt)).float().reshape(b, s, 4, self.di)
        rec = p["s_rec"].float()                                # [4, di]

        def step(carry, xs):
            c, n, m, h_prev = carry
            z_t, i_t, f_t, o_t = xs                             # [B,di]
            z_t = torch.tanh(z_t + rec[0] * h_prev)
            i_t = i_t + rec[1] * h_prev
            f_t = F.logsigmoid(f_t + rec[2] * h_prev)
            o_t = torch.sigmoid(o_t + rec[3] * h_prev)
            m_new = torch.maximum(f_t + m, i_t)
            c = torch.exp(f_t + m - m_new) * c + torch.exp(i_t - m_new) * z_t
            n = torch.exp(f_t + m - m_new) * n + torch.exp(i_t - m_new)
            h_t = o_t * c / torch.clamp(n, min=1.0)
            return (c, n, m_new, h_t), h_t

        xs = tuple(gates[:, :, j].transpose(0, 1) for j in range(4))
        state, hs = _chunked_time_scan(step, state, xs)
        hs = hs.transpose(0, 1).to(dt)                          # [B,S,di]
        return hs @ p["s_down"].to(dt), state

    # ------------------------------------------------------------ states
    def _zero_pair_state(self, b: int) -> dict:
        h_, dh, di, pr = self.cfg.n_heads, self.dh, self.di, self.n_pairs

        def full(shape, value):
            return torch.full((pr, b) + shape, value, dtype=torch.float32,
                              device=self.device)
        return {"mC": full((h_, dh, dh), 0.0), "mn": full((h_, dh), 0.0),
                "mm": full((h_,), -1e30), "sc": full((di,), 0.0),
                "sn": full((di,), 0.0), "sm": full((di,), -1e30),
                "sh": full((di,), 0.0)}

    # ----------------------------------------------------------- forward
    def _pair(self, p_l, x, *st):
        m_out, m_state = self._mlstm(p_l, x, st[:3])
        x = x + m_out
        s_out, s_state = self._slstm(p_l, x, st[3:])
        return x + s_out, (*m_state, *s_state)

    def _hidden(self, params, batch):
        """The pairs from a zero state; under autograd and ``cfg.remat``
        each pair is checkpointed."""
        x = L.embed_tokens(params, batch["tokens"].to(self.device), self.cfg,
                           self.dtype)
        state = self._zero_pair_state(x.shape[0])

        def pair(p_l, st, x):
            return self._pair(self._slice(p_l), x, *st)[0]
        return remat_loop(
            [(pair, (p_l, tuple(state[k][i] for k in STATE_KEYS)))
             for i, p_l in enumerate(self._slices(params))], x,
            self.cfg.remat and torch.is_grad_enabled())

    def _run_cached(self, params, x, cache):
        """The pairs over ``x`` from the states in ``cache``, which each
        pair overwrites with its new state."""
        for i, p_l in enumerate(self._slices(params)):
            layer = self._cache_layer(cache, i)
            x, st = self._pair(self._slice(p_l), x,
                               *(layer[k] for k in STATE_KEYS))
            for k, t in zip(STATE_KEYS, st):
                layer[k].copy_(t)
            self._cache_store(cache, i, layer)
        return x

    # ------------------------------------------------------------ serving
    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """The recurrent states only: O(1) in ``cache_len``."""
        return self._zero_pair_state(batch_size)

    @torch.no_grad()
    def prefill(self, batch, cache_len: Optional[int] = None):
        p = self._top(self.params)
        x = L.embed_tokens(p, self._rows(batch)["tokens"].to(self.device),
                           self.cfg, self.dtype)
        cache = self._mesh_cache(self._zero_pair_state(x.shape[0]))
        x = self._run_cached(p, x, cache)
        return self._all_rows(L.unembed(p, x[:, -1:, :], self.cfg)), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache, index: int):
        """One token on the recurrent state (``index`` is not needed);
        ``cache`` is updated in place and returned."""
        p = self._top(self.params)
        x = L.embed_tokens(p, self._rows(tokens).to(self.device),
                           self.cfg, self.dtype)
        x = self._run_cached(p, x, cache)
        return self._all_rows(L.unembed(p, x, self.cfg)), cache

    # ------------------------------------------------------- shardings
    def _layer_spec(self, fs) -> dict:
        return {
            "m_ln": P(None, None),
            "m_up": P(None, fs, "model"),
            "m_q": P(None, fs, "model"),
            "m_k": P(None, fs, "model"),
            "m_v": P(None, fs, "model"),
            "m_gates": P(None, "model", None),
            "m_down": P(None, "model", fs),
            "s_ln": P(None, None),
            "s_gates": P(None, fs, "model"),
            "s_rec": P(None, None, "model"),
            "s_down": P(None, "model", fs),
        }

    def cache_spec(self, multi_pod: bool = True) -> dict:
        dp = dp_axes(multi_pod)
        # the (large) per-head state dimension is split, not the head count
        return {
            "mC": P(None, dp, None, "model", None),
            "mn": P(None, dp, None, "model"),
            "mm": P(None, dp, None),
            "sc": P(None, dp, "model"),
            "sn": P(None, dp, "model"),
            "sm": P(None, dp, "model"),
            "sh": P(None, dp, "model"),
        }
