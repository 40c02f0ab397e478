"""Transformer building blocks of the port's LM (functions over
parameter dicts), mirroring the reference's ``models/layers.py``.

Conventions
-----------
* Parameters are nested dicts of tensors (float32 masters for serving;
  a train state's bf16 or float32 params for training); per-layer
  parameters are stacked on a leading ``L`` axis, and the model slices
  layer ``i`` out of each (a Python loop over layers, no scan).  Every
  matrix is ``x @ w``-shaped (``wq`` is ``[d_model, q_dim]``) and is cast
  to the activation dtype at each use, as in the reference.
* Activations flow as ``[B, S, D]`` in ``cfg.dtype``; attention logits
  and softmax are always float32.
* Three attention implementations (``attention_output``'s ``impl``):
    - 'ref'     : materializes [B, H, S, S] logits (oracle)
    - 'chunked' : online softmax over (q-chunk, kv-chunk) tiles in plain
                  torch (the reference config's default)
    - 'flash'   : the hand-written CUDA kernel (``kernels.flash_attention``)
                  on the card, its plain version on the CPU
  and a fourth on a device mesh, ``attn_ring`` (``attn_impl="ring"`` with
  the model's ``ring_mesh``): the sequence split over a mesh axis, the
  k/v blocks passed round the ring (plain torch, as the reference's jnp).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.utils import sharding as SH

NEG_INF = -2.3819763e38  # large negative for masking in f32


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, Dh]; positions [..., S] (broadcastable).  Half-split
    rotation with float32 angles; the result is cast back to x's dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq   # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


# ---------------------------------------------------------------------------
# Attention implementations
# ---------------------------------------------------------------------------

def _mask(qpos, kpos, causal: bool, window: int, prefix: int = 0):
    """qpos [*, Sq], kpos [*, Sk] -> bool [*, Sq, Sk].  ``window`` is a
    Python int (0 = unlimited); ``prefix > 0`` opens a bidirectional zone
    over the first ``prefix`` positions (prefix-LM)."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                   dtype=torch.bool, device=qpos.device)
    if causal:
        c = k <= q
        if prefix:
            c = c | ((q < prefix) & (k < prefix))
        m = m & c
    if window > 0:
        m = m & (k > q - window)
    return m


def _expand_mask(m, ndim: int):
    """[Sq, Sk] or [B, Sq, Sk] -> broadcastable against [B, H, G, Sq, Sk]."""
    while m.dim() < ndim:
        m = m.unsqueeze(-3) if m.dim() >= 3 else m.unsqueeze(0)
    return m


def attn_ref(q, k, v, qpos, kpos, causal=True, window=0, softcap=0.0,
             prefix: int = 0):
    """q [B,Sq,Hq,Dh]; k/v [B,Sk,Hkv,Dh] -> [B,Sq,Hq,Dh].  Oracle."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = (q.float() * (dh ** -0.5)).reshape(b, sq, hkv, g, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    logits = _softcap(logits, softcap)
    m = _expand_mask(_mask(qpos, kpos, causal, window, prefix), logits.dim())
    logits = torch.where(m, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _pick_chunk(s: int, c: int) -> int:
    """Largest divisor of s that is <= c."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def attn_chunked(q, k, v, qpos, kpos, causal=True, window=0, softcap=0.0,
                 chunk_q: int = 1024, chunk_k: int = 1024, prefix: int = 0):
    """Flash-style online softmax in plain torch: a loop over q chunks, and
    inside it over kv chunks.  Peak live logits: [B, Hkv, G, cq, ck].

    As in the reference, q is scaled and k/v stay in the compute dtype
    (the products accumulate in float32), and the probabilities are
    rounded to v's dtype before the product with v."""
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    g = hq // hkv
    cq = _pick_chunk(sq, chunk_q)
    ck = _pick_chunk(sk, chunk_k)
    qs = (q * torch.tensor(dh ** -0.5, dtype=q.dtype)).reshape(
        b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4)          # [B,Hkv,G,Sq,dh]
    ks = k.permute(0, 2, 1, 3)                               # [B,Hkv,Sk,dh]
    vs = v.permute(0, 2, 1, 3)
    outs = []
    for q0 in range(0, sq, cq):
        qc = qs[:, :, :, q0:q0 + cq].float()
        qpb = qpos[..., q0:q0 + cq]
        m_p = torch.full((b, hkv, g, cq, 1), NEG_INF, device=q.device)
        l_p = torch.zeros((b, hkv, g, cq, 1), device=q.device)
        acc = torch.zeros((b, hkv, g, cq, dh), device=q.device)
        for k0 in range(0, sk, ck):
            kc = ks[:, :, None, k0:k0 + ck].float()
            vc = vs[:, :, None, k0:k0 + ck]
            logits = _softcap(qc @ kc.transpose(-1, -2), softcap)
            msk = _expand_mask(_mask(qpb, kpos[..., k0:k0 + ck], causal,
                                     window, prefix), logits.dim())
            logits = torch.where(msk, logits, NEG_INF)
            m_n = torch.maximum(m_p, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_n)
            alpha = torch.exp(m_p - m_n)
            l_p = alpha * l_p + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(vc.dtype).float() @ vc.float()
            m_p = m_n
        outs.append(acc / torch.where(l_p > 0, l_p, 1.0))
    out = torch.cat(outs, dim=3)                             # [B,Hkv,G,Sq,dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


def attn_decode(q, k_cache, v_cache, q_index, causal=True, window=0,
                softcap=0.0):
    """Single-token decode: q [B,1,Hq,Dh], caches [B,C,Hkv,Dh].
    q_index: current position (an int, or a [B] tensor)."""
    b, _, hq, dh = q.shape
    c = k_cache.shape[1]
    hkv = k_cache.shape[2]
    g = hq // hkv
    qf = (q.float() * (dh ** -0.5)).reshape(b, hkv, g, dh)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    logits = _softcap(logits, softcap)
    kpos = torch.arange(c, device=q.device)
    # an int stays on the host (no copy to the card, no sync per layer)
    qi = q_index.reshape(-1, 1) if torch.is_tensor(q_index) else q_index
    valid = (kpos[None, :] <= qi if causal
             else torch.ones((1, c), dtype=torch.bool, device=q.device))
    if window > 0:
        valid = valid & (kpos[None, :] > qi - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def attention_output(q, k, v, qpos, kpos, impl: str, causal=True, window=0,
                     softcap=0.0, chunk: int = 1024, prefix: int = 0,
                     use_kernels: bool = True):
    """q [B,S,Hq,Dh]; k/v [B,S,Hkv,Dh] -> [B,S,Hq,Dh] by ``impl``.

    ``flash`` assumes positions ``0..S-1`` (the prefill's) and has no
    prefix-LM zone: ``prefix > 0`` raises (the reference drops it
    silently).  It is forward only: under autograd with an input that
    requires grad it raises, since the kernel's output carries no
    gradient (the reference cannot differentiate it either).
    ``use_kernels=False`` runs the flash kernel's plain version on any
    device."""
    if impl == "ref":
        return attn_ref(q, k, v, qpos, kpos, causal, window, softcap, prefix)
    if impl == "chunked":
        return attn_chunked(q, k, v, qpos, kpos, causal, window, softcap,
                            chunk_q=chunk, chunk_k=chunk, prefix=prefix)
    if impl == "flash":
        if prefix:
            raise ValueError("attention_output: the flash kernel has no "
                             f"prefix-LM zone (prefix={prefix})")
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError(
                "attention_output: the flash kernel is forward only (no "
                "gradient reaches q, k or v); train with "
                "attn_impl='chunked'")
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            window=int(window), softcap=float(softcap),
                            use_kernels=use_kernels)
        return o.transpose(1, 2)
    if impl == "ring":
        raise ValueError("attention_output: ring attention runs on a mesh "
                         "through attn_ring (the model's ring_mesh hook)")
    raise ValueError(impl)


def _online_block(q, k, v, qpos, kpos, state, causal, window, softcap,
                  prefix=0, chunk_k: int = 512):
    """Online-softmax update of ``state`` = (m, l, acc) (float32) against
    one kv block, ``chunk_k`` keys at a time (the reference's
    ``_online_block``).  q [B,Hkv,G,Sq,Dh] (scaled, compute dtype); k/v
    [B,Sk,Hkv,Dh]; m, l [B,Hkv,G,Sq,1], acc [B,Hkv,G,Sq,Dh]."""
    sk = k.shape[1]
    ck = _pick_chunk(sk, chunk_k)
    m_p, l_p, acc = state
    qf = q.float()
    for k0 in range(0, sk, ck):
        kb = k[:, k0:k0 + ck].permute(0, 2, 1, 3)[:, :, None]  # [B,Hkv,1,ck,Dh]
        vb = v[:, k0:k0 + ck].permute(0, 2, 1, 3)[:, :, None]
        logits = _softcap(qf @ kb.float().transpose(-1, -2), softcap)
        msk = _expand_mask(_mask(qpos, kpos[k0:k0 + ck], causal, window,
                                 prefix), logits.dim())
        logits = torch.where(msk, logits, NEG_INF)
        m_n = torch.maximum(m_p, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_n)
        alpha = torch.exp(m_p - m_n)
        l_p = alpha * l_p + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(vb.dtype).float() @ vb.float()
        m_p = m_n
    return m_p, l_p, acc


def _ring_shift(tensors, group, axis_size: int, index: int):
    """Each tensor of this rank to the next rank of the ring
    (``index + 1``), the previous rank's in return: one
    ``batch_isend_irecv`` with every send and receive posted together (a
    send posted alone waits for its receiver, and every rank would wait)."""
    import torch.distributed as dist
    nxt = dist.get_global_rank(group, (index + 1) % axis_size)
    prv = dist.get_global_rank(group, (index - 1) % axis_size)
    sends = [SH.wire(t.contiguous(), group) for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends] + \
        [dist.P2POp(dist.irecv, t, prv, group) for t in recvs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def attn_ring(q, k, v, *, mesh, axis: str = "model", batch_axes=("data",),
              causal=True, window=0, softcap=0.0, chunk_k: int = 512):
    """Ring attention (context parallelism), the reference's ``attn_ring``:
    the sequence of q/k/v is split over the mesh axis ``axis``; each rank
    keeps its chunk of the q rows, the k/v blocks travel the ring ``i ->
    i + 1`` (``batch_isend_irecv`` on the axis's group), and each rank
    runs an online softmax of its queries against every block in turn.
    At stage j a rank holds the block of shard ``(m - j) mod M``, whose
    key positions start at that shard's offset, as its queries' start at
    ``m * S / M``; the window applies across shards.

    q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]: this rank's rows (the batch is
    split over ``batch_axes`` before the model runs, as the reference's
    ``shard_map`` splits it) and the whole sequence.  Returns ``[B, S,
    Hq, Dh]`` in q's dtype, gathered back along ``axis`` (what the
    reference's ``out_specs`` reassembles), fully masked rows zero.
    Forward only: under autograd with an input that requires grad it
    raises (its backward, dK and dV travelling the ring in reverse, is
    ROADMAP.md §1 item 1)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("attn_ring is forward only (its backward is "
                           "ROADMAP.md §1 item 1); train with "
                           "attn_impl='chunked'")
    if axis in tuple(batch_axes or ()):
        raise ValueError(f"attn_ring: the ring axis {axis!r} also splits "
                         f"the batch ({tuple(batch_axes)})")
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    M = SH.mesh_sizes(mesh)[axis]
    m = SH.mesh_coords(mesh)[axis]
    if s % M:
        raise ValueError(f"attn_ring: a sequence of {s} does not split over "
                         f"{M} ranks of {axis!r}")
    s_loc = s // M
    mine = slice(m * s_loc, (m + 1) * s_loc)
    # without a causal or window mask the positions go unused, and the
    # reference gives every query position 0
    needs_pos = causal or window != 0
    ar = torch.arange(s_loc, dtype=torch.int32, device=q.device)
    qpos = m * s_loc + ar if needs_pos else torch.zeros_like(ar)
    qf = (q[:, mine] * torch.tensor(dh ** -0.5, dtype=q.dtype)).reshape(
        b, s_loc, hkv, g, dh).permute(0, 2, 3, 1, 4)
    state = (torch.full((b, hkv, g, s_loc, 1), NEG_INF, device=q.device),
             torch.zeros((b, hkv, g, s_loc, 1), device=q.device),
             torch.zeros((b, hkv, g, s_loc, dh), device=q.device))
    kv = [k[:, mine].contiguous(), v[:, mine].contiguous()]
    group = mesh.get_group(axis) if M > 1 else None
    for j in range(M):
        src = (m - j) % M if needs_pos else (-j) % M
        kpos = src * s_loc + ar
        state = _online_block(qf, kv[0], kv[1], qpos, kpos, state, causal,
                              window, softcap, chunk_k=chunk_k)
        if j < M - 1:
            kv = _ring_shift(kv, group, M, m)
    _, l_f, acc = state
    out = (acc / torch.where(l_f > 0, l_f, 1.0)).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, s_loc, hq, dh).to(q.dtype)
    return SH.gather(out, SH.P(None, axis, None, None), mesh)


# ---------------------------------------------------------------------------
# Parameterized sublayers
# ---------------------------------------------------------------------------

def _normal(shape, std, device, generator):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=generator)


def init_attn(cfg, layers: int, device, generator):
    """The reference's shapes and scales (``init_attn``)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    scale = d ** -0.5
    return {
        "wq": _normal((layers, d, qd), scale, device, generator),
        "wk": _normal((layers, d, kvd), scale, device, generator),
        "wv": _normal((layers, d, kvd), scale, device, generator),
        "wo": _normal((layers, qd, d),
                      (qd ** -0.5) / max(cfg.n_layers, 1) ** 0.5, device,
                      generator),
    }


def init_mlp(cfg, layers: int, device, generator):
    """The reference's shapes and scales (``init_mlp``)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": _normal((layers, d, f), d ** -0.5, device, generator),
        "w_up": _normal((layers, d, f), d ** -0.5, device, generator),
        "w_down": _normal((layers, f, d),
                          (f ** -0.5) / max(cfg.n_layers, 1) ** 0.5, device,
                          generator),
    }


def mlp_apply(p, x, act: str = "silu"):
    """Gated MLP; ``gelu`` is the tanh approximation (``jax.nn.gelu``'s
    default)."""
    dt = x.dtype
    gate = x @ p["w_gate"].to(dt)
    up = x @ p["w_up"].to(dt)
    actv = F.silu(gate) if act == "silu" else F.gelu(gate,
                                                      approximate="tanh")
    return (actv * up) @ p["w_down"].to(dt)


def qkv_proj(p, x, cfg):
    """x [B,S,D] -> q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh]."""
    b, s, _ = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def out_proj(p, o, x_dtype):
    b, s, hq, dh = o.shape
    return o.reshape(b, s, hq * dh) @ p["wo"].to(x_dtype)


def init_embed(cfg, device, generator):
    """The reference's shapes and scales (``init_embed``)."""
    vp = cfg.padded_vocab
    p = {
        "embedding": _normal((vp, cfg.d_model), 0.02, device, generator),
        "final_norm": torch.zeros((cfg.d_model,), device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((cfg.d_model, vp), cfg.d_model ** -0.5,
                               device, generator)
    return p


def embed_tokens(p, tokens, cfg, dtype):
    x = p["embedding"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1).to(dtype)
    if cfg.family in ("vlm",):          # gemma-style embedding scaling
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def unembed(p, x, cfg):
    x = rms_norm(x, p["final_norm"])
    if cfg.tie_embeddings:
        logits = x.float() @ p["embedding"].float().T
    else:
        logits = x.float() @ p["lm_head"].float()
    logits = _softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window sizes as Python ints (0 = global)."""
    L = cfg.n_layers
    if cfg.window and cfg.local_global_period:
        # gemma2: even layers local, every `period`-th global
        return [cfg.window if i % cfg.local_global_period == 0 else 0
                for i in range(L)]
    if cfg.window:
        return [0 if i in cfg.global_layers else cfg.window
                for i in range(L)]
    return [0] * L
