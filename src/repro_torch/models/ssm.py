"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block of the port
(counterpart of the reference's ``models/ssm.py``).

Chunked SSD: the sequence is split into chunks of Q positions; within a
chunk the output is a masked quadratic form, across chunks a recurrent
state (H, hd, N) carries over with each chunk's decay (the reference's
``lax.scan`` over chunks is a Python loop here), so the full-sequence
pass is O(L·Q).  Single-token decode is a state update, O(1) a token.
``ssm_decode_step`` returns the new state as new tensors; the decode step
of ``models/transformer.py`` writes it into the cache in place.

Every step keeps the reference's dtypes: the projections and the causal
conv run in bf16, the recurrence and the decays in f32.  ``softplus`` is
``jax.nn.softplus``, ``logaddexp(x, 0)`` (torch's own ``softplus``
switches to x above 20).

On the training mesh (tp > 1) the layout is the reference's: ``in_proj``
column-parallel, ``out_proj`` row-parallel, everything else replicated.
The column split cuts through the [z, x, B, C, dt] segments, so the
projection's columns are all-gathered over 'model' (each column is the
unsharded product's) and the conv, the scan and the gated norm run
replicated; each rank then takes its K block of ``y`` for ``out_proj``
(``ctx.scatter_to_model``, whose backward gathers the whole gradient of
``y`` back, so the replicated leaves' gradients stay equal on every
rank), and the partial sums are reduced over 'model' in ``dense``.
Decode on that mesh (``ssm_decode_step``) keeps the layout and holds the
state by heads, as ``dist.sharding.cache_specs`` cuts it: each rank
updates its heads' block of ``h`` and gathers ``y`` for the gated norm.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.dist import ctx
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.numerics.policy import dense

Params = Dict[str, Any]

__all__ = ["init_ssm", "init_ssm_state", "ssm_block", "ssm_decode_step"]


def _init(gen: torch.Generator, shape, scale=None, device="cuda"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(torch.bfloat16)


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """The reference's SSD parameters: the fused input projection to
    [x, z, B, C, dt], the depthwise conv, ``a_log``, ``dt_bias``,
    ``d_skip``, the gated norm's gain and the output projection."""
    d = cfg.d_model
    d_in, nh, _, n = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _init(gen, (d, 2 * d_in + 2 * n + nh), device=device),
        "conv_w": _init(gen, (cfg.ssm_conv_width, d_in + 2 * n), scale=0.5,
                        device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm": torch.ones((d_in,), dtype=torch.bfloat16, device=device),
        "out_proj": _init(gen, (d_in, d), device=device),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    """Zero decode state: ``h`` f32 (B, H, hd, N), ``conv`` bf16 (B, W−1,
    d_in + 2N), the conv's last W−1 inputs."""
    d_in, nh, hd, n = _dims(cfg)
    return {"h": torch.zeros((batch, nh, hd, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in + 2 * n),
                                dtype=torch.bfloat16, device=device)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, _, _, n = _dims(cfg)
    x, z = proj[..., :d_in], proj[..., d_in:2 * d_in]
    rest = proj[..., 2 * d_in:]
    return x, z, rest[..., :n], rest[..., n:2 * n], rest[..., 2 * n:]


def causal_conv(seq: torch.Tensor, w: torch.Tensor,
                carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d, seq (B, L, C) and w (W, C) bf16: the W taps
    multiplied and summed in order in seq's dtype (the reference's
    ``sum``), ``carry`` (B, W−1, C) the inputs before seq (zeros if
    None).  No activation."""
    wlen, length = w.shape[0], seq.shape[1]
    pad = (torch.zeros((seq.shape[0], wlen - 1, seq.shape[2]),
                       dtype=seq.dtype, device=seq.device)
           if carry is None else carry.to(seq.dtype))
    full = torch.cat([pad, seq], dim=1)
    out = full[:, 0:length] * w[0]
    for i in range(1, wlen):
        out = out + full[:, i:i + length] * w[i]
    return out


def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def _gated_norm(params: Params, cfg: ModelConfig, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """mamba2's gated RMSNorm: y · silu(z), then RMSNorm times the gain."""
    y = y * _silu_f32(z)
    yf = y.to(torch.float32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + cfg.norm_eps)).to(y.dtype) * params["norm"]


def ssm_block(params: Params, cfg: ModelConfig, u: torch.Tensor,
              policy=None, counter=0) -> torch.Tensor:
    """Full-sequence SSD (training), u (B, L, d_model) → (B, L, d_model)."""
    b, length, _ = u.shape
    d_in, nh, hd, n = _dims(cfg)
    q = min(cfg.ssm_chunk, length)
    pad = (-length) % q
    if pad:
        u = torch.nn.functional.pad(u, (0, 0, 0, pad))
    lp = u.shape[1]
    nc = lp // q
    f32 = torch.float32

    proj = _in_proj(params["in_proj"], cfg, u, policy, counter)
    x, z, bmat, cmat, dt = _split_proj(cfg, proj)
    xbc = _silu_f32(causal_conv(torch.cat([x, bmat, cmat], dim=-1),
                                params["conv_w"]))
    x, bmat, cmat = (xbc[..., :d_in], xbc[..., d_in:d_in + n],
                     xbc[..., d_in + n:])

    dt = softplus(dt.to(f32) + params["dt_bias"])                  # (B,L,H)
    da = dt * -torch.exp(params["a_log"])                           # ≤ 0

    xh = x.reshape(b, lp, nh, hd)
    xc = xh.reshape(b, nc, q, nh, hd)
    bc = bmat.reshape(b, nc, q, n).to(f32)
    cc = cmat.reshape(b, nc, q, n).to(f32)
    dtc = dt.reshape(b, nc, q, nh)
    seg = torch.cumsum(da.reshape(b, nc, q, nh), dim=2)             # (B,nc,q,H)
    # exp(seg_i − seg_j) for i ≥ j; clamped before exp so the masked
    # entries (diff > 0) never overflow
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]            # (B,nc,q,q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=u.device))[None, None, :, :, None]
    lmat = torch.where(mask, torch.exp(torch.clamp(diff, max=0.0)), 0.0)

    # the diagonal (intra-chunk) term: (L ∘ C Bᵀ) · (dt x)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    att = cb[..., None] * lmat
    dtx = dtc[..., None] * xc.to(f32)                               # (B,nc,q,H,hd)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", att, dtx)

    # each chunk's summary state, then the recurrence over chunks
    decay_tail = torch.exp(seg[:, :, -1:, :] - seg)
    s_chunk = torch.einsum("bckn,bckh,bckhp->bchpn", bc, decay_tail, dtx)
    chunk_decay = torch.exp(seg[:, :, -1, :])                       # (B,nc,H)
    h = torch.zeros((b, nh, hd, n), dtype=f32, device=u.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prev, dim=1)                             # (B,nc,H,hd,N)

    # the off-diagonal term: the previous chunks' state
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, torch.exp(seg),
                         h_prev)
    y = (y_diag + y_off).reshape(b, lp, nh, hd)
    y = y + params["d_skip"][None, None, :, None] * xh.to(f32)
    y = _gated_norm(params, cfg, y.reshape(b, lp, d_in).to(u.dtype), z)
    return _out_proj(params["out_proj"], y, policy, counter)[:, :length]


def _in_proj(w: torch.Tensor, cfg: ModelConfig, u: torch.Tensor, policy,
             counter) -> torch.Tensor:
    """u @ in_proj; on the training mesh with the columns split, this
    rank's column block all-gathered over 'model' (the module
    docstring)."""
    d_in, nh, _, n = _dims(cfg)
    sh = layers.tp_shard()
    if sh is None or w.shape[-1] == 2 * d_in + 2 * n + nh:
        return dense(u, w, policy, counter, seed=21)
    u = ctx.copy_to_model(u)
    part = dense(u, w, policy, counter, seed=21,
                 shard=layers.col_shard(u, w, sh))
    return ctx.gather_from_model(part, part.dim() - 1, reduce_grad=False)


def _out_proj(w: torch.Tensor, y: torch.Tensor, policy,
              counter) -> torch.Tensor:
    """y @ out_proj; on the training mesh with the rows split, row-parallel
    on this rank's K block of the replicated y."""
    sh = layers.tp_shard()
    if sh is None or w.shape[0] == y.shape[-1]:
        return dense(y, w, policy, counter, seed=22)
    y = ctx.scatter_to_model(y, y.dim() - 1)
    return dense(y, w, policy, counter, seed=22,
                 shard=layers.row_shard(y, w, sh))


def ssm_decode_step(params: Params, cfg: ModelConfig, u: torch.Tensor,
                    state: Params, policy=None, counter=0):
    """Single-token decode, u (B, 1, d_model) → ((B, 1, d_model), new
    state ``{"h", "conv"}``, as new tensors).

    On the training mesh (the module docstring's layout) ``in_proj`` is
    column-parallel with its columns gathered and the conv and its state
    replicated, as in training; where ``dist.sharding.cache_specs`` cuts
    the state ``h`` by heads (a rank's (B, H / tp, hd, N) block), the
    state update and ``y = C·h + D·x`` run on the rank's heads only, ``y``
    is all-gathered over 'model' for the gated norm over all of d_in,
    and ``out_proj`` is row-parallel on the rank's K block.  Each head's
    update is the one-device update of that head."""
    b = u.shape[0]
    d_in, nh, hd, n = _dims(cfg)
    f32 = torch.float32
    proj = _in_proj(params["in_proj"], cfg, u, policy, counter)
    x, z, bmat, cmat, dt = _split_proj(cfg, proj)
    xbc = torch.cat([x, bmat, cmat], dim=-1)                        # (B,1,·)
    out = _silu_f32(causal_conv(xbc, params["conv_w"], carry=state["conv"]))
    new_conv = torch.cat([state["conv"], xbc.to(state["conv"].dtype)],
                         dim=1)[:, 1:]
    x, bmat, cmat = (out[:, 0, :d_in], out[:, 0, d_in:d_in + n],
                     out[:, 0, d_in + n:])

    # this rank's heads: all of them, or its block where h is cut by heads
    nh_l = state["h"].shape[1]
    h0 = layers.tp_shard().model * nh_l if nh_l != nh else 0
    heads = slice(h0, h0 + nh_l)
    dt = softplus(dt[:, 0, heads].to(f32) + params["dt_bias"][heads])
    dec = torch.exp(dt * -torch.exp(params["a_log"][heads]))
    xh = x.reshape(b, nh, hd)[:, heads].to(f32)
    dtx = dt[:, :, None] * xh                                       # (B,H,hd)
    h = (state["h"] * dec[:, :, None, None]
         + dtx[:, :, :, None] * bmat.to(f32)[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, cmat.to(f32))
    y = y + params["d_skip"][heads][None, :, None] * xh
    y = y.reshape(b, 1, nh_l * hd).to(u.dtype)
    if nh_l != nh:
        y = ctx.gather_from_model(y, y.dim() - 1, reduce_grad=False)
    y = _gated_norm(params, cfg, y, z)
    return _out_proj(params["out_proj"], y, policy, counter), {
        "h": h, "conv": new_conv}
