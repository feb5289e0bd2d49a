"""Quantisation policy of the port: the paper's dither rounding as the
numerics of every dense matmul (counterpart of the reference's
``numerics/policy.py``).

``QuantPolicy`` decides how each ``dense`` product of the model runs:

* ``scheme='none'`` — the plain matmul (``matmul``);
* ``scheme='dither'`` — §VIII 'separate': activations and weights are
  dither-rounded onto a k-bit grid (dynamic absmax range), multiplied and
  dequantised;
* ``scheme='stochastic'|'deterministic'`` — the baselines.

``backend`` says where the product runs.  ``"torch"`` (the default) is the
unfused fake-quant matmul in plain torch — the reference's default
``"jnp"`` under the port's name, so a flag means the same in both
packages.  Any other name is a kernel-dispatch backend (``"auto"``,
``"cuda"``, ``"torch-ref"``): the forward runs the fused quantise-and-
multiply of ``kernels/dispatch.matmul``, on the card the hand-written CUDA
kernel.  Gradients are straight-through (``qmatmul``'s backward uses the
full-precision operands).

Every step keeps the reference's dtypes, so the CPU tests hold the port to
the reference op by op: absmax and the normalised operands are computed in
the operands' dtype (bf16 when serving) and cast to f32 before the
quantiser, the rescale ``ax·aw`` is a bf16 product.  No step divides by a
Python number: torch divides a CUDA tensor by one as a multiplication by
its reciprocal, which is not IEEE division.

The counter i_s is a float32 scalar in ``qmatmul`` (exact below 2²⁴), as
in the reference, and the int32 cast of it in the fused path.

On the training mesh (DESIGN.md §5) a product's operands are shards of
the reference's global operands (:class:`ProductShard`): the quantiser's
absmax is all-reduced (max) over the groups that split each operand, the
hash index of an element is its global one, and the fused path runs
kernel 6's sharded entry with the global shape and this block's offsets
(``kernels/dither_matmul.dither_matmul_sharded``; a K block's int32
partials are summed exactly over 'model' before one epilogue).  So every
shard's rounding is the slice of the unsharded product's, as under the
reference's GSPMD.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rounding
from repro_torch.dist import ctx
from repro_torch.dist.sharding import ShardView
from repro_torch.kernels import dispatch
from repro_torch.kernels import dither_matmul as _dm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import MatmulBlock

__all__ = ["QuantPolicy", "qmatmul", "dense", "fake_quant", "matmul",
           "ProductShard"]


@dataclass(frozen=True)
class QuantPolicy:
    scheme: str = "none"          # none | dither | stochastic | deterministic
    bits: int = 8
    n_pulses: int = 16            # dither pulse count N (unfused backend)
    seed: int = 0
    # "torch" — the unfused fake-quant matmul (the reference's "jnp").
    # Anything else is a kernel-dispatch backend ("auto", "cuda",
    # "torch-ref"): the forward runs the fused §VIII 'separate' product.
    backend: str = dispatch.UNFUSED
    quantize_weights: bool = True
    quantize_acts: bool = True

    @property
    def enabled(self) -> bool:
        return self.scheme != "none"

    def with_seed(self, seed: int) -> "QuantPolicy":
        return replace(self, seed=seed)

    def resolved(self, device=None) -> "QuantPolicy":
        """Pin ``"auto"`` to a concrete backend for ``device`` (``cuda`` on
        the card, ``torch-ref`` on the CPU; with no device ``"auto"`` stays
        and each call picks by its operands).  The engine calls this once
        at build time."""
        return replace(self, backend=dispatch.resolve_policy_backend(
            self.backend, device))


def _counter_f32(counter) -> float:
    """The counter as the reference carries it: a float32 value."""
    if isinstance(counter, torch.Tensor):
        counter = counter.item()
    return float(np.float32(counter))


@dataclass(frozen=True)
class ProductShard:
    """How one product ``x @ w`` is split over the training mesh: x's view
    (its global N-D shape, e.g. (B, S, K), and this rank's offsets) and
    the groups that split it, w's (K, N) view and groups, and whether K
    is split (a row-parallel product: partial sums over 'model')."""
    x_view: ShardView
    x_groups: Tuple = ()
    w_view: Optional[ShardView] = None
    w_groups: Tuple = ()
    k_split: bool = False

    def block(self, x_shape, w_shape) -> MatmulBlock:
        """The :class:`MatmulBlock` of a local x of ``x_shape`` (its N-D
        shape) against a local (K, N) w: global (M, K, N), x's rows as
        segments of the global row order, K and N offsets."""
        g, off = self.x_view.shape, self.x_view.offset
        wv = self.w_view or ShardView.whole(w_shape)
        if off[-1] != wv.offset[0] or g[-1] != wv.shape[0]:
            raise ValueError(f"x view {self.x_view} and w view {wv} split K "
                             "differently")
        m_g = int(np.prod(g[:-1], dtype=np.int64))
        # local row m = (b, s): global row ((b0 + b) * S + s0 + s) — one
        # segment of S_l rows per leading index (2-D: one segment)
        stride = int(np.prod(g[1:-1], dtype=np.int64)) if len(g) > 2 else 0
        seg = int(np.prod(x_shape[1:-1], dtype=np.int64)) if len(g) > 2 \
            else 0
        m0 = 0
        for d in range(len(g) - 1):
            m0 = m0 * int(g[d]) + int(off[d])
        return MatmulBlock(m_g, int(g[-1]), int(wv.shape[1]), m0=m0, seg=seg,
                           seg_stride=stride, k0=int(off[-1]),
                           n0=int(wv.offset[1]))


def _absmax(x: torch.Tensor, groups=()) -> torch.Tensor:
    """``clamp_min(max |x|, 1e-6)`` in x's dtype, the maximum taken over
    every shard of ``groups``."""
    return torch.clamp_min(
        ctx.all_reduce_max(torch.amax(torch.abs(x)), groups), 1e-6)


def _absmax_scale(x: torch.Tensor, bits: int, groups=()):
    """Symmetric dynamic range: the scale mapping [-absmax, absmax] onto
    [0, 2^k−1], and absmax, both in x's dtype (absmax over the shards of
    ``groups``)."""
    half = (1 << bits) - 1
    absmax = _absmax(x, groups)
    num = torch.tensor(half / 2.0, dtype=x.dtype, device=x.device)
    return torch.div(num, absmax), absmax


def _fake_quant(x: torch.Tensor, policy: QuantPolicy, counter: float,
                seed: int, view=None, groups=(),
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round x onto the symmetric k-bit grid with the policy's scheme, in
    x's dtype (the reference's ``_fake_quant``).  x may be one shard of
    the reference's operand: ``view`` (a ``ShardView``) or ``index`` (its
    elements' global indices) keys the hash on the global index, and the
    absmax is the maximum over the shards of ``groups``, so the shard
    rounds bit for bit as its slice of the whole tensor."""
    scale, _ = _absmax_scale(x, policy.bits, groups)
    half_levels = float((1 << policy.bits) - 1) / 2.0
    scaled = x.to(torch.float32) * scale + half_levels   # → [0, 2^k−1]
    if index is None and policy.scheme != "deterministic":
        index = rounding._flat_index(x, view)
    if policy.scheme == "deterministic":
        codes = rounding.deterministic_round(scaled)
    elif policy.scheme == "stochastic":
        idx = index
        u = rounding.hash_uniform(seed, idx, counter)
        fl = torch.floor(scaled)
        codes = fl + (u < scaled - fl).to(torch.float32)
    elif policy.scheme == "dither":
        idx = index
        slot = rounding.lcg_slot(counter, idx, policy.n_pulses, seed=seed)
        u = rounding.hash_uniform(rounding._u32(seed) ^ 0xD1CE, idx, counter)
        fl = torch.floor(scaled)
        codes = fl + rounding.dither_bit(scaled - fl, slot, u,
                                         policy.n_pulses)
    else:
        raise ValueError(f"unknown rounding scheme {policy.scheme!r}")
    codes = torch.clamp(codes, 0.0, 2.0 * half_levels)
    return ((codes - half_levels) / scale).to(x.dtype)


def _fused_sharded(x: torch.Tensor, w: torch.Tensor, policy: QuantPolicy,
                   seed: int, counter: float, shard: ProductShard,
                   block: MatmulBlock) -> torch.Tensor:
    """The fused product of one block of a sharded product: kernel 6's
    sharded entry (its plain version on the CPU or under ``torch-ref``)
    with the global absmaxes; a K block's int32 partials are all-reduced
    (exactly) over 'model' before the epilogue."""
    kw = dict(bits=policy.bits, scheme=policy.scheme, counter=int(counter),
              seed=seed)
    ax = _absmax(x, shard.x_groups)
    aw = _absmax(w, shard.w_groups)
    cuda = dispatch.resolve_backend(policy.backend, x) == "cuda"
    if cuda and not x.dtype == w.dtype == torch.bfloat16:
        raise ValueError(f"kernel 6's sharded entry takes bf16 operands; got "
                         f"{x.dtype} @ {w.dtype}")
    if cuda:
        fn = _dm.dither_matmul_sharded
    else:
        def fn(x, w, ax, aw, **k):
            return _ref.dither_matmul_scaled_ref(x, w, aw, x_absmax=ax, **k)
    if not shard.k_split:
        return fn(x.contiguous(), w, ax, aw, block=block, **kw)
    acc, rowsum, colsum = fn(x.contiguous(), w, ax, aw, block=block,
                             partials=True, **kw)
    m, n = acc.shape
    flat = torch.cat([acc.reshape(-1), rowsum, colsum])
    ctx.all_reduce_sum(flat, ctx.train_shard().model_group)
    acc, rowsum, colsum = flat.split([m * n, m, n])
    acc, rowsum, colsum = acc.reshape(m, n), rowsum.contiguous(), \
        colsum.contiguous()
    if cuda:
        return _dm.dither_matmul_epilogue(acc, rowsum, colsum, ax, aw,
                                          bits=policy.bits, k=block.K)
    return _ref.dither_matmul_scaled_epilogue_ref(
        acc, rowsum, colsum, ax, aw, bits=policy.bits, k=block.K,
        dtype=x.dtype)


def _fused_matmul(x: torch.Tensor, w: torch.Tensor, policy: QuantPolicy,
                  seed: int, counter: float) -> torch.Tensor:
    """Forward through the fused dispatch matmul (§VIII 'separate').

    The kernel takes a static operand range while the policy scales by
    the dynamic absmax, so both operands are normalised to [-1, 1] first
    (the grid is ``_fake_quant``'s) and the product is scaled back.
    Dither pulse counts follow §VII (N_A = N, N_B = M), not
    ``policy.n_pulses``.  bf16 operands on the card take the CUDA kernel's
    policy entry, which normalises and rescales inside the kernel, with
    the weight's absmax computed once per weight
    (``dither_matmul.dither_matmul_scaled``, bit for bit this function's
    other route); anything else runs the torch ops around
    ``dispatch.matmul``."""
    kw = dict(bits=policy.bits, scheme=policy.scheme, counter=int(counter),
              seed=seed)
    if (x.dtype == w.dtype == torch.bfloat16
            and dispatch.resolve_backend(policy.backend, x) == "cuda"):
        return _dm.dither_matmul_scaled(x, w, _dm.weight_absmax(w), **kw)
    ax = torch.clamp_min(torch.amax(torch.abs(x)), 1e-6)
    aw = torch.clamp_min(torch.amax(torch.abs(w)), 1e-6)
    out = dispatch.matmul(
        (x / ax).to(torch.float32), (w / aw).to(torch.float32),
        a_range=(-1.0, 1.0), b_range=(-1.0, 1.0), backend=policy.backend,
        **kw)
    return (out * (ax * aw)).to(x.dtype)


def _qmatmul_forward(x, w, policy: QuantPolicy, seed: int, counter: float,
                     shard: Optional[ProductShard] = None,
                     block: Optional[MatmulBlock] = None):
    """The quantised product; with ``shard``, x is a 2-D block of rows
    (``block`` maps them to the global rows) and the product of a K block
    comes out as the partial sum (fake-quant path) or, fused, already
    reduced over 'model'."""
    if (policy.backend != dispatch.UNFUSED and x.dim() == 2
            and policy.quantize_acts and policy.quantize_weights):
        if shard is not None:
            return _fused_sharded(x, w, policy, seed, counter, shard, block)
        return _fused_matmul(x, w, policy, seed, counter)
    if shard is None:
        xq = (_fake_quant(x, policy, counter, seed) if policy.quantize_acts
              else x)
        wq = (_fake_quant(w, policy, counter, seed + 1)
              if policy.quantize_weights else w)
        return matmul(xq, wq)
    (m, k), (_, n) = x.shape, w.shape
    xq = (_fake_quant(x, policy, counter, seed, groups=shard.x_groups,
                      index=block.a_index(m, k, x.device))
          if policy.quantize_acts else x)
    wq = (_fake_quant(w, policy, counter, seed + 1, groups=shard.w_groups,
                      index=block.b_index(k, n, w.device))
          if policy.quantize_weights else w)
    return matmul(xq, wq)


class _QMatmul(torch.autograd.Function):
    """Quantised x @ w with the straight-through backward of the
    reference's ``_qmatmul_bwd``: full-precision gradients."""

    @staticmethod
    def forward(ctx, x, w, policy, seed, counter, shard=None, block=None):
        ctx.save_for_backward(x, w)
        return _qmatmul_forward(x, w, policy, seed, counter, shard, block)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = matmul(g, w.T)
        gw = matmul(x.reshape(-1, x.shape[-1]).T, g.reshape(-1, g.shape[-1]))
        return gx.to(x.dtype), gw.to(w.dtype), None, None, None, None, None


def qmatmul(x: torch.Tensor, w: torch.Tensor, policy: QuantPolicy,
            seed: int, counter=0.0, shard: Optional[ProductShard] = None,
            block: Optional[MatmulBlock] = None) -> torch.Tensor:
    """Quantised x @ w with straight-through gradients.  ``counter`` is
    carried as a float32 value (exact for i_s < 2²⁴).  The ``"torch"``
    backend fake-quantises both operands and multiplies; any other routes
    a 2-D product through the fused dispatch matmul (same grid, same
    backward).  ``shard``/``block``: x and w are blocks of a product split
    over the training mesh (``dense`` builds them)."""
    return _QMatmul.apply(x, w, policy, seed, _counter_f32(counter), shard,
                          block)


def fake_quant(x: torch.Tensor, policy, counter=0, seed: int = 0,
               view=None, groups=()) -> torch.Tensor:
    """Round-to-grid helper with a straight-through gradient, for call
    sites that are not a matmul.  ``view`` and ``groups``: x is one shard
    of a tensor split over the training mesh (``_fake_quant``)."""
    if policy is None or not policy.enabled:
        return x
    xq = _fake_quant(x, policy, _counter_f32(counter), policy.seed + seed,
                     view=view, groups=groups)
    return x + (xq - x).detach()


def dense(x: torch.Tensor, w: torch.Tensor, policy=None, counter=0,
          seed: int = 0, shard: Optional[ProductShard] = None
          ) -> torch.Tensor:
    """The single matmul entry point of every model layer: ``x (..., d_in)
    @ w (d_in, d_out)``.  ``policy`` None (or disabled) is the plain
    ``matmul``; otherwise the quantised product of ``qmatmul`` over the
    2-D ``(rows, d_in)`` view, with seed ``policy.seed + seed``.

    ``shard``: x and w are this rank's blocks of the reference's global
    operands on the training mesh (:class:`ProductShard`, built by the
    layers); a K-split (row-parallel) product's partial sums are summed
    over 'model' (``ctx.reduce_from_model``) unless the fused kernel
    reduced its integer partials already.  Each partial comes out in the
    operands' dtype before the sum, as the reference's GSPMD-partitioned
    dot rounds it: with f32 partials the port's sharded loss sat at its
    own single-device value, 3e-4 from the reference's sharded one (2.8e-3
    for granite-moe, whose router then picks other experts); with bf16
    partials it is the reference's within 2e-6."""
    lead = x.shape[:-1]
    if shard is None and policy is not None and policy.enabled:
        shard = _data_shard(x)
    if policy is None or not policy.enabled:
        if shard is None or not shard.k_split:
            return matmul(x, w)
        return ctx.reduce_from_model(matmul(x, w))
    x2 = x.reshape(-1, x.shape[-1])
    if shard is None:
        out = qmatmul(x2, w, policy, policy.seed + seed, counter)
    else:
        out = qmatmul(x2, w, policy, policy.seed + seed, counter, shard,
                      shard.block(tuple(x.shape), w.shape))
    if shard is not None and shard.k_split:
        fused = (policy.backend != dispatch.UNFUSED and policy.quantize_acts
                 and policy.quantize_weights)
        if not fused:
            out = ctx.reduce_from_model(out).to(x.dtype)
    return out.reshape(*lead, w.shape[-1])


def _data_shard(x: torch.Tensor) -> Optional[ProductShard]:
    """The default placement of a product on the training mesh: x this
    data shard's rows of the global batch (its leading dim), replicated
    over 'model', and w whole; None where no data axis splits x."""
    s = ctx.train_shard()
    if s is None or s.dp == 1:
        return None
    shape, off = list(x.shape), [0] * x.dim()
    shape[0], off[0] = x.shape[0] * s.dp, s.data * x.shape[0]
    return ProductShard(ShardView(tuple(shape), tuple(off)),
                        s.groups("data"))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` with f32 accumulation on every device.  On the card
    this is cuBLAS's GEMM.  On the CPU bf16 operands are multiplied in f32
    and the result rounded once to bf16 — what XLA's CPU backend does for a
    bf16 dot — because torch's CPU bf16 kernel rounds a small share of its
    outputs differently."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)
