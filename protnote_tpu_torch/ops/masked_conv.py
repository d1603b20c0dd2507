"""The ProteInfer encoder's masked dilated-conv chain (K7): forward, backward
and its train-mode masked BatchNorm + ReLU.

Port of ``protnote_tpu/models/proteinfer.py:_masked_conv`` (line 127) as
``proteinfer_embed`` (line 147) chains it.  Activations are channel-last
``(B, T, C)`` and a conv kernel is the JAX layout ``(taps, C_in, C_out)``;
position t of sequence b is valid when ``t < lengths[b]``.  A masked conv is

    y = mask * (bf16(conv(mask * x, W)) + bias)      (bias rounded to bf16)

optionally after eval-mode BatchNorm + ReLU of its input (``bn``: the
per-channel ``inv``/``shift`` of ``models.layers.bn_affine``, applied
before the mask)
and followed by a residual add in the compute dtype.  The embedding is the
masked mean pool of the last block's output over ``max(length, 1)``.

Five hand-written CUDA sources carry it on the card, in bf16 and in
float32 (``MIXED_PRECISION False``: the forward, its backward and the
train-mode BatchNorm):

* ``csrc/masked_conv.cu``: ``masked_conv_forward``, an implicit GEMM on
  TMA + wgmma (``csrc/masked_conv.cuh``: persistent, warp-specialised, A
  formed in registers) with the BN prologue and the bias/mask/residual
  epilogue;
* ``csrc/masked_conv_f32.cu``: ``masked_conv_forward_f32``, the same conv
  in float32 on the bf16 tensor cores by the bf16x3 split (the bf16
  kernel's TMA + wgmma frame at 128 x 112 tiles, float32 rows split into
  three bf16 pieces in registers against W's pieces, six products a k-step,
  each 64-deep stage added into float32 sums), for an encoder that computes
  in float32 as JAX does at ``Precision.HIGHEST``; ``masked_conv_dx_f32``,
  the same kernel with the taps reversed over the dX pieces
  (:func:`conv_weight_layout_f32` with ``dx``); and ``masked_conv_dw_f32``
  (dy split once a call, then dW a tap on wgmma over 64-position K steps of
  :func:`dw_step_plan` at its 128 x 128 tile, the splits summed in order;
  dbias);
* ``csrc/masked_pool.cu``: ``masked_mean_pool`` (a block a sequence's
  valid rows over 128 channels, 64 rows at once; :func:`pool_plan`), its
  float32 form ``masked_mean_pool_f32`` and its transposes
  ``masked_mean_pool_backward`` and ``_f32``, which write the gradient at
  the padded pitch the last conv's backward reads;
* ``csrc/masked_conv_bwd.cu``: ``masked_conv_dx`` (the transposed dilated
  conv on the forward's mainloop, masks on both sides) and
  ``masked_conv_dw`` (dW a tap on TMA + wgmma over the K steps of a
  host-built plan, :func:`dw_step_plan`, summed in a fixed order; dbias);
* ``csrc/masked_bn.cu``: the train-mode masked BN + ReLU of the JAX
  ``batchnorm_apply(train=True, reduce_axes=(0, 1), mask, count)`` with its
  count rule (:func:`bn_mask_and_count`), forward and backward, two
  launches each on the grids of :func:`bn_plan`, in bf16 and float32
  (``_f32``: the same kernels on float32 rows, nothing rounded to bf16).

The conv kernels read their input through TMA, which takes rows that start
on 16 bytes: an activation is a strided ``(B, T, C)`` tensor whose rows lie
:func:`row_pitch` (C rounded up to 8) channels apart (:func:`padded_empty`,
:func:`pad_pitch`; 1,100 -> 1,104, 550 -> 552, the one-hot's 20 -> 24).  The
chain keeps its activations so; a wrapper copies an input of another pitch
into such a buffer (the copy is part of its time), and the conv, its dX and
the BatchNorm's forward and backward write their outputs at that pitch, so
that the next kernel reads them as they are.  The weights are re-laid once a version
(:func:`conv_weight_layout`, or for float32 split into bf16 pieces by
:func:`conv_weight_layout_f32`, cached on the parameter tensor by
:func:`weight_layout`; under autograd laid once a call, the version each
training step reads once, and not kept), and each call
runs the tiles of a plan built on the host from the lengths
(:func:`conv_tile_plan`, and for dW :func:`dw_step_plan`; the lengths are
read back once a tensor).

:func:`masked_conv`, :func:`masked_bn_relu_train` and
:func:`masked_mean_pool` dispatch on the device: CPU tensors take the plain
PyTorch versions (the ``*_reference`` functions, which also run on the card
as the yardstick), CUDA tensors the kernels, through ``autograd.Function``s
when a gradient is wanted.  On the card they take bfloat16 or float32 and
any other dtype raises; nothing falls back to cuDNN.

Rounding points in the bf16 backward: each gradient is rounded to bf16
once, after its float32 sum (dX, dW and dbias of a conv; dx of the BN), and
the master weights receive the bf16 value cast to float32.  JAX's own bf16
``_masked_conv`` cannot be differentiated (its conv's transpose mixes a
float32 cotangent with a bf16 operand and raises); the port rounds where
its transposed convs would with the cotangent cast to bf16.  The float32
backward rounds nothing to bf16: it is JAX's float32 vjp in another order
of sums.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from protnote_tpu_torch.models.layers import Params, batchnorm_train, gemm_precision
from protnote_tpu_torch.ops.kernels import call_on_stream, kernel_function
from protnote_tpu_torch.ops.pair_scorer import split_bf16x3

# Launches of each kernel entry point since the process started (or since a
# caller last set them to 0); one a call of its wrapper.
LAUNCHES = {"masked_conv_fwd": 0, "masked_mean_pool": 0, "masked_conv_dx": 0,
            "masked_conv_dw": 0, "masked_bn_relu_fwd": 0, "masked_bn_relu_bwd": 0,
            "masked_mean_pool_bwd": 0, "masked_conv_fwd_f32": 0, "masked_mean_pool_f32": 0,
            "masked_conv_dx_f32": 0, "masked_conv_dw_f32": 0, "masked_bn_relu_fwd_f32": 0,
            "masked_bn_relu_bwd_f32": 0, "masked_mean_pool_bwd_f32": 0}
_launch_lock = threading.Lock()

_H100_SMS = 132


# ----------------------------------------------------------------------
# plain versions


def valid_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T, 1) float32 mask of the positions ``t < lengths[b]``."""
    pos = torch.arange(T, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()[..., None]


def masked_conv_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                          lengths: torch.Tensor, dilation: int,
                          bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked conv in eager PyTorch: ``x`` (B, T, C_in), ``kernel``
    (taps, C_in, C_out), ``bias`` (C_out,), the result in ``x``'s dtype.  The
    bias is added after the conv's rounding, as JAX does (``conv1d(bias=...)``
    would add it before)."""
    mask = valid_mask(lengths, x.shape[1]).to(x.dtype)
    if bn is not None:
        inv, shift = bn
        x = torch.relu((x.float() * inv + shift).to(x.dtype))
    gemm_precision(x.dtype)
    taps = kernel.shape[0]
    y = F.conv1d((x * mask).transpose(1, 2), kernel.to(x.dtype).permute(2, 1, 0),
                 padding=dilation * (taps - 1) // 2, dilation=dilation).transpose(1, 2)
    y = (y + bias.to(y.dtype)) * mask
    return y if residual is None else residual + y


def masked_conv_backward_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                                   dy: torch.Tensor, lengths: torch.Tensor,
                                   dilation: int) -> Tuple[torch.Tensor, ...]:
    """``(dx, dkernel, dbias)``: the vjp of :func:`masked_conv_reference` (no
    prologue, no residual) at ``dy`` by its autograd, in ``x``'s dtype --
    the plain version of the conv's backward kernels."""
    with torch.enable_grad():
        xg, wg, bg = (t.detach().requires_grad_(True) for t in (x, kernel, bias))
        y = masked_conv_reference(xg, wg, bg, lengths, dilation)
        return torch.autograd.grad(y, [xg, wg, bg], dy)


def bn_mask_and_count(lengths: torch.Tensor, example_mask: Optional[torch.Tensor],
                      T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX count rule (``proteinfer_embed``): the (B, T, 1) statistics
    mask (valid positions of the rows ``example_mask`` keeps) and the divisor
    ``max(rows * max_valid_length, 1)``, the reference's position count over
    its batch padded to the longest sequence."""
    mask = valid_mask(lengths, T)
    lengths_f = lengths.float()
    if example_mask is not None:
        em = example_mask.float()
        mask = mask * em[:, None, None]
        rows, t_ref = em.sum(), (lengths_f * em).max()
    else:
        rows = torch.tensor(float(lengths.shape[0]), device=lengths.device)
        t_ref = lengths_f.max()
    return mask, torch.clamp(rows * t_ref, min=1.0)


def masked_bn_relu_reference(x: torch.Tensor, p: Params, s: Params, lengths: torch.Tensor,
                             example_mask: Optional[torch.Tensor], eps: float,
                             momentum: float) -> Tuple[torch.Tensor, Params]:
    """``(relu(BN(x)), new_state)`` with train-mode masked BatchNorm over
    (B, T) under the count rule: the plain ``batchnorm_train``."""
    mask, count = bn_mask_and_count(lengths, example_mask, x.shape[1])
    # the moments' float32 sums follow the memory layout: sum a row-major
    # copy, so that the same values at any row pitch give the same bits
    y, new_state = batchnorm_train(p, s, x.contiguous(), eps, momentum, reduce_axes=(0, 1),
                                   mask=mask, count=count)
    return torch.relu(y), new_state


def masked_bn_relu_backward_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                      stats: torch.Tensor, counts: torch.Tensor,
                                      lengths: torch.Tensor,
                                      example_mask: Optional[torch.Tensor]
                                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function of ``masked_bn_relu_backward`` in eager PyTorch, on the
    same inputs: ``(dx in x's dtype, dscale, dbias)`` from the forward's
    ``stats`` (5, C) = mean, var, rstd, inv, shift and ``counts`` (n,
    n_valid), with the ReLU's gate the forward's ``x.dtype(x * inv + shift)
    > 0`` (the autodiff of the BatchNorm, whose variance's derivative through
    the mean is zero under the count rule)."""
    mean, _, rstd, inv, shift = stats
    xf, g = x.float(), dy.float()
    gz = torch.where((xf * inv + shift).to(x.dtype) > 0, g, torch.zeros_like(g))
    xc = xf - mean
    G, Gx = gz.sum((0, 1)), (gz * xc).sum((0, 1))
    m, _ = bn_mask_and_count(lengths, example_mask, x.shape[1])
    dx = inv * gz + m / counts[0] * (-inv * G - scale * rstd * rstd * rstd * Gx * xc)
    return dx.to(x.dtype), Gx * rstd, G


def masked_mean_pool_reference(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, C) float32: the sum of the valid rows over ``max(length, 1)``,
    summed in a row-major copy (the same bits at any row pitch)."""
    feats = feats.contiguous()
    mask = valid_mask(lengths, feats.shape[1]).to(feats.dtype)
    denom = torch.clamp(lengths[:, None].float(), min=1.0)
    return (feats * mask).float().sum(dim=1) / denom


def masked_mean_pool_backward_reference(g: torch.Tensor, lengths: torch.Tensor, T: int,
                                        dtype: torch.dtype) -> torch.Tensor:
    """The pool's transpose: (B, T, C) ``dtype``, ``dtype(g / max(length,
    1))`` on the valid rows and that value times 0 past them (the JAX vjp
    of ``feats * mask``, the cast to float32 and the division)."""
    mask = valid_mask(lengths, T).to(dtype)
    denom = torch.clamp(lengths[:, None].float(), min=1.0)
    return (g / denom).to(dtype)[:, None, :] * mask


# ----------------------------------------------------------------------
# the conv kernels' layouts and plan

BLOCK_M = 128  # positions of a conv tile (csrc/masked_conv.cuh BM)
BLOCK_N = 184  # columns of a conv tile (BN): 552 = 3 x 184, 1104 = 6 x 184
BLOCK_K = 64  # channels of a K step (BK): one 128-byte swizzled row
PITCH_CHANNELS = 8  # a row pitch is a multiple of 8 bf16 channels: 16 bytes
F32_BLOCK_M = 128  # positions of a float32 conv tile (csrc/masked_conv_f32.cu BM)
F32_BLOCK_N = 112  # columns of a float32 conv tile (BN): 550 -> 5 x 112, 1,100 -> 10 x 112
F32_BLOCK_K = 64  # channels of a float32 K stage (BK)
F32_DW_BLOCK = 128  # input and output channels of a float32 dW tile (csrc/masked_conv_f32.cu)
F32_DW_STEP = 64  # positions of a float32 dW K step (DW_BK)


def row_pitch(channels: int) -> int:
    """The row pitch of a ``channels``-wide activation: rounded up to 8."""
    return -(-channels // PITCH_CHANNELS) * PITCH_CHANNELS


def padded_empty(B: int, T: int, C: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised ``(B, T, C)`` tensor whose rows lie :func:`row_pitch`
    (C) elements apart (strided, not a view), on a storage of ``B * T *
    row_pitch(C)`` elements: it holds the last row's padding channels too,
    which the BN kernels read and write with the row's last 16 bytes."""
    P = row_pitch(C)
    storage = torch.empty(B * T * P, dtype=dtype, device=device).untyped_storage()
    return torch.empty(0, dtype=dtype, device=device).set_(storage, 0, (B, T, C), (T * P, P, 1))


def pitch_of(x: torch.Tensor) -> Optional[int]:
    """The row pitch of a ``(B, T, C)`` tensor whose channels are contiguous
    and whose rows lie one pitch apart (a contiguous tensor: C), else None."""
    B, T, C = x.shape
    sb, st, sc = x.stride()
    if (sc != 1 and C > 1) or st < C or (B > 1 and sb != T * st):
        return None
    return st


def pad_pitch(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where its rows already lie a multiple of 8 channels apart
    (and start on 16 bytes), else a copy at :func:`row_pitch` (C)."""
    p = pitch_of(x)
    if p is not None and p % PITCH_CHANNELS == 0 and x.data_ptr() % 16 == 0:
        return x
    out = padded_empty(*x.shape, dtype=x.dtype, device=x.device)
    out.copy_(x)
    return out


def conv_weight_layout(kernel: torch.Tensor, dx: bool) -> torch.Tensor:
    """The conv kernels' B operand from a JAX-layout kernel (taps, C_in,
    C_out): ``(taps, n_pad, k_pad)`` with K contiguous, zero-padded to N
    rounded up to 184 and K to 64 -- W[j] transposed for the forward (N =
    C_out, K = C_in), W[j] itself for dX (N = C_in, K = C_out)."""
    taps, cin, cout = kernel.shape
    n, k = (cin, cout) if dx else (cout, cin)
    return F.pad(kernel if dx else kernel.transpose(1, 2),
                 (0, -(-k // BLOCK_K) * BLOCK_K - k, 0, -(-n // BLOCK_N) * BLOCK_N - n))


def conv_weight_layout_f32(kernel: torch.Tensor, dx: bool = False) -> torch.Tensor:
    """The float32 conv kernels' B operand from a JAX-layout kernel (taps,
    C_in, C_out): ``(3, taps, n_pad, k_pad)`` bf16, the three pieces of
    :func:`~protnote_tpu_torch.ops.pair_scorer.split_bf16x3` (their sum is
    the float32 weight exactly) with K contiguous, zero-padded to N rounded
    up to 112 and K to 64 -- W[j] transposed for the forward (N = C_out, K
    = C_in), W[taps - 1 - j] itself for dX (N = C_in, K = C_out: the forward
    conv of the output gradient with the taps reversed).  Made where the
    kernel lies (on the card for the card's kernels)."""
    w = kernel.float()
    w = w.flip(0) if dx else w.transpose(1, 2)
    _, n, k = w.shape
    w = F.pad(w, (0, -(-k // F32_BLOCK_K) * F32_BLOCK_K - k,
                  0, -(-n // F32_BLOCK_N) * F32_BLOCK_N - n))
    return torch.stack(split_bf16x3(w)).contiguous()


def _version(t: torch.Tensor) -> int:
    """``t``'s version counter; 0 for an inference tensor, which keeps none
    (it can be written in place only inside inference mode)."""
    return 0 if t.is_inference() else t._version


def _cached(t: torch.Tensor, key, make):
    """``make()``, kept on the tensor ``t`` under ``key`` for t's storage and
    version: an in-place update (an optimizer step) or a new tensor makes it
    again."""
    cache = getattr(t, "_k7_cache", None)
    if cache is None:
        cache = t._k7_cache = {}
    stamp = (t.data_ptr(), _version(t))
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = cache[key] = (stamp, make())
    return hit[1]


def weight_layout(kernel: torch.Tensor, dtype: torch.dtype, dx: bool) -> torch.Tensor:
    """:func:`conv_weight_layout` of ``kernel`` cast to ``dtype`` (for float32
    the pieces of :func:`conv_weight_layout_f32`), cached on the kernel
    tensor (:func:`_cached`): made once a weight version."""
    if dtype == torch.float32:
        return _cached(kernel, ("layout_f32", dx),
                       lambda: conv_weight_layout_f32(kernel.detach(), dx))
    return _cached(kernel, ("layout", dx, dtype),
                   lambda: conv_weight_layout(kernel.detach().to(dtype), dx))


def conv_tile_plan(lengths, T: int, taps: int, dilation: int, n: int, dx: bool,
                   bm: int = BLOCK_M, bn: int = BLOCK_N) -> np.ndarray:
    """The conv kernels' schedule: int32 tile codes ``(b * mtiles + row tile)
    * ntiles + column tile`` (``mtiles`` = ceil(T / bm), ``ntiles`` =
    ceil(n / bn); bf16 tiles 128 x 184, float32 tiles 128 x 112) of every
    tile whose first row is valid (t0 < min(L, T)), the most taps first
    (ties in code order).  A tile runs the taps whose shifted rows meet [0,
    L) for its rows [t0, t0 + bm) (the kernels' tap range).  The kernels'
    persistent blocks take tiles i, i + grid, ...  The rows of the other row
    tiles are written besides (zeros, or the residual)."""
    lens = np.clip(np.asarray(lengths, np.int64).reshape(-1), 0, T)
    mtiles, ntiles = -(-T // bm), -(-n // bn)
    step = -dilation if dx else dilation
    t0 = np.arange(mtiles)[None, :, None] * bm
    s = step * (np.arange(taps) - (taps - 1) // 2)[None, None, :]
    L = lens[:, None, None]
    hit = (t0 < L) & (t0 + s < L) & (t0 + bm + s > 0)  # (B, mtiles, taps)
    j = np.arange(taps)
    jlo = np.where(hit, j, taps).min(axis=2)
    jhi = np.where(hit, j, -1).max(axis=2)
    count = np.maximum(jhi - jlo + 1, 0).reshape(-1)  # taps a row tile runs
    rows = np.flatnonzero(count > 0)
    order = rows[np.argsort(-count[rows], kind="stable")]
    codes = (order[:, None] * ntiles + np.arange(ntiles)[None, :]).reshape(-1)
    return codes.astype(np.int32)


def skipped_rows(lengths, T: int, bm: int = BLOCK_M) -> int:
    """The rows of the row tiles a plan leaves out: each sequence's rows from
    its length rounded up to ``bm`` to T."""
    lens = np.clip(np.asarray(lengths, np.int64).reshape(-1), 0, T)
    return int(np.sum(T - np.minimum(T, -(-lens // bm) * bm)))


def _plan_on(lengths: torch.Tensor, T: int, taps: int, dilation: int, n: int, dx: bool,
             device, bm: int = BLOCK_M, bn: int = BLOCK_N) -> torch.Tensor:
    """:func:`conv_tile_plan` as an int32 tensor on ``device`` (its length in
    ``.tiles``, the rows it leaves out in ``.skipped``), kept on the lengths
    tensor (:func:`_cached`): a chain's 11 convs share 7 plans and one
    read-back of the lengths to the host."""
    def make():
        host = (lengths if lengths.device.type == "cpu"
                else _cached(lengths, "host", lambda: lengths.cpu()))
        codes = torch.from_numpy(conv_tile_plan(host.numpy(), T, taps, dilation, n, dx, bm, bn))
        plan = (codes.pin_memory().to(device, non_blocking=True) if len(codes)
                else torch.zeros(1, dtype=torch.int32, device=device))
        plan.tiles = len(codes)
        plan.skipped = skipped_rows(host.numpy(), T, bm)
        return plan

    return _cached(lengths, ("plan", T, taps, dilation, n, dx, bm, bn, str(device)), make)


DW_BLOCK_M = 128  # input channels of a dW tile (csrc/masked_conv_bwd.cu DW_BM)
DW_BLOCK_N = 192  # output channels of a dW tile (DW_BN): 550 -> 3 x 192, 1100 -> 6 x 192
DW_STEP = 64  # positions of a dW K step (DW_BK), all of one sequence


def dw_tiles(taps: int, cin: int, cout: int, bm: int = DW_BLOCK_M, bn: int = DW_BLOCK_N) -> int:
    """dW's output tiles: one a (tap, row tile, column tile)."""
    return taps * -(-cin // bm) * -(-cout // bn)


def dw_splits(taps: int, cin: int, cout: int, sms: int = _H100_SMS, bm: int = DW_BLOCK_M,
              bn: int = DW_BLOCK_N) -> int:
    """How many ranges ``masked_conv_dw`` cuts each tap's K steps into: the
    most that keep its work items within one wave of ``sms`` blocks, at
    least one (a step's full width: 9 x 1,100 x 550 has 243 tiles, 1;
    1 x 550 x 1,100 has 30, 4; conv1's 9 x 20 x 1,100 has 54, 2).  Each
    split past the first costs float32 partials of the whole dW.  The
    float32 kernel passes its 128 x 128 tile (9 x 1,100 x 550: 405 tiles, 1
    split; 1 x 550 x 1,100: 45, 2; conv1: 81, 1)."""
    return max(1, sms // dw_tiles(taps, cin, cout, bm, bn))


def dw_step_plan(lengths, T: int, taps: int, dilation: int, cin: int, cout: int,
                 sms: int = _H100_SMS, bm: int = DW_BLOCK_M, bn: int = DW_BLOCK_N,
                 step: int = DW_STEP) -> Tuple[np.ndarray, int, int]:
    """``masked_conv_dw``'s schedule: ``(plan, splits, n_items)``, plan an
    int32 array of

    * ``n_items`` item codes ``((j * splits + sp) * mtiles + mt) * ntiles +
      nt`` (tap j, split sp, row tile mt of 128 input channels, column tile
      nt of 192 output channels), the most K steps first (ties in code
      order), every other wave of ``sms`` items reversed: the persistent
      blocks take items i, i + sms, ..., so a block with a long first item
      gets a short second one;
    * ``taps * splits + 1`` offsets: the steps of (j, sp) are
      ``[offsets[j * splits + sp], offsets[j * splits + sp + 1])``;
    * the steps, two words each: ``b`` and ``t0 | rows << 16``.

    Tap j (shift s = dilation * (j - (taps - 1) // 2)) needs the positions t
    of sequence b with t < L and 0 <= t + s < L, i.e. [max(0, -s), min(L, L
    - s)); its steps cover them in (b, t) order, ``step`` positions at most
    (64 for both kernels) and never two sequences
    a step (``rows`` of them valid from t0), and split sp takes steps
    [floor(sp n / splits), floor((sp + 1) n / splits)) of the tap's n.
    ``bm`` x ``bn`` is the kernel's tile (input x output channels)."""
    lens = np.clip(np.asarray(lengths, np.int64).reshape(-1), 0, T)
    if T > 0xFFFF:
        raise ValueError(f"dW's plan packs a position in 16 bits: T {T} is too long")
    splits = dw_splits(taps, cin, cout, sms, bm, bn)
    mtiles, ntiles = -(-cin // bm), -(-cout // bn)
    shift = dilation * (np.arange(taps) - (taps - 1) // 2)
    lo = np.maximum(0, -shift)[:, None]  # (taps, 1)
    hi = np.minimum(lens[None, :], lens[None, :] - shift[:, None])  # (taps, B)
    n = np.maximum(0, -(-(hi - lo) // step)).reshape(-1)  # steps of each (tap, sequence)
    pair = np.repeat(np.arange(n.size), n)  # each step's (tap, sequence)
    t0 = np.repeat(lo, len(lens), axis=1).reshape(-1)[pair] + step * (
        np.arange(pair.size) - np.repeat(np.cumsum(n) - n, n))
    rows = np.minimum(step, hi.reshape(-1)[pair] - t0)
    steps = np.stack([pair % len(lens), t0 | (rows << 16)], axis=1)
    counts = n.reshape(taps, -1).sum(axis=1)  # steps of each tap
    starts = np.concatenate([[0], np.cumsum(counts)])
    offsets = np.concatenate([
        (starts[:-1, None] + np.arange(splits)[None, :] * counts[:, None] // splits).reshape(-1),
        starts[-1:]])
    work = np.diff(offsets)  # steps of each (j, sp)
    order = np.argsort(-work, kind="stable")
    tiles = np.arange(mtiles * ntiles)
    items = (order[:, None] * (mtiles * ntiles) + tiles[None, :]).reshape(-1)
    for w0 in range(sms, len(items), 2 * sms):
        items[w0:w0 + sms] = items[w0:w0 + sms][::-1].copy()
    plan = np.concatenate([items, offsets, steps.reshape(-1)])
    return plan.astype(np.int32), splits, len(items)


def _dw_plan_on(lengths: torch.Tensor, T: int, taps: int, dilation: int, cin: int, cout: int,
                device, f32: bool = False) -> torch.Tensor:
    """:func:`dw_step_plan` as an int32 tensor on ``device`` (``.splits``,
    ``.items``), kept on the lengths tensor as :func:`_plan_on` keeps the
    conv plans (the same read-back of the lengths); ``f32``: the float32
    kernel's (128 x 128 tiles, 64-position steps, one block an SM)."""
    def make():
        host = (lengths if lengths.device.type == "cpu"
                else _cached(lengths, "host", lambda: lengths.cpu()))
        shape = ((_num_sms(device), F32_DW_BLOCK, F32_DW_BLOCK, F32_DW_STEP) if f32
                 else (_num_sms(device),))
        plan, splits, items = dw_step_plan(host.numpy(), T, taps, dilation, cin, cout, *shape)
        out = torch.from_numpy(plan).pin_memory().to(device, non_blocking=True)
        out.splits, out.items = splits, items
        return out

    return _cached(lengths, ("dw_plan", T, taps, dilation, cin, cout, f32, str(device)), make)


@functools.lru_cache(maxsize=None)
def _num_sms(device) -> int:
    """The conv kernels' grid: one persistent block an SM (those left without
    a tile write the rows past the lengths)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# ----------------------------------------------------------------------
# the kernels' wrappers

POOL_LANE = 8  # channels of a pool thread (csrc/masked_pool.cu LANE_CHANNELS): 16 bytes
POOL_GROUP_CHANNELS = 128  # channels of a pool block (GROUP_CHANNELS)
POOL_THREADS = 1024  # threads of a pool block (POOL_THREADS): 64 row slots of 16 lanes
POOL_IN_FLIGHT = 4  # rows a pool thread loads before their adds (IN_FLIGHT)
POOL_BWD_ROWS = 32  # rows of a pool backward block (BWD_ROWS)
POOL_BWD_GROUPS = 4  # row groups of a pool backward block (GROUPS): 8 consecutive rows each
POOL_MAX_CHANNELS = 1280  # the backward's widest row: 160 lanes of 8 (MAX_LANES)


class PoolPlan(NamedTuple):
    """``masked_mean_pool``'s launch for (B, T, C) at ``pitch``: grid
    (``groups``, B) blocks of ``POOL_THREADS``, thread i the row slot i //
    ``lanes`` (rows slot, slot + ``slots``, ... below the length) and the
    lane i % ``lanes`` (channels ``128 group + 8 lane`` to ``+ 7``, those
    below C); ``width`` the channels a load reads at once (8: 16 bytes).
    The backward: (ceil(T / 32), B) blocks of ``bwd_threads``, its lanes
    covering the padded pitch."""
    groups: int
    lanes: int
    slots: int
    width: int
    bwd_threads: int


def pool_plan(T: int, C: int, pitch: int, base: int = 0) -> PoolPlan:
    """The pool kernels' launch (see :class:`PoolPlan`): the kernel's own
    arithmetic, for the CPU tests.  ``base`` is the input's address (its
    alignment picks the load width)."""
    width = POOL_LANE
    while width > 1 and (pitch % width or base % (2 * width)):
        width //= 2
    lanes = POOL_GROUP_CHANNELS // POOL_LANE
    return PoolPlan(-(-C // POOL_GROUP_CHANNELS), lanes, POOL_THREADS // lanes, width,
                    -(-POOL_BWD_GROUPS * row_pitch(C) // POOL_LANE // 32) * 32)


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGS = {
    ("masked_conv", "masked_conv_forward"): [_P] * 9 + [_I] * 13 + [_P],
    ("masked_conv_f32", "masked_conv_forward_f32"): [_P] * 9 + [_I] * 13 + [_P],
    ("masked_pool", "masked_mean_pool"): [_P] * 3 + [_I] * 4 + [_P],
    ("masked_pool", "masked_mean_pool_f32"): [_P] * 3 + [_I] * 4 + [_P],
    ("masked_pool", "masked_mean_pool_backward"): [_P] * 3 + [_I] * 4 + [_P],
    ("masked_pool", "masked_mean_pool_backward_f32"): [_P] * 3 + [_I] * 4 + [_P],
    ("masked_conv_bwd", "masked_conv_dx"): [_P] * 5 + [_I] * 12 + [_P],
    ("masked_conv_bwd", "masked_conv_dw"): [_P] * 8 + [_I] * 11 + [_P],
    ("masked_conv_f32", "masked_conv_dx_f32"): [_P] * 5 + [_I] * 12 + [_P],
    ("masked_conv_f32", "masked_conv_dw_f32"): [_P] * 9 + [_I] * 11 + [_P],
    ("masked_bn", "masked_bn_relu_forward"): [_P, _I] + [_P] * 6 + [_F] * 3 + [_P] * 7
                                             + [_I] * 5 + [_P],
    ("masked_bn", "masked_bn_relu_forward_f32"): [_P, _I] + [_P] * 6 + [_F] * 3 + [_P] * 7
                                                 + [_I] * 5 + [_P],
    ("masked_bn", "masked_bn_relu_backward"): [_P, _I, _P, _I] + [_P] * 9 + [_I] * 5 + [_P],
    ("masked_bn", "masked_bn_relu_backward_f32"): [_P, _I, _P, _I] + [_P] * 9 + [_I] * 5
                                                  + [_P],
    ("masked_bn", "masked_bn_kernels_launched"): [],
}


def _launch(library: str, symbol: str, counter: str, device: torch.device, *args) -> None:
    """Call a C entry point on ``device``'s current stream, raise on its CUDA
    error, count the launch."""
    err = call_on_stream(device, kernel_function(library, symbol, _ARGS[(library, symbol)]),
                         *args)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES[counter] += 1


def check_compute_dtype(dtype: torch.dtype) -> None:
    """What the card's K7 kernels take, forward, backward and train-mode
    BatchNorm: bfloat16 or float32; any other dtype raises ``ValueError``."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA encoder kernels (K7) compute in bfloat16 or float32, "
                         f"not {dtype}")


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {device}, not {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 4:
        raise ValueError(f"{name} must be contiguous and 4-byte aligned")


def _rows(name: str, t: torch.Tensor, shape, device) -> Tuple[torch.Tensor, int]:
    """``(t, its row pitch)`` for a bf16 ``(B, T, C)`` activation read row by
    row (contiguous channels, rows one pitch apart, 4-byte aligned), else a
    contiguous copy and C."""
    if t.device != device or t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be bf16 {tuple(shape)} on {device}, not {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    p = pitch_of(t)
    if p is None or t.data_ptr() % 4:
        t, p = t.contiguous(), t.shape[2]
    return t, p


def _lengths_on(lengths: torch.Tensor, device) -> torch.Tensor:
    if lengths.dtype == torch.int32 and lengths.device == device and lengths.is_contiguous():
        return lengths
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def masked_conv_cuda(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     lengths: torch.Tensor, dilation: int,
                     bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     residual: Optional[torch.Tensor] = None,
                     layout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``masked_conv_forward``: bf16 ``x`` (B, T, C_in) at any row pitch (one
    that is not a multiple of 8 is copied into a padded buffer first),
    ``kernel`` (taps, C_in, C_out) bf16 (or only its shape, with ``layout``
    its :func:`conv_weight_layout`), ``bias`` (C_out,), optional float32
    ``bn`` (inv, shift) (C_in,) and bf16 ``residual`` (B, T, C_out); returns
    (B, T, C_out) at :func:`row_pitch` (C_out)."""
    if x.device.type != "cuda":
        raise ValueError(f"masked_conv_forward needs CUDA tensors, not {x.device}")
    dev, bf16 = x.device, torch.bfloat16
    B, T, cin = x.shape
    taps, cout = kernel.shape[0], kernel.shape[2]
    if x.dtype != bf16:
        raise ValueError(f"x must be bf16, not {x.dtype}")
    if tuple(kernel.shape) != (taps, cin, cout):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not take x {tuple(x.shape)}")
    if layout is None:
        _check("kernel", kernel, (taps, cin, cout), bf16, dev)
        layout = conv_weight_layout(kernel, dx=False)
    n_pad, k_pad = -(-cout // BLOCK_N) * BLOCK_N, -(-cin // BLOCK_K) * BLOCK_K
    _check("weight layout", layout, (taps, n_pad, k_pad), bf16, dev)
    _check("bias", bias, (cout,), bf16, dev)
    xp = pad_pitch(x)
    inv, shift = bn if bn is not None else (None, None)
    if bn is not None:
        for name, t in zip(("bn inv", "bn shift"), bn):
            _check(name, t, (cin,), torch.float32, dev)
    res_pitch = 0
    if residual is not None:
        residual, res_pitch = _rows("residual", residual, (B, T, cout), dev)
    plan = _plan_on(lengths, T, taps, dilation, cout, False, dev)
    lengths = _lengths_on(lengths, dev)
    y = padded_empty(B, T, cout, bf16, dev)
    _launch("masked_conv", "masked_conv_forward", "masked_conv_fwd", dev, xp.data_ptr(),
            layout.data_ptr(), bias.data_ptr(), _ptr(inv), _ptr(shift), _ptr(residual),
            lengths.data_ptr(), plan.data_ptr(), y.data_ptr(), B, T, cin, cout, xp.stride(1),
            y.stride(1), res_pitch, k_pad, n_pad, taps, dilation, plan.tiles, _num_sms(dev))
    return y


def masked_conv_f32_cuda(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                         lengths: torch.Tensor, dilation: int,
                         bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         residual: Optional[torch.Tensor] = None,
                         layout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``masked_conv_forward_f32``: :func:`masked_conv_cuda` in float32 on
    the tensor cores by the bf16x3 split.  ``x`` (B, T, C_in) at any row
    pitch (one that is not a multiple of 8 channels is copied into a padded
    buffer first), ``kernel`` (taps, C_in, C_out) (its pieces,
    :func:`conv_weight_layout_f32`, kept on it once a version; or only its
    shape, with ``layout`` the pieces), ``bias`` (C_out,), optional ``bn``
    (inv, shift) (C_in,) and ``residual`` (B, T, C_out), all float32;
    returns (B, T, C_out) at :func:`row_pitch` (C_out).  One launch of one
    persistent block an SM over the 128 x 112 plan; the blocks then write
    the rows it skips."""
    if x.device.type != "cuda":
        raise ValueError(f"masked_conv_forward_f32 needs CUDA tensors, not {x.device}")
    dev, f32 = x.device, torch.float32
    B, T, cin = x.shape
    taps, cout = kernel.shape[0], kernel.shape[2]
    if x.dtype != f32:
        raise ValueError(f"x must be float32, not {x.dtype}")
    if tuple(kernel.shape) != (taps, cin, cout):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not take x {tuple(x.shape)}")
    if layout is None:
        _check("kernel", kernel, (taps, cin, cout), f32, dev)
        layout = weight_layout(kernel, f32, dx=False)
    k_pad = -(-cin // F32_BLOCK_K) * F32_BLOCK_K
    n_pad = -(-cout // F32_BLOCK_N) * F32_BLOCK_N
    _check("weight pieces", layout, (3, taps, n_pad, k_pad), torch.bfloat16, dev)
    _check("bias", bias, (cout,), f32, dev)
    xp = pad_pitch(x)
    inv, shift = bn if bn is not None else (None, None)
    if bn is not None:
        for name, t in zip(("bn inv", "bn shift"), bn):
            _check(name, t, (cin,), f32, dev)
        # TMA reads the vectors a chunk at a time: they start on 16 bytes
        inv, shift = (t if t.data_ptr() % 16 == 0 else t.clone() for t in bn)
    res_pitch = 0
    if residual is not None:
        if residual.device != dev or residual.dtype != f32 or \
                tuple(residual.shape) != (B, T, cout):
            raise ValueError(f"residual must be float32 {(B, T, cout)} on {dev}, not "
                             f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")
        residual = pad_pitch(residual)
        res_pitch = residual.stride(1)
    plan = _plan_on(lengths, T, taps, dilation, cout, False, dev, F32_BLOCK_M, F32_BLOCK_N)
    lengths = _lengths_on(lengths, dev)
    y = padded_empty(B, T, cout, f32, dev)
    _launch("masked_conv_f32", "masked_conv_forward_f32", "masked_conv_fwd_f32", dev,
            xp.data_ptr(), layout.data_ptr(), bias.data_ptr(), _ptr(inv), _ptr(shift),
            _ptr(residual), lengths.data_ptr(), plan.data_ptr(), y.data_ptr(), B, T, cin, cout,
            xp.stride(1), y.stride(1), res_pitch, k_pad, n_pad, taps, dilation, plan.tiles,
            _num_sms(dev))
    return y


def masked_mean_pool_cuda(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``masked_mean_pool`` (bf16) or ``masked_mean_pool_f32`` (float32):
    (B, T, C) at any row pitch (16-byte loads where it is a multiple of 8
    channels, narrower ones otherwise; a tensor whose channels are not
    contiguous is copied) -> float32 (B, C).  One launch, no scratch, no
    read-back of the lengths."""
    idx = feats.get_device()  # an int (-1 on the CPU): no device object on the hot path
    if idx < 0:
        raise ValueError(f"masked_mean_pool needs CUDA tensors, not {feats.device}")
    if feats.dtype not in (torch.bfloat16, torch.float32) or feats.dim() != 3:
        raise ValueError(f"feats must be bf16 or float32 (B, T, C), not {feats.dtype} "
                         f"{tuple(feats.shape)}")
    B, T, C = feats.shape
    sb, pitch, sc = feats.stride()  # pitch_of's rule, inline: this is the hot path
    if (sc != 1 and C > 1) or pitch < C or (B > 1 and sb != T * pitch):
        feats, pitch = feats.contiguous(), C
    if lengths.dtype != torch.int32 or lengths.get_device() != idx or \
            not lengths.is_contiguous():
        lengths = _lengths_on(lengths, feats.device)
    out = feats.new_empty((B, C), dtype=torch.float32)
    name = "masked_mean_pool" if feats.dtype == torch.bfloat16 else "masked_mean_pool_f32"
    _launch("masked_pool", name, name, idx, feats.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, T, C, pitch)
    return out


def masked_mean_pool_backward_cuda(g: torch.Tensor, lengths: torch.Tensor, T: int,
                                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``masked_mean_pool_backward`` (bf16) or ``masked_mean_pool_backward_f32``
    (float32 ``dtype``): the pool's transpose (B, T, C) ``dtype`` at
    :func:`row_pitch` (C), padding channels 0, from float32 ``g`` (B, C),
    every row written once (the last conv's backward reads it as it is)."""
    dev = g.device
    if dev.type != "cuda" or g.dtype != torch.float32 or g.dim() != 2:
        raise ValueError(f"g must be float32 (B, C) on the card, not {g.dtype} "
                         f"{tuple(g.shape)} on {dev}")
    if not g.is_contiguous():
        g = g.contiguous()
    B, C = g.shape
    if row_pitch(C) > POOL_MAX_CHANNELS:
        raise ValueError(f"the pool kernels take at most {POOL_MAX_CHANNELS} channels, not {C}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the pool's transpose writes bfloat16 or float32, not {dtype}")
    f32 = dtype == torch.float32
    dx = padded_empty(B, T, C, dtype, dev)
    _launch("masked_pool", "masked_mean_pool_backward" + ("_f32" if f32 else ""),
            "masked_mean_pool_bwd" + ("_f32" if f32 else ""), dev, g.data_ptr(),
            _lengths_on(lengths, dev).data_ptr(), dx.data_ptr(), B, T, C, dx.stride(1))
    return dx


def masked_conv_dx_cuda(dy: torch.Tensor, kernel: torch.Tensor, lengths: torch.Tensor,
                        dilation: int, layout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``masked_conv_dx``: the input gradient (B, T, C_in) bf16 at
    :func:`row_pitch` (C_in) (its padding channels not written), where the
    BatchNorm's backward reads it, of a masked conv from its output gradient
    ``dy`` (B, T, C_out) (copied into a buffer at :func:`row_pitch` (C_out)
    unless it is at such a pitch) and ``kernel`` (taps, C_in, C_out) (or
    ``layout``, its dX layout)."""
    dev = dy.device
    B, T, cout = dy.shape
    taps, cin = kernel.shape[0], kernel.shape[1]
    if dy.dtype != torch.bfloat16:
        raise ValueError(f"dy must be bf16, not {dy.dtype}")
    if layout is None:
        _check("kernel", kernel, (taps, cin, cout), torch.bfloat16, dev)
        layout = conv_weight_layout(kernel, dx=True)
    n_pad, k_pad = -(-cin // BLOCK_N) * BLOCK_N, -(-cout // BLOCK_K) * BLOCK_K
    _check("weight layout", layout, (taps, n_pad, k_pad), torch.bfloat16, dev)
    dyp = pad_pitch(dy)
    plan = _plan_on(lengths, T, taps, dilation, cin, True, dev)
    lengths = _lengths_on(lengths, dev)
    dx = padded_empty(B, T, cin, torch.bfloat16, dev)
    _launch("masked_conv_bwd", "masked_conv_dx", "masked_conv_dx", dev, dyp.data_ptr(),
            layout.data_ptr(), lengths.data_ptr(), plan.data_ptr(), dx.data_ptr(), B, T, cin,
            cout, dyp.stride(1), dx.stride(1), k_pad, n_pad, taps, dilation, plan.tiles,
            _num_sms(dev))
    return dx


def masked_conv_dw_cuda(x: torch.Tensor, dy: torch.Tensor, lengths: torch.Tensor,
                        taps: int, dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_conv_dw``: ``(dW (taps, C_in, C_out), dbias (C_out,))`` bf16
    from the conv's input ``x`` (B, T, C_in) and output gradient ``dy``,
    each at any row pitch (one that is not a multiple of 8 is copied into a
    padded buffer first); the K steps of :func:`dw_step_plan`, kept on the
    lengths tensor."""
    B, T, cin = x.shape
    cout = dy.shape[2]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"masked_conv_dw needs CUDA tensors, not {dev}")
    for name, t, c in (("x", x, cin), ("dy", dy, cout)):
        if t.device != dev or t.dtype != torch.bfloat16 or tuple(t.shape) != (B, T, c):
            raise ValueError(f"{name} must be bf16 {(B, T, c)} on {dev}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    xp, dyp = pad_pitch(x), pad_pitch(dy)
    plan = _dw_plan_on(lengths, T, taps, dilation, cin, cout, dev)
    lengths = _lengths_on(lengths, dev)
    partial = (torch.empty(plan.splits, taps, cin, cout, dtype=torch.float32, device=dev)
               if plan.splits > 1 else None)
    bias_part = torch.empty(B, cout, dtype=torch.float32, device=dev)
    dw = torch.empty(taps, cin, cout, dtype=torch.bfloat16, device=dev)
    db = torch.empty(cout, dtype=torch.bfloat16, device=dev)
    _launch("masked_conv_bwd", "masked_conv_dw", "masked_conv_dw", dev, xp.data_ptr(),
            dyp.data_ptr(), lengths.data_ptr(), plan.data_ptr(), _ptr(partial),
            bias_part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, T, cin, cout, xp.stride(1),
            dyp.stride(1), taps, dilation, plan.splits, plan.items, _num_sms(dev))
    return dw, db


def masked_conv_dx_f32_cuda(dy: torch.Tensor, kernel: torch.Tensor, lengths: torch.Tensor,
                            dilation: int, layout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``masked_conv_dx_f32``: the input gradient (B, T, C_in) float32 at
    :func:`row_pitch` (C_in) (its padding channels not written), where the
    float32 BatchNorm's backward reads it, of a masked conv from its output
    gradient ``dy`` (B, T, C_out) float32 at any row pitch (one that is not
    a multiple of 8 is copied into a padded buffer first) and ``kernel``
    (taps, C_in, C_out) (its dX pieces, :func:`conv_weight_layout_f32` with
    ``dx``, kept on it once a version; or only its shape, with ``layout``
    the pieces).  One launch: the forward's kernel on the dX plan."""
    dev, f32 = dy.device, torch.float32
    if dev.type != "cuda":
        raise ValueError(f"masked_conv_dx_f32 needs CUDA tensors, not {dev}")
    B, T, cout = dy.shape
    taps, cin = kernel.shape[0], kernel.shape[1]
    if dy.dtype != f32:
        raise ValueError(f"dy must be float32, not {dy.dtype}")
    if tuple(kernel.shape) != (taps, cin, cout):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not take dy {tuple(dy.shape)}")
    if layout is None:
        _check("kernel", kernel, (taps, cin, cout), f32, dev)
        layout = weight_layout(kernel, f32, dx=True)
    k_pad = -(-cout // F32_BLOCK_K) * F32_BLOCK_K
    n_pad = -(-cin // F32_BLOCK_N) * F32_BLOCK_N
    _check("weight pieces", layout, (3, taps, n_pad, k_pad), torch.bfloat16, dev)
    dyp = pad_pitch(dy)
    plan = _plan_on(lengths, T, taps, dilation, cin, True, dev, F32_BLOCK_M, F32_BLOCK_N)
    lengths = _lengths_on(lengths, dev)
    dx = padded_empty(B, T, cin, f32, dev)
    _launch("masked_conv_f32", "masked_conv_dx_f32", "masked_conv_dx_f32", dev, dyp.data_ptr(),
            layout.data_ptr(), lengths.data_ptr(), plan.data_ptr(), dx.data_ptr(), B, T, cin,
            cout, dyp.stride(1), dx.stride(1), k_pad, n_pad, taps, dilation, plan.tiles,
            _num_sms(dev))
    return dx


def masked_conv_dw_f32_cuda(x: torch.Tensor, dy: torch.Tensor, lengths: torch.Tensor,
                            taps: int, dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_conv_dw_f32``: ``(dW (taps, C_in, C_out), dbias (C_out,))``
    float32 from the conv's input ``x`` (B, T, C_in) and output gradient
    ``dy``, both float32 at any row pitch (one that is not a multiple of 8
    is copied into a padded buffer first): dy's split into its three bf16
    pieces (a (3, B, T) scratch at :func:`row_pitch` (C_out)), then one
    persistent block an SM over the items of :func:`dw_step_plan` at the
    float32 kernel's tile, kept on the lengths tensor, then (with more than
    one split) the ordered sum of the splits and the dbias sums."""
    B, T, cin = x.shape
    cout = dy.shape[2]
    dev, f32 = x.device, torch.float32
    if dev.type != "cuda":
        raise ValueError(f"masked_conv_dw_f32 needs CUDA tensors, not {dev}")
    for name, t, c in (("x", x, cin), ("dy", dy, cout)):
        if t.device != dev or t.dtype != f32 or tuple(t.shape) != (B, T, c):
            raise ValueError(f"{name} must be float32 {(B, T, c)} on {dev}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    xp, dyp = pad_pitch(x), pad_pitch(dy)
    plan = _dw_plan_on(lengths, T, taps, dilation, cin, cout, dev, f32=True)
    lengths = _lengths_on(lengths, dev)
    partial = (torch.empty(plan.splits, taps, cin, cout, dtype=f32, device=dev)
               if plan.splits > 1 else None)
    pieces = torch.empty(3 * B * T * row_pitch(cout), dtype=torch.bfloat16, device=dev)
    bias_part = torch.empty(B, cout, dtype=f32, device=dev)
    dw = torch.empty(taps, cin, cout, dtype=f32, device=dev)
    db = torch.empty(cout, dtype=f32, device=dev)
    _launch("masked_conv_f32", "masked_conv_dw_f32", "masked_conv_dw_f32", dev, xp.data_ptr(),
            dyp.data_ptr(), pieces.data_ptr(), lengths.data_ptr(), plan.data_ptr(),
            _ptr(partial), bias_part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, T, cin, cout,
            xp.stride(1), dyp.stride(1), taps, dilation, plan.splits, plan.items, _num_sms(dev))
    return dw, db


BN_SLICE = 64  # channels of a BN block's column slice (csrc/masked_bn.cu GROUP)
BN_MAX_B = 1024  # sequences of the statistics kernel's table (MAX_B)
BN_SUM_BLOCKS_PER_SM = 2  # the statistics' and gradient sums' blocks an SM
BN_MAX_CHUNKS = 32  # chunks a block combines (csrc/masked_bn.cu SPLIT * TAIL)
BN_APPLY_ROWS = 256  # rows of an apply or dx block


class BNPlan(NamedTuple):
    """The K7-BN kernels' grids for R rows of C channels: ``slices`` column
    slices of 64 channels (blockIdx.x of every kernel); the statistics'
    ``stat_chunks`` equal runs of the valid rows (split on the card, where
    the lengths are); the gradient sums' chunks of ``sum_rows`` rows
    (``sum_chunks`` of them); the apply's ``apply_chunks`` of
    ``apply_rows`` rows, dx's ``apply_rows`` a block from the end of each
    sums chunk."""
    slices: int
    stat_chunks: int
    sum_rows: int
    sum_chunks: int
    apply_rows: int
    apply_chunks: int


def chunk_ranges(n: int, chunks: int) -> list:
    """``[start, end)`` of each of ``chunks`` runs over ``n`` rows, as the
    kernels cut them: ``per = ceil(n / chunks)`` rows a run, the last runs
    empty where ``chunks * per`` passes ``n``."""
    per = -(-n // chunks)
    return [(min(k * per, n), min(k * per + per, n)) for k in range(chunks)]


@functools.lru_cache(maxsize=None)
def bn_plan(rows: int, channels: int, sms: int = _H100_SMS) -> BNPlan:
    """The grids of ``masked_bn_relu_forward`` / ``_backward`` (see
    :class:`BNPlan`): about ``BN_SUM_BLOCKS_PER_SM`` blocks an SM for the
    passes whose chunks the next kernel's blocks combine (the fewer chunks,
    the less each block reads; ``BN_MAX_CHUNKS`` at most), ``BN_APPLY_ROWS``
    rows a block for the elementwise passes."""
    slices = -(-channels // BN_SLICE)
    chunks = max(1, min(BN_MAX_CHUNKS, BN_SUM_BLOCKS_PER_SM * sms // slices))
    sum_rows = max(1, -(-rows // chunks))
    return BNPlan(slices, chunks, sum_rows, -(-rows // sum_rows), BN_APPLY_ROWS,
                  -(-rows // BN_APPLY_ROWS))


def _em_on(example_mask: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if example_mask is None or (example_mask.dtype == torch.float32
                                and example_mask.device == device
                                and example_mask.is_contiguous()):
        return example_mask
    return example_mask.to(device=device, dtype=torch.float32).contiguous()


def _bn_activation(name: str, t: torch.Tensor, shape, device,
                   dtype: torch.dtype) -> torch.Tensor:
    """A ``dtype`` (bf16 or float32) ``(B, T, C)`` activation as the BN
    kernels read it: ``t`` itself at a pitch of 8 channels with rows on 16
    bytes whose storage holds the last row's padding (the chain's,
    :func:`padded_empty`), else a copy at :func:`row_pitch` (C)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {device}, not {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    t = pad_pitch(t)
    B, T, C = t.shape
    if t.storage_offset() + (B * T - 1) * t.stride(1) + row_pitch(C) > \
            t.untyped_storage().nbytes() // t.element_size():
        # a pitch of 8 whose storage ends at the last row's C-th channel
        out = padded_empty(B, T, C, t.dtype, t.device)
        out.copy_(t)
        t = out
    return t


def _bn_suffix(B: int, dtype: torch.dtype) -> str:
    """The BN entry points' suffix for ``dtype`` ("" for bf16, "_f32"),
    after checking the batch and the dtype the kernels take."""
    if B > BN_MAX_B:
        raise ValueError(f"the BN kernels take at most {BN_MAX_B} sequences, not {B}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the BN kernels take bfloat16 or float32, not {dtype}")
    return "_f32" if dtype == torch.float32 else ""


def _f32_vector(name: str, t: torch.Tensor, C: int, device) -> torch.Tensor:
    """A (C,) float32 contiguous vector on ``device``: ``t`` itself where it
    is one (the wrappers' common case, checked without a copy), else its
    cast."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.detach().to(torch.float32).contiguous()
    if t.shape != (C,) or t.device != device:
        raise ValueError(f"{name} must be ({C},) on {device}, not {tuple(t.shape)} on {t.device}")
    return t


def bn_kernels_launched() -> int:
    """The kernels ``masked_bn_relu_forward`` and ``_backward`` have launched
    in this process, counted in the C library (two a call)."""
    from protnote_tpu_torch.ops.kernels import kernel_function

    key = ("masked_bn", "masked_bn_kernels_launched")
    return kernel_function(*key, _ARGS[key])()


def masked_bn_relu_forward_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                run_mean: torch.Tensor, run_var: torch.Tensor,
                                lengths: torch.Tensor, example_mask: Optional[torch.Tensor],
                                eps: float, momentum: float):
    """``masked_bn_relu_forward`` (bf16 x) or ``masked_bn_relu_forward_f32``
    (float32 x): ``(y, new_mean, new_var, stats, counts)``, y in x's dtype
    at :func:`row_pitch` (C) (padding channels 0), ``stats`` (5, C) =
    mean, var, rstd, inv, shift and ``counts`` (2,) = n, n_valid (float32),
    for the backward.  x at any row pitch (copied unless the pitch is a
    multiple of 8).  The statistics, running statistics, counts and the
    statistics kernel's partials share one allocation (the first four are
    views of it); two launches."""
    B, T, C = x.shape
    dev = x.device
    sfx = _bn_suffix(B, x.dtype)
    xp = _bn_activation("x", x, (B, T, C), dev, x.dtype)
    vec = [_f32_vector(n, t, C, dev) for n, t in (("scale", scale), ("bias", bias),
                                                  ("running mean", run_mean),
                                                  ("running var", run_var))]
    lengths = _lengths_on(lengths, dev)
    em = _em_on(example_mask, dev)
    plan = bn_plan(B * T, C, _num_sms(dev))
    k = plan.stat_chunks
    scratch = torch.empty(7 * C + 2 + k * (plan.slices + 2 * C), dtype=torch.float32, device=dev)
    stats, new_mean, new_var, counts, _ = scratch.split_with_sizes(
        (5 * C, C, C, 2, k * (plan.slices + 2 * C)))
    base = scratch.data_ptr()
    chunk_n = base + 4 * (7 * C + 2)  # (slices, chunks), then part (chunks, 2, C)
    y = padded_empty(B, T, C, x.dtype, dev)
    _launch("masked_bn", "masked_bn_relu_forward" + sfx, "masked_bn_relu_fwd" + sfx, dev,
            xp.data_ptr(), xp.stride(1), lengths.data_ptr(), _ptr(em), *[t.data_ptr() for t in vec],
            float(momentum), float(1.0 - momentum), float(eps), chunk_n + 4 * k * plan.slices,
            chunk_n, counts.data_ptr(), base, new_mean.data_ptr(), new_var.data_ptr(),
            y.data_ptr(), B, T, C, k, plan.apply_rows)
    return y, new_mean, new_var, stats.view(5, C), counts


def masked_bn_relu_backward_cuda(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                 stats: torch.Tensor, counts: torch.Tensor,
                                 lengths: torch.Tensor, example_mask: Optional[torch.Tensor]):
    """``masked_bn_relu_backward`` (bf16) or ``_f32`` (float32): ``(dx in x's
    dtype at`` :func:`row_pitch` ``(C), dscale, dbias float32)`` from x and
    dy of one dtype at any row pitch (each copied
    unless its pitch is a multiple of 8) and the forward's ``stats`` and
    ``counts``; the ReLU's gate is recomputed from x, y is not read.  dscale,
    dbias and the gradient sums' partials share one allocation; two
    launches."""
    B, T, C = x.shape
    dev = x.device
    sfx = _bn_suffix(B, x.dtype)
    xp = _bn_activation("x", x, (B, T, C), dev, x.dtype)
    dyp = _bn_activation("dy", dy, (B, T, C), dev, x.dtype)
    scale = _f32_vector("scale", scale, C, dev)
    _check("stats", stats, (5, C), torch.float32, dev)
    _check("counts", counts, (2,), torch.float32, dev)
    lengths = _lengths_on(lengths, dev)
    em = _em_on(example_mask, dev)
    plan = bn_plan(B * T, C, _num_sms(dev))
    scratch = torch.empty((2 + 2 * plan.sum_chunks) * C, dtype=torch.float32, device=dev)
    dscale, dbias, _ = scratch.split_with_sizes((C, C, 2 * plan.sum_chunks * C))
    base = scratch.data_ptr()  # dscale, dbias, part (chunks, 2, C)
    dx = padded_empty(B, T, C, x.dtype, dev)
    _launch("masked_bn", "masked_bn_relu_backward" + sfx, "masked_bn_relu_bwd" + sfx, dev,
            xp.data_ptr(), xp.stride(1), dyp.data_ptr(), dyp.stride(1), lengths.data_ptr(),
            _ptr(em), scale.data_ptr(), stats.data_ptr(), counts.data_ptr(), base + 8 * C, base,
            base + 4 * C, dx.data_ptr(), B, T, C, plan.sum_rows, plan.apply_rows)
    return dx, dscale, dbias


# ----------------------------------------------------------------------
# autograd


class _MaskedConv(torch.autograd.Function):
    # The weights are laid out once a step, the version each step trains: for
    # the forward here, for dX in the backward (bf16: a new cast; float32: W's
    # pieces), and not kept on the tensor, which the optimizer changes before
    # they would be read again; kept, a float32 chain's pieces (0.36 GiB at
    # the default width) would stay resident through the scorer's backward,
    # where a float32 encoder-training step runs out of memory on an 80 GB
    # card.  The input is saved at the padded pitch (the copy the forward
    # reads anyway) and dy is copied to it once, for dX and dW, which both
    # read them at that pitch.  bf16 tensors take the bf16 kernels, float32
    # ones the bf16x3 split kernels.
    @staticmethod
    def forward(ctx, x, kernel, bias, residual, lengths, dilation):
        x = pad_pitch(x)
        ctx.save_for_backward(x, kernel, lengths)
        ctx.dilation = dilation
        if x.dtype == torch.float32:
            return masked_conv_f32_cuda(x, kernel, bias, lengths, dilation, residual=residual,
                                        layout=conv_weight_layout_f32(kernel.detach()))
        return masked_conv_cuda(x, kernel, bias, lengths, dilation, residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, kernel, lengths = ctx.saved_tensors
        f32 = x.dtype == torch.float32
        dx = dw = db = None
        dy = pad_pitch(g)
        if ctx.needs_input_grad[0]:
            dx = (masked_conv_dx_f32_cuda(dy, kernel, lengths, ctx.dilation,
                                          layout=conv_weight_layout_f32(kernel, dx=True))
                  if f32 else masked_conv_dx_cuda(dy, kernel, lengths, ctx.dilation))
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = (masked_conv_dw_f32_cuda if f32 else masked_conv_dw_cuda)(
                x, dy, lengths, kernel.shape[0], ctx.dilation)
        return dx, dw, db, (g if ctx.needs_input_grad[3] else None), None, None


class _MaskedBNRelu(torch.autograd.Function):
    # x is saved as the kernels read it (the chain's conv output is, with
    # no copy); y is not saved: the backward recomputes the ReLU's gate
    # from x.  The wrappers pick the bf16 or float32 kernels by x's dtype.
    @staticmethod
    def forward(ctx, x, scale, bias, run_mean, run_var, lengths, example_mask, eps, momentum):
        x = _bn_activation("x", x, x.shape, x.device, x.dtype)
        y, new_mean, new_var, stats, counts = masked_bn_relu_forward_cuda(
            x, scale, bias, run_mean, run_var, lengths, example_mask, eps, momentum)
        ctx.save_for_backward(x, scale, stats, counts, lengths, example_mask)
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        x, scale, stats, counts, lengths, example_mask = ctx.saved_tensors
        dx, dscale, dbias = masked_bn_relu_backward_cuda(x, g, scale, stats, counts, lengths,
                                                         example_mask)
        return dx, dscale, dbias, None, None, None, None, None, None


class _MaskedPool(torch.autograd.Function):
    # The pool and its transpose: the kernels on the card (bf16 or float32
    # by the activation's dtype), the plain versions on the CPU.  On the
    # card the gradient comes at the padded pitch, which the last conv's
    # backward takes without a copy.
    @staticmethod
    def forward(ctx, feats, lengths):
        ctx.save_for_backward(lengths)
        ctx.T, ctx.dtype = feats.shape[1], feats.dtype
        if feats.device.type == "cpu":
            return masked_mean_pool_reference(feats, lengths)
        return masked_mean_pool_cuda(feats, lengths)

    @staticmethod
    def backward(ctx, g):
        (lengths,) = ctx.saved_tensors
        if g.device.type == "cpu":
            return masked_mean_pool_backward_reference(g, lengths, ctx.T, ctx.dtype), None
        return masked_mean_pool_backward_cuda(g, lengths, ctx.T, ctx.dtype), None


# ----------------------------------------------------------------------
# dispatch


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def masked_conv(x: torch.Tensor, p: Params, lengths: torch.Tensor, dilation: int,
                bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One masked conv of the encoder with the parameters ``p`` (``kernel``
    (taps, C_in, C_out), ``bias``), in ``x``'s dtype: the plain version on
    the CPU, ``masked_conv_forward`` on the card (``masked_conv_forward_f32``
    for float32 ``x``; its backward kernels when a gradient is wanted,
    without one the weights' layout cached on the kernel tensor).  ``bn`` is
    eval mode only.  The result's rows lie
    :func:`row_pitch` (C_out) apart on both (the CPU copies the plain
    version's); on the card pass ``lengths`` as an int32 tensor there, the
    same tensor to every conv of a chain, so that its plans are built
    once."""
    if x.device.type == "cpu":
        return pad_pitch(masked_conv_reference(x, p["kernel"], p["bias"], lengths, dilation, bn,
                                               residual))
    if x.device.type != "cuda":
        raise ValueError(f"no masked conv for device {x.device}")
    check_compute_dtype(x.dtype)
    if _wants_grad(x, p["kernel"], p["bias"], residual):
        if bn is not None:
            raise ValueError("the conv's BatchNorm prologue is eval mode: no gradient")
        return _MaskedConv.apply(x, p["kernel"].to(x.dtype).contiguous(), p["bias"].to(x.dtype),
                                 residual, lengths, dilation)
    conv = masked_conv_f32_cuda if x.dtype == torch.float32 else masked_conv_cuda
    bias = _cached(p["bias"], ("cast", x.dtype), lambda: p["bias"].detach().to(x.dtype))
    return conv(x, p["kernel"], bias, lengths, dilation, bn, residual,
                layout=weight_layout(p["kernel"], x.dtype, dx=False))


def masked_bn_relu_train(x: torch.Tensor, p: Params, s: Params, lengths: torch.Tensor,
                         example_mask: Optional[torch.Tensor], eps: float,
                         momentum: float) -> Tuple[torch.Tensor, Params]:
    """``(relu(BN(x)), new_state)``, train-mode masked BN under the count
    rule: the plain version on the CPU, the K7-BN kernels (bf16 or float32)
    on the card.  x at
    any row pitch; the result's rows lie :func:`row_pitch` (C) apart on both
    (the CPU copies the plain version's), where the next conv reads them."""
    if x.device.type == "cpu":
        y, new_state = masked_bn_relu_reference(x, p, s, lengths, example_mask, eps, momentum)
        return pad_pitch(y), new_state
    if x.device.type != "cuda":
        raise ValueError(f"no masked BatchNorm for device {x.device}")
    check_compute_dtype(x.dtype)
    lengths = _lengths_on(lengths, x.device)
    em = _em_on(example_mask, x.device)
    if _wants_grad(x, p["scale"], p["bias"]):
        y, mean, var = _MaskedBNRelu.apply(x, p["scale"], p["bias"], s["mean"], s["var"],
                                           lengths, em, eps, momentum)
    else:
        y, mean, var, _, _ = masked_bn_relu_forward_cuda(
            x, p["scale"], p["bias"], s["mean"], s["var"], lengths, em, eps, momentum)
    return y, {"mean": mean.to(s["mean"].dtype), "var": var.to(s["var"].dtype)}


def masked_mean_pool(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 masked mean pool: the plain version on the CPU,
    ``masked_mean_pool`` (``masked_mean_pool_f32`` for float32) on the card;
    when a gradient is wanted, through :class:`_MaskedPool` (the plain
    transpose on the CPU, ``masked_mean_pool_backward`` or its ``_f32`` form
    on the card)."""
    if feats.device.type == "cpu":
        if _wants_grad(feats):
            return _MaskedPool.apply(feats, lengths)
        return masked_mean_pool_reference(feats, lengths)
    if feats.device.type != "cuda":
        raise ValueError(f"no masked pool for device {feats.device}")
    check_compute_dtype(feats.dtype)
    if _wants_grad(feats):
        return _MaskedPool.apply(feats, _lengths_on(lengths, feats.device))
    return masked_mean_pool_cuda(feats, lengths)
