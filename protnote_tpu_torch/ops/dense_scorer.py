"""The materialised dense pair scorer: every (sequence, label) pair row
through the output MLP, with train-mode BatchNorm over all pairs, dropout and
the no-BatchNorm bias form.

Port of ``protnote_tpu/ops/pair_scorer.py:pair_logits_dense`` (with its
``output_mlp_apply`` and ``joint_embeddings``), the scorer the JAX dispatch
(``models/fusion.py``) takes for ``PAIR_BACKEND=dense``, for ``tiled`` in
training without a label tile, for ``OUTPUT_MLP_DROPOUT > 0``, for training
without output-MLP BatchNorm and for ``concatenation_prod``.

The joint embedding ``concat(p, l[, p - l | p * l])`` is never built: the
first layer's product is the sum of per-side products, ``z1 = bf16(a[b] +
c[l] (+ (p[b] * l[l]) @ W_prod))`` with ``a = P_e @ W1_p`` and ``c = L_e @
W1_l`` (the diff block folded into both), one bf16 rounding of the float32
sum that the JAX chain rounds once in another order.  Each later layer is the
JAX chain: a bf16 product, train-mode BatchNorm with centred masked moments
(or the bf16 bias add), ReLU and dropout.

Hand-written kernels carry the (B * L, H) tensors on the card:

* :func:`pair_first_layer`: the broadcast sum ``a[b] + c[l]``
  (``csrc/pair_dense.cu:pair_first_add``), and for ``concatenation_prod``
  K4's mainloop with its A operand ``bf16(p[b] * l[l])`` formed in registers
  and ``a[b] + c[l]`` added in its epilogue (``csrc/pair_train.cu:
  pair_train_prod``).  Its backward reduces dz1 to ``sum_l dz1`` and ``sum_b
  dz1`` (``pair_side_sums``), and for the prod block forms ``dW_prod`` on
  K4-bwd's dW mainloop (``csrc/pair_train_bwd.cu:pair_train_dw_prod``) and
  reduces ``dJ = dz1 @ W_prod^T`` against the other side's rows
  (``pair_side_sums``, weighted).  Every sum runs in a fixed order.
* :func:`bn_relu_dropout` and :func:`bias_relu_dropout` (K5, ``csrc/
  bn_relu.cu``): masked BN or the bias add, ReLU and dropout as one output.
  The BN forward takes the centred moments in one read of z (register tiles
  of 8 rows, each tile's own centred statistics merged by Chan's formula in
  a fixed order: :func:`dense_moments_emulation`), then writes y: z read
  twice, y written.  Its backward (column sums, then dz) reads z and dy
  twice and writes dz, regenerating the keep mask in each pass instead of
  storing it.

The keep mask is a counter hash of (seed, layer, row, column)
(:func:`keep_mask`): the seed is drawn once a step from the step's
``torch.Generator``, and the plain version computes the same bits with
integer tensor operations, so the kernels are held to it bit for bit.

Evaluation (``PAIR_BACKEND=dense``, ``train=False``) runs the chain in label
chunks (pair rows are independent there), its BatchNorm from the running
statistics through K6's ``affine_relu``.

In float32 (``MIXED_PRECISION False``) each kernel has its float32 form,
named with ``_f32``: nothing is rounded to bf16, a kept dropout element is
the true float32 quotient, and the prod block's GEMMs run on the float32
split of ``csrc/pair_scorer_f32.cu`` (``pair_train_prod_f32``) and
``csrc/pair_train_bwd_f32.cu`` (``pair_train_dw_prod_f32``).

The hidden H x H products and the output linear are ``torch.matmul`` on the
materialised activations, as JAX computes them.  For tensors on the CPU each
wrapper runs its plain version; for CUDA tensors it launches its kernel or
raises (no fallback).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch

from protnote_tpu_torch.models.layers import Params, gemm_precision, linear
from protnote_tpu_torch.ops.pair_scorer import _block_n, _f32_product, stacked_pieces
from protnote_tpu_torch.ops.streaming_train import (
    BN_EPS,
    F32_TILE,
    _BN_COLS,
    _affine,
    _bn_relu_grads,
    _check_bn_cuda,
    _chunks,
    _masked_moments,
    _raise_on,
    _symbol,
    _update_running,
    affine_relu,
    affine_relu_reference,
    pair_dw_plan,
    pair_train_f32_plan,
)

# the kernels' entry points (each with its float32 form, ``_f32``)
KERNELS = ("pair_first_add", "pair_train_prod", "pair_side_sums", "pair_train_dw_prod",
           "bn_relu_dropout_forward", "bn_relu_dropout_backward", "bias_relu_dropout_forward",
           "bias_relu_dropout_backward")
# Launches of each kernel entry point since the process started (or since a
# caller last set them to 0): one a wrapper call.
LAUNCHES = {k: 0 for k in KERNELS + tuple(f"{k}_f32" for k in KERNELS)}
_launch_lock = threading.Lock()

# pair rows of an evaluation chunk (B x labels): a (rows, H) bf16 tensor is
# 403 MB at H 3072
EVAL_CHUNK_ROWS = 65536


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


# ----------------------------------------------------------------------
# the dropout keep mask: a counter hash of (seed, layer, row, column)

_M32 = 0xFFFFFFFF
KEEP_BITS = 24  # a row-column's 24-bit draw is compared with round(keep * 2^24)
_GOLDEN, _ROW_MUL, _COL_MUL = 0x9E3779B1, 0x9E3779B1, 0x85EBCA77


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): two products below
    2^48, so no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 tensors holding uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(rate: float) -> int:
    """A draw below this keeps its element: ``round((1 - rate) * 2^24)``."""
    return int(round((1.0 - rate) * (1 << KEEP_BITS)))


def keep_mask(seed: torch.Tensor, layer: int, rate: float, rows: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
    """The keep mask of dropout layer ``layer`` at (``rows`` (N, 1), ``cols``
    (1, H)) int64 indices: ``seed`` (2,) int64 words in [0, 2^31).  The
    kernels (``csrc/bn_relu.cu:keep_bit``) compute the same bits:

        k0 = fmix(seed[0] ^ (layer + 1) * GOLDEN)
        k1 = fmix((seed[1] + k0) mod 2^32)
        h = fmix(fmix(row * ROW_MUL ^ k0) ^ col * COL_MUL ^ k1)
        keep = (h >> 8) < round((1 - rate) * 2^24)
    """
    s = seed.to(torch.int64) & _M32
    k0 = _fmix32(s[0] ^ ((layer + 1) * _GOLDEN & _M32))
    k1 = _fmix32((s[1] + k0) & _M32)
    h = _fmix32(_mul32(rows.to(torch.int64), _ROW_MUL) ^ k0)
    h = _fmix32(h ^ _mul32(cols.to(torch.int64), _COL_MUL) ^ k1)
    return (h >> (32 - KEEP_BITS)) < keep_threshold(rate)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """A step's dropout seed: two int64 words in [0, 2^31) drawn from
    ``generator``, on its device (no host sync on the card)."""
    return torch.randint(0, 2**31 - 1, (2,), generator=generator, device=generator.device,
                         dtype=torch.int64)


def keep_scale(rate: float, dtype: torch.dtype) -> float:
    """The divisor of a kept element: ``1 - rate`` rounded to the compute
    dtype, as JAX casts the weak-typed Python scalar of ``x / keep``."""
    return float(torch.tensor(1.0 - rate, dtype=dtype).float())


def _drop_plain(y: torch.Tensor, seed, layer: int, rate: float, col0: int = 0) -> torch.Tensor:
    """``where(keep, bf16(y / keep), 0)`` in y's dtype (the JAX dropout);
    also the transpose of itself (dropout is linear in y).  ``col0``: the
    column of y's first column in the full tensor (a column slice)."""
    if rate <= 0:
        return y
    N, H = y.shape
    dev = y.device
    keep = keep_mask(seed, layer, rate, torch.arange(N, device=dev)[:, None],
                     torch.arange(col0, col0 + H, device=dev)[None, :])
    # a division by a device tensor: on CUDA, PyTorch multiplies by the
    # reciprocal of a Python number instead
    kept = (y.float() / torch.tensor(keep_scale(rate, y.dtype), device=dev)).to(y.dtype)
    return torch.where(keep, kept, torch.zeros((), dtype=y.dtype, device=dev))


def _drop_args(seed: Optional[torch.Tensor], rate: float, device) -> Tuple[torch.Tensor, int]:
    """The seed tensor and threshold a kernel takes (rate 0: a threshold
    past every draw, so nothing is dropped)."""
    if rate <= 0:
        return torch.zeros(2, dtype=torch.int64, device=device), 1 << KEEP_BITS
    if seed is None or seed.numel() != 2 or seed.device != device:
        raise ValueError("dropout needs a (2,) int64 seed on the pre-activations' device")
    return seed.to(torch.int64).contiguous(), keep_threshold(rate)


# ----------------------------------------------------------------------
# K5 with dropout: masked BN (centred moments) + ReLU + dropout


def _bn_relu_dropout_fwd_plain(z, rows, n, scale, bias, seed, layer, rate, col0=0):
    """``(y, mean, var, istd, inv, shift)``: y = dropout(bf16(relu(f32(z) *
    inv + shift))), with the JAX dense BatchNorm's centred masked moments
    (``mean = sum(z * m) / n``, ``var = sum((z - mean)^2 * m) / n``)."""
    mean, var, _ = _masked_moments(z, rows)
    inv, shift = _affine(scale, bias, mean, var)
    istd = torch.rsqrt(var + BN_EPS)
    y = torch.relu(z.float() * inv + shift).to(z.dtype)
    return _drop_plain(y, seed, layer, rate, col0), mean, var, istd, inv, shift


def _bn_relu_dropout_grads_plain(z, dy, rows, n, scale, mean, istd, inv, shift, seed, layer,
                                 rate, col0=0):
    """``(dz, dscale, dbias)``: dy through dropout's transpose (the mask
    regenerated), then K5's two-pass BN + ReLU backward."""
    dy = _drop_plain(dy.to(z.dtype), seed, layer, rate, col0)
    return _bn_relu_grads(z, dy, rows, n, scale, mean, istd, inv, shift)


# the forward's moment kernel: rows of a lane's register tile, warps of a
# block, the tail's lanes a column (csrc/bn_relu.cu MOM_ROWS, TAIL_LANES;
# csrc/bn_columns.cuh RED_WARPS)
MOM_ROWS, RED_WARPS, TAIL_LANES = 8, 8, 16


def _two_sum(a, b):
    """``csrc/bn_relu.cu:two_sum``: ``(s, e)``, s = a + b rounded and s + e
    = a + b exactly."""
    s = a + b
    v = s - a
    return s, (a - (s - v)) + (b - v)


def _chan_merge(na, nb, d, m2b, hi, lo, m2):
    """``csrc/bn_relu.cu:chan_merge`` on float32 tensors, each operation
    rounded on its own, with a = nb / (na + nb) and b = na a: the state
    (na; hi, lo, m2) with a part of count nb, mean (hi + lo) + d and M2 m2b
    merged in; ``(hi, lo, m2)``."""
    a = nb / (na + nb)
    b = na * a
    s, e = _two_sum(hi, d * a)
    return s, lo + e, (m2 + m2b) + (d * d) * b


def _merge_state(na, hi, lo, m2, nb, hb, lb, mb):
    """``csrc/bn_relu.cu:merge_state``: (nb; hb, lb, mb) merged into (na;
    hi, lo, m2), an empty part skipped, an empty state replaced."""
    merged = _chan_merge(na, nb, (hb - hi) + (lb - lo), mb, hi, lo, m2)
    skip, take = nb == 0, (na == 0) & (nb != 0)
    return (torch.where(skip, na, na + nb),
            *(torch.where(skip, old, torch.where(take, part, new))
              for old, part, new in zip((hi, lo, m2), (hb, lb, mb), merged)))


def dense_moments_emulation(z: torch.Tensor, rows: torch.Tensor,
                            n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean, var)`` (H,) float32 as ``bn_relu_dropout_forward``'s moment
    kernel and tail compute them, the same float32 operations in the same
    order, on any device: the row chunks of :func:`_chunks`; in each, warp
    w's tile k holds rows ``first + (k * RED_WARPS + w) * MOM_ROWS`` and
    the next MOM_ROWS - 1 (past the chunk: mask 0); a lane's first tile
    with a valid row, centred about that row, is its state, and each later
    tile, centred about the lane's ``hi``, merges in by Chan's formula (a
    tile with no valid row skipped); the warps' states merged in warp order;
    the tail's lane j merging chunks j, j + TAIL_LANES, ... in order, then
    lane j merging lane j + h for h = TAIL_LANES / 2, ..., 1; mean = hi +
    lo, var = M2 / n.  Vectorised over the columns and over the lanes that
    run the same steps."""
    f32 = torch.float32
    dev = z.device
    z, rows = z.to(f32), rows.to(f32).reshape(-1)
    N, H = z.shape
    chunks, per = _chunks(N)
    W, R = RED_WARPS, MOM_ROWS
    zero = torch.zeros((), dtype=f32, device=dev)
    cnt = torch.zeros(chunks, W, 1, dtype=f32, device=dev)
    hi, lo, m2 = (torch.zeros(chunks, W, H, dtype=f32, device=dev) for _ in range(3))
    first = torch.arange(chunks, device=dev)[:, None, None] * per
    last = torch.clamp(first + per, max=N)
    for k in range(-(-per // (W * R))):
        r = first + (k * W + torch.arange(W, device=dev)[None, :, None]) * R + \
            torch.arange(R, device=dev)[None, None, :]
        inside = r < last
        r = torch.where(inside, r, torch.zeros_like(r))
        m = torch.where(inside, rows[r], zero)  # (chunks, W, R)
        u = torch.where(inside[..., None], z[r], zero)  # (chunks, W, R, H)
        w = zero
        for i in range(R):
            w = w + m[..., i : i + 1]
        p = zero
        for i in reversed(range(R)):
            p = torch.where(m[..., i : i + 1] != 0, u[..., i, :], p)
        fresh = cnt == 0
        p = torch.where(fresh, p, hi)
        u = u - p[:, :, None, :]
        total = zero
        for i in range(R):
            total = total + m[..., i : i + 1] * u[..., i, :]
        c = total * (1.0 / w)
        q = zero
        for i in range(R):
            v = u[..., i, :] - c
            q = q + (v * v) * m[..., i : i + 1]
        h, l, mm = _chan_merge(cnt, w, c - lo, q, hi, lo, m2)
        h, l, mm = (torch.where(fresh, init, merged)
                    for init, merged in zip((*_two_sum(p, c), q), (h, l, mm)))
        live = w != 0
        hi, lo, m2 = (torch.where(live, new, old) for new, old in ((h, hi), (l, lo), (mm, m2)))
        cnt = torch.where(live, cnt + w, cnt)
    state = (cnt[:, 0], hi[:, 0], lo[:, 0], m2[:, 0])
    for j in range(1, W):
        state = _merge_state(*state, cnt[:, j], hi[:, j], lo[:, j], m2[:, j])
    # the tail: chunk k to lane k % TAIL_LANES, padded with empty chunks
    pad = -chunks % TAIL_LANES
    bn, bh, bl, bm = (torch.cat([t, torch.zeros(pad, *t.shape[1:], dtype=f32, device=dev)])
                      .reshape(-1, TAIL_LANES, *t.shape[1:]) for t in state)
    lanes = (bn[0], bh[0], bl[0], bm[0])
    for k in range(1, bn.shape[0]):
        lanes = _merge_state(*lanes, bn[k], bh[k], bl[k], bm[k])
    h = TAIL_LANES // 2
    while h:
        lanes = tuple(torch.cat([x, y[h:]]) for x, y in
                      zip(_merge_state(*(t[:h] for t in lanes), *(t[h : 2 * h] for t in lanes)),
                          lanes))
        h //= 2
    return lanes[1][0] + lanes[2][0], \
        lanes[3][0] / torch.as_tensor(n, dtype=f32, device=dev).reshape(())


def _bias_relu_dropout_fwd_plain(z, bias, seed, layer, rate, col0=0):
    """``dropout(relu(bf16(z + bias)))`` in z's dtype (the JAX ``linear``'s
    bias added in the compute dtype, then ReLU)."""
    h = (z.float() + bias.to(z.dtype).float()).to(z.dtype)
    return _drop_plain(torch.relu(h), seed, layer, rate, col0)


def _bias_relu_dropout_grads_plain(z, dy, bias, seed, layer, rate, col0=0):
    """``(dz, dbias)``: the gate is ``bf16(z + bias) > 0``; dbias the float32
    column sum of dz."""
    h = (z.float() + bias.to(z.dtype).float()).to(z.dtype)
    g = _drop_plain(dy.to(z.dtype), seed, layer, rate, col0)
    dz = torch.where(h > 0, g, torch.zeros((), dtype=z.dtype, device=z.device))
    return dz, dz.float().sum(0)


_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# the ctypes signatures of the dense scorer's entry points
SIGNATURES = {
    ("bn_relu", "bn_relu_dropout_forward"): [_P] * 13 + [_LL, _I, _I, _LL, _I, _I, _F, _P],
    ("bn_relu", "bn_relu_dropout_backward"): [_P] * 15 + [_LL, _I, _I, _LL, _I, _I, _F, _P],
    ("bn_relu", "bias_relu_dropout_forward"): [_P] * 4 + [_LL, _I, _I, _I, _F, _P],
    ("bn_relu", "bias_relu_dropout_backward"): [_P] * 7 + [_LL, _I, _I, _LL, _I, _I, _F, _P],
    ("pair_dense", "pair_first_add"): [_P] * 3 + [_I] * 3 + [_P],
    ("pair_dense", "pair_side_sums"): [_P] * 6 + [_I] * 4 + [_LL, _P],
    ("pair_train", "pair_train_prod"): [_P] * 6 + [_I] * 8 + [_P],
    ("pair_train_bwd", "pair_train_dw_prod"): [_P] * 5 + [_I] * 8 + [_P],
}
# the float32 forms: K5's and the first layer's in the same libraries, the
# prod GEMMs' in the float32 K4 libraries
SIGNATURES.update({(lib, f"{sym}_f32"): sig for (lib, sym), sig in list(SIGNATURES.items())
                   if lib in ("bn_relu", "pair_dense")})
SIGNATURES.update({
    ("pair_scorer_f32", "pair_train_prod_f32"): [_P] * 6 + [_I] * 5 + [_P],
    ("pair_train_bwd_f32", "pair_train_dw_prod_f32"): [_P] * 5 + [_I] * 7 + [_P],
})


def _launch(library: str, symbol: str, device, *args) -> None:
    """One C entry point on ``device``'s current stream, counted."""
    from protnote_tpu_torch.ops.kernels import kernel_function

    fn = kernel_function(library, symbol, SIGNATURES[(library, symbol)])
    with torch.cuda.device(device):
        _raise_on(fn(*args, torch.cuda.current_stream(device).cuda_stream), symbol)
        _count(symbol)


def _bn_relu_dropout_fwd_cuda(z, rows, n, scale, bias, seed, layer, rate):
    """``bn_relu_dropout_forward``: the centred moments in one read of z
    (:func:`dense_moments_emulation`'s operations), then y with the mask
    drawn in place."""
    n = n.reshape(1).float().contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _check_bn_cuda(z, rows, n, (scale, bias))
    seed_t, thr = _drop_args(seed, rate, z.device)
    N, H = z.shape
    chunks, per = _chunks(N)
    f32 = dict(dtype=torch.float32, device=z.device)
    # each chunk's (hi, lo, M2) partial a column, then its count
    part = torch.empty(3 * chunks * H + chunks, **f32)
    mean, var, istd, inv, shift = (torch.empty(H, **f32) for _ in range(5))
    y = torch.empty_like(z)
    _launch("bn_relu", _symbol(z, "bn_relu_dropout_forward"), z.device,
            z.data_ptr(), rows.data_ptr(), n.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            seed_t.data_ptr(), part.data_ptr(), mean.data_ptr(), var.data_ptr(),
            istd.data_ptr(), inv.data_ptr(), shift.data_ptr(), y.data_ptr(), N, H, chunks, per,
            layer, thr, keep_scale(rate, z.dtype))
    return y, mean, var, istd, inv, shift


def _bn_relu_dropout_grads_cuda(z, dy, rows, n, scale, mean, istd, inv, shift, seed, layer,
                                rate):
    """``bn_relu_dropout_backward``: ``(dz, dscale, dbias)`` as the plain
    version, the mask regenerated."""
    dy = dy.to(z.dtype).contiguous()
    n = n.reshape(1).float().contiguous()
    scale_f = scale.float().contiguous()
    _check_bn_cuda(z, rows, n, (scale_f, mean, istd, inv, shift))
    if dy.shape != z.shape or dy.device != z.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not match z {tuple(z.shape)}")
    seed_t, thr = _drop_args(seed, rate, z.device)
    N, H = z.shape
    chunks, per = _chunks(N)
    f32 = dict(dtype=torch.float32, device=z.device)
    part1, part2 = torch.empty(chunks, H, **f32), torch.empty(chunks, H, **f32)
    G1, G2 = torch.empty(H, **f32), torch.empty(H, **f32)
    dz = torch.empty_like(z)
    _launch("bn_relu", _symbol(z, "bn_relu_dropout_backward"), z.device,
            z.data_ptr(), dy.data_ptr(), rows.data_ptr(), n.data_ptr(), scale_f.data_ptr(),
            mean.data_ptr(), istd.data_ptr(), inv.data_ptr(), shift.data_ptr(),
            seed_t.data_ptr(), part1.data_ptr(), part2.data_ptr(), G1.data_ptr(),
            G2.data_ptr(), dz.data_ptr(), N, H, chunks, per, layer, thr,
            keep_scale(rate, z.dtype))
    return dz, G2.to(scale.dtype), G1.to(scale.dtype)


def _bias_relu_dropout_fwd_cuda(z, bias, seed, layer, rate):
    """``bias_relu_dropout_forward``: y as the plain version."""
    bias_r = bias.to(z.dtype).float().contiguous()
    _check_bn_cuda(z, None, None, (bias_r,))
    seed_t, thr = _drop_args(seed, rate, z.device)
    N, H = z.shape
    y = torch.empty_like(z)
    _launch("bn_relu", _symbol(z, "bias_relu_dropout_forward"), z.device, z.data_ptr(),
            bias_r.data_ptr(),
            seed_t.data_ptr(), y.data_ptr(), N, H, layer, thr, keep_scale(rate, z.dtype))
    return y


def _bias_relu_dropout_grads_cuda(z, dy, bias, seed, layer, rate):
    """``bias_relu_dropout_backward``: ``(dz, dbias)`` in one pass over z and
    dy, dbias's column sums in a fixed order."""
    dy = dy.to(z.dtype).contiguous()
    bias_r = bias.to(z.dtype).float().contiguous()
    _check_bn_cuda(z, None, None, (bias_r,))
    if dy.shape != z.shape or dy.device != z.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not match z {tuple(z.shape)}")
    seed_t, thr = _drop_args(seed, rate, z.device)
    N, H = z.shape
    chunks, per = _chunks(N)
    part = torch.empty(chunks, H, dtype=torch.float32, device=z.device)
    dbias = torch.empty(H, dtype=torch.float32, device=z.device)
    dz = torch.empty_like(z)
    _launch("bn_relu", _symbol(z, "bias_relu_dropout_backward"), z.device, z.data_ptr(),
            dy.data_ptr(),
            bias_r.data_ptr(), seed_t.data_ptr(), part.data_ptr(), dbias.data_ptr(),
            dz.data_ptr(), N, H, chunks, per, layer, thr, keep_scale(rate, z.dtype))
    return dz, dbias


class _BnReluDropout(torch.autograd.Function):
    """Masked BN + ReLU + dropout, ``(y, mean, var)``; mean and var feed the
    running statistics only and carry no gradient."""

    @staticmethod
    def forward(ctx, z, rows, n, scale, bias, seed, layer, rate, fwd, grads):
        z = z.contiguous()
        y, mean, var, istd, inv, shift = fwd(z, rows, n, scale, bias, seed, layer, rate)
        ctx.save_for_backward(z, rows, n, scale, mean, istd, inv, shift, seed)
        ctx.layer, ctx.rate, ctx.grads = layer, rate, grads
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        z, *rest, seed = ctx.saved_tensors
        dz, dscale, dbias = ctx.grads(z, dy, *rest, seed, ctx.layer, ctx.rate)
        return dz, None, None, dscale, dbias, None, None, None, None, None


class _BiasReluDropout(torch.autograd.Function):
    """``dropout(relu(bf16(z + bias)))``; gradients to z and the bias."""

    @staticmethod
    def forward(ctx, z, bias, seed, layer, rate, fwd, grads):
        z = z.contiguous()
        ctx.save_for_backward(z, bias, seed)
        ctx.layer, ctx.rate, ctx.grads = layer, rate, grads
        return fwd(z, bias, seed, layer, rate)

    @staticmethod
    def backward(ctx, dy):
        z, bias, seed = ctx.saved_tensors
        dz, dbias = ctx.grads(z, dy.contiguous(), bias, seed, ctx.layer, ctx.rate)
        return dz, dbias.to(bias.dtype), None, None, None, None, None


def _no_seed(seed: Optional[torch.Tensor], device) -> torch.Tensor:
    """A placeholder seed for calls without dropout (autograd saves a
    tensor)."""
    return torch.zeros(2, dtype=torch.int64, device=device) if seed is None else seed


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {t.device}")
    return t.device.type == "cuda"


def bn_relu_dropout(z: torch.Tensor, rows: torch.Tensor, n: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, seed: Optional[torch.Tensor] = None, layer: int = 0,
                    rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked train-mode BN + ReLU + dropout of (N, H) pre-activations:
    ``(y, mean, var)``.  ``rows`` (N, 1) float32 is the pair mask, ``n`` the
    masked count, ``seed``/``layer``/``rate`` the dropout (none at rate 0).
    CPU tensors take the plain version, CUDA tensors the kernels."""
    fwd, grads = ((_bn_relu_dropout_fwd_cuda, _bn_relu_dropout_grads_cuda)
                  if _on_card(z, "BN + ReLU + dropout") else
                  (_bn_relu_dropout_fwd_plain, _bn_relu_dropout_grads_plain))
    return _BnReluDropout.apply(z, rows, n, scale, bias, _no_seed(seed, z.device), layer,
                                float(rate), fwd, grads)


def bn_relu_dropout_reference(z, rows, n, scale, bias, seed=None, layer=0, rate=0.0, col0=0):
    """:func:`bn_relu_dropout` through its plain version, on any device;
    ``col0`` places a column slice of the full tensor (its mask's columns)."""
    return _BnReluDropout.apply(z, rows, n, scale, bias, _no_seed(seed, z.device), layer,
                                float(rate), partial(_bn_relu_dropout_fwd_plain, col0=col0),
                                partial(_bn_relu_dropout_grads_plain, col0=col0))


def bias_relu_dropout(z: torch.Tensor, bias: torch.Tensor, seed: Optional[torch.Tensor] = None,
                      layer: int = 0, rate: float = 0.0) -> torch.Tensor:
    """``dropout(relu(bf16(z + bias)))`` of (N, H) pre-activations (the
    output MLP without BatchNorm).  CPU tensors take the plain version, CUDA
    tensors the kernels."""
    fwd, grads = ((_bias_relu_dropout_fwd_cuda, _bias_relu_dropout_grads_cuda)
                  if _on_card(z, "bias + ReLU + dropout") else
                  (_bias_relu_dropout_fwd_plain, _bias_relu_dropout_grads_plain))
    return _BiasReluDropout.apply(z, bias, _no_seed(seed, z.device), layer, float(rate), fwd,
                                  grads)


def bias_relu_dropout_reference(z, bias, seed=None, layer=0, rate=0.0, col0=0):
    """:func:`bias_relu_dropout` through its plain version, on any device;
    ``col0`` as :func:`bn_relu_dropout_reference`."""
    return _BiasReluDropout.apply(z, bias, _no_seed(seed, z.device), layer, float(rate),
                                  partial(_bias_relu_dropout_fwd_plain, col0=col0),
                                  partial(_bias_relu_dropout_grads_plain, col0=col0))


# ----------------------------------------------------------------------
# the first layer: a[b] + c[l] (+ (p[b] * l[l]) @ W_prod) over all pairs


def _prod_rows(P_e: torch.Tensor, L_e: torch.Tensor) -> torch.Tensor:
    """``p[b] * l[l]`` as (B * L, d) in the inputs' dtype (one rounding)."""
    B, L = P_e.shape[0], L_e.shape[0]
    return (P_e[:, None, :] * L_e[None, :, :]).reshape(B * L, -1)


def _first_fwd_plain(a, c, P_e, L_e, w_prod):
    """z1 = bf16(a[b] + c[l] (+ prod @ W_prod)) as (B * L, H) in P_e's
    dtype."""
    B, L = a.shape[0], c.shape[0]
    z = (a[:, None, :] + c[None, :, :]).reshape(B * L, -1)
    if w_prod is not None:
        z = z + _f32_product(_prod_rows(P_e, L_e), w_prod, P_e.dtype)
    return z.to(P_e.dtype)


def _first_bwd_plain(a, c, P_e, L_e, w_prod, dz):
    """``(da, dc, dP_e, dL_e, dW_prod)``: the float32 side sums of dz, and
    for the prod block ``dW_prod = bf16(prod^T dz)``, ``dJ = bf16(dz @
    W_prod^T)`` reduced against the other side's rows in float32."""
    B, L = a.shape[0], c.shape[0]
    dzf = dz.float().view(B, L, -1)
    da, dc = dzf.sum(1), dzf.sum(0)
    if w_prod is None:
        return da, dc, None, None, None
    dw = _f32_product(_prod_rows(P_e, L_e).T, dz, dz.dtype).to(w_prod.dtype)
    dJ = _f32_product(dz, w_prod.T, dz.dtype).to(dz.dtype).float().view(B, L, -1)
    dP = (dJ * L_e.float()[None]).sum(1).to(P_e.dtype)
    dL = (dJ * P_e.float()[:, None]).sum(0).to(L_e.dtype)
    return da, dc, dP, dL, dw


def _check_first_cuda(a, c, P_e, L_e, w_prod) -> None:
    dev = a.device
    if dev.type != "cuda" or any(t.device != dev for t in (c, P_e, L_e)):
        raise ValueError("the CUDA first layer needs every tensor on one CUDA device")
    if a.dtype != torch.float32 or c.dtype != torch.float32:
        raise ValueError("the CUDA first layer takes float32 side products a and c")
    if P_e.dtype not in (torch.bfloat16, torch.float32) or L_e.dtype != P_e.dtype:
        raise ValueError(f"the CUDA first layer computes in bfloat16 or in float32, P_e and "
                         f"L_e alike, not {P_e.dtype} and {L_e.dtype}")
    H = a.shape[1]
    if c.shape[1] != H or H % 128:
        raise ValueError(f"side products {tuple(a.shape)}, {tuple(c.shape)}: the width must "
                         "be one multiple of 128")
    if w_prod is not None and (w_prod.device != dev or P_e.shape[1] % 128 or
                               tuple(w_prod.shape) != (P_e.shape[1], H)):
        raise ValueError(f"W_prod {tuple(w_prod.shape)} must be (d, {H}) on the device, d a "
                         "multiple of 128")


PROD_ROWS = 64  # label rows of a warpgroup's tile in pair_train_prod (csrc/pair_train.cu PM)


@dataclass(frozen=True)
class ProdPlan:
    """``pair_train_prod``'s schedule (``csrc/pair_train.cu:pair_prod_kernel``):
    ``items`` work items of ``PROD_ROWS`` labels x a pair of sequences x
    ``block_n`` columns, walked by ``grid`` persistent blocks (block i takes
    items i, i + grid, ...).  Item t is column tile ``t % tiles_n`` of
    sequence pair ``(t // tiles_n) % pairs`` in label tile ``t // (tiles_n *
    pairs)``: label tiles outermost, so the blocks in flight share one c and
    one L_e tile in L2.  Warpgroup w computes sequence ``2p + w`` of each
    item, both on the item's shared stages.  Label tiles cover
    ``rows_per_seq`` rows a sequence (K1's padded chunk): rows past L take c
    and L_e as 0."""

    batch: int
    labels: int
    rows_per_seq: int
    width_out: int
    block_n: int
    tiles_l: int
    pairs: int
    tiles_n: int
    grid: int

    @property
    def items(self) -> int:
        return self.tiles_l * self.pairs * self.tiles_n

    def item(self, t: int) -> Tuple[int, int, int]:
        """``(pair, first label, first column)`` of item ``t``."""
        u = t // self.tiles_n
        return u % self.pairs, (u // self.pairs) * PROD_ROWS, (t % self.tiles_n) * self.block_n

    def tiles(self, block: int) -> List[Tuple[int, int, int, int, int]]:
        """Block ``block``'s warpgroup tiles, item by item and warpgroup 0
        first: ``(warpgroup, sequence, first label, rows stored, first
        column)``; a sequence past B is computed and not stored (rows 0)."""
        out = []
        for t in range(block, self.items, self.grid):
            p, l0, n0 = self.item(t)
            for w in (0, 1):
                b = 2 * p + w
                rows = min(PROD_ROWS, self.rows_per_seq - l0) if b < self.batch else 0
                out.append((w, b, l0, rows, n0))
        return out


def prod_plan(B: int, L: int, K: int, N: int, num_sms: int,
              rows_per_seq: Optional[int] = None) -> ProdPlan:
    """``pair_train_prod``'s plan for P_e (B, K), L_e (L, K) and W (K, N)
    into rows ``b * rows_per_seq + l`` (default L).  The column tile is 256
    where N allows it, else 128.  Raises for widths the kernel does not
    take: K and N multiples of 128."""
    Lz = L if rows_per_seq is None else rows_per_seq
    if B <= 0 or L <= 0 or Lz < L or num_sms <= 0:
        raise ValueError(f"no pair_train_prod plan for B {B}, L {L}, rows {Lz} on {num_sms} SMs")
    if K <= 0 or N <= 0 or K % 128 or N % 128:
        raise ValueError(f"pair_train_prod takes widths (in {K}, out {N}) that are multiples "
                         "of 128")
    block_n = _block_n(N)
    tiles_l, pairs, tiles_n = -(-Lz // PROD_ROWS), -(-B // 2), N // block_n
    if tiles_l * pairs * tiles_n > 2**31 - 1:
        raise ValueError(f"B {B} x rows {Lz} x N {N}: more items than the kernel counts")
    return ProdPlan(B, L, Lz, N, block_n, tiles_l, pairs, tiles_n,
                    min(num_sms, tiles_l * pairs * tiles_n))


def pair_prod_cuda(a, c, P_e, L_e, w_prod, relu: bool = False, out: Optional[torch.Tensor] = None,
                   rows_per_seq: Optional[int] = None,
                   wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``pair_train_prod`` (``csrc/pair_train.cu``): ``bf16(a[b] + c[l] +
    bf16(p[b] * l[l]) @ W_prod)`` (ReLU'd when ``relu``) over every pair, K4's
    mainloop with A formed in registers, on :func:`prod_plan`.  Row ``b *
    rows_per_seq + l`` of ``out`` (default a new (B * L, H) tensor,
    ``rows_per_seq`` = L); rows in [L, rows_per_seq) of a sequence's block
    hold ``a[b]`` (ReLU'd when ``relu``: the padding of K1's chunks).
    ``wt``: W_prod already transposed to (H, d) bf16.

    For float32 P_e and L_e, ``pair_train_prod_f32`` (``csrc/pair_scorer_
    f32.cu``): ``(p[b] * l[l]) @ W_prod + (a[b] + c[l])`` in float32 through
    the split of W_prod into bf16 pieces, (B * L, H) float32, no ReLU; it
    takes none of the options."""
    a, c = a.contiguous(), c.contiguous()
    P_e, L_e = P_e.contiguous(), L_e.contiguous()
    _check_first_cuda(a, c, P_e, L_e, w_prod)
    B, K = P_e.shape
    L, N = L_e.shape[0], a.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    if P_e.dtype == torch.float32:
        if relu or out is not None or rows_per_seq is not None or wt is not None:
            raise ValueError("pair_train_prod_f32 takes no ReLU, out, rows_per_seq or wt")
        plan = pair_train_f32_plan(B, L, K, N, sms)
        wt3 = stacked_pieces(w_prod.float(), transpose=True)
        z = torch.empty(B * L, N, dtype=torch.float32, device=a.device)
        _launch("pair_scorer_f32", "pair_train_prod_f32", a.device, P_e.data_ptr(),
                L_e.data_ptr(), wt3.data_ptr(), a.data_ptr(), c.data_ptr(), z.data_ptr(), B, L,
                K, N, plan.grid)
        return z
    Lz = L if rows_per_seq is None else rows_per_seq
    if Lz < L:
        raise ValueError(f"{Lz} rows a sequence cannot hold {L} labels")
    if out is None:
        out = torch.empty(B * Lz, N, dtype=torch.bfloat16, device=a.device)
    if out.dtype != torch.bfloat16 or out.numel() < B * Lz * N or not out.is_contiguous():
        raise ValueError("out must be a contiguous bf16 tensor of B * rows_per_seq rows")
    plan = prod_plan(B, L, K, N, sms, Lz)
    if wt is None:
        wt = w_prod.to(torch.bfloat16).t().contiguous()
    _launch("pair_train", "pair_train_prod", a.device, P_e.data_ptr(), L_e.data_ptr(),
            wt.data_ptr(), a.data_ptr(), c.data_ptr(), out.data_ptr(), B, L, Lz, K, N,
            int(relu), plan.block_n, plan.grid)
    return out


def _first_fwd_cuda(a, c, P_e, L_e, w_prod):
    """The first layer on the card: ``pair_first_add`` for concat/diff,
    ``pair_train_prod`` for prod (their float32 forms for float32 P_e)."""
    if w_prod is not None:
        return pair_prod_cuda(a, c, P_e, L_e, w_prod)
    a, c = a.contiguous(), c.contiguous()
    _check_first_cuda(a, c, P_e, L_e, None)
    B, L, H = a.shape[0], c.shape[0], a.shape[1]
    z = torch.empty(B * L, H, dtype=P_e.dtype, device=a.device)
    _launch("pair_dense", _symbol(z, "pair_first_add"), a.device, a.data_ptr(), c.data_ptr(),
            z.data_ptr(), B, L, H)
    return z


SIDE_CHUNK = 64  # labels a chunk of the side sums' kernel (csrc/pair_dense.cu: 8 warps of 8)


def side_sums_plan(L: int) -> Tuple[int, int]:
    """``(chunks, SIDE_CHUNK)``: the label chunks of ``pair_side_sums``
    (the last clipped at L)."""
    if L <= 0:
        raise ValueError(f"the side sums take at least one label, not {L}")
    return -(-L // SIDE_CHUNK), SIDE_CHUNK


def side_sums_cuda(x: torch.Tensor, B: int, L: int, u: Optional[torch.Tensor] = None,
                   v: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pair_side_sums`` (``csrc/pair_dense.cu``): for x (B * L, K) bf16
    (or float32: ``pair_side_sums_f32``), ``sb[b] = sum_l x[b, l] * v[l]``
    (B, K) and ``sl[l] = sum_b x[b, l] * u[b]`` (L, K), float32, each in a
    fixed order (a missing ``u``/``v`` is ones; u and v in x's dtype), x
    read once."""
    x = x.contiguous()
    K = x.shape[1]
    if x.device.type != "cuda" or x.dtype not in (torch.bfloat16, torch.float32) or \
            x.shape[0] != B * L or K % 256:
        raise ValueError(f"the side sums take ({B * L}, K) bfloat16 or float32 on the card, K "
                         f"a multiple of 256, not {tuple(x.shape)} {x.dtype}")
    for t, rows in ((u, B), (v, L)):
        if t is not None and (tuple(t.shape) != (rows, K) or t.dtype != x.dtype or
                              t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"side rows must be ({rows}, {K}) contiguous {x.dtype}")
    chunks, per = side_sums_plan(L)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(chunks, B * K, **f32)
    sb, sl = torch.empty(B, K, **f32), torch.empty(L, K, **f32)
    _launch("pair_dense", _symbol(x, "pair_side_sums"), x.device, x.data_ptr(),
            None if u is None else u.data_ptr(), None if v is None else v.data_ptr(),
            part.data_ptr(), sb.data_ptr(), sl.data_ptr(), B, L, K, chunks, per)
    return sb, sl


def dw_prod_cuda(P_e: torch.Tensor, L_e: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """``pair_train_dw_prod`` (``csrc/pair_train_bwd.cu``): ``bf16(sum_{b, l}
    bf16(p[b] * l[l])^T dz[b, l])`` (d, H), K4-bwd's dW with A formed in
    registers.  For float32 operands ``pair_train_dw_prod_f32``
    (``csrc/pair_train_bwd_f32.cu``): ``(p * l)^T dz`` in float32 through
    the split, on :func:`pair_dw_plan`'s 128-column tiles."""
    P_e, L_e, dz = P_e.contiguous(), L_e.contiguous(), dz.contiguous()
    B, K = P_e.shape
    L, N = L_e.shape[0], dz.shape[1]
    if tuple(dz.shape) != (B * L, N) or dz.dtype not in (torch.bfloat16, torch.float32) or \
            P_e.dtype != dz.dtype or L_e.dtype != dz.dtype:
        raise ValueError(f"dz {tuple(dz.shape)} {dz.dtype} must be ({B * L}, N) bfloat16 or "
                         f"float32, P_e and L_e alike")
    sms = torch.cuda.get_device_properties(dz.device).multi_processor_count
    if dz.dtype == torch.float32:
        plan = pair_dw_plan(B, L, K, N, sms, block_n=F32_TILE)
        partial = (torch.empty(plan.slots, F32_TILE, F32_TILE, dtype=torch.float32,
                               device=dz.device) if plan.slots else None)
        dw = torch.empty(K, N, dtype=torch.float32, device=dz.device)
        _launch("pair_train_bwd_f32", "pair_train_dw_prod_f32", dz.device, P_e.data_ptr(),
                L_e.data_ptr(), dz.data_ptr(), None if partial is None else partial.data_ptr(),
                dw.data_ptr(), B, L, K, N, plan.full, plan.pieces, plan.grid)
        return dw
    plan = pair_dw_plan(B, L, K, N, sms)
    partial = (torch.empty(plan.slots, 128, plan.block_n, dtype=torch.float32,
                           device=dz.device) if plan.slots else None)
    dw = torch.empty(K, N, dtype=torch.bfloat16, device=dz.device)
    _launch("pair_train_bwd", "pair_train_dw_prod", dz.device, P_e.data_ptr(), L_e.data_ptr(),
            dz.data_ptr(), None if partial is None else partial.data_ptr(), dw.data_ptr(), B, L,
            K, N, plan.block_n, plan.full, plan.pieces, plan.grid)
    return dw


def _first_bwd_cuda(a, c, P_e, L_e, w_prod, dz):
    """The first layer's backward on the card, the plain version's outputs:
    the side sums of dz (``pair_side_sums``); for prod dW_prod
    (``pair_train_dw_prod``) and dJ's weighted side sums; their float32
    forms for float32 P_e."""
    B, L = a.shape[0], c.shape[0]
    dz = dz.to(P_e.dtype).contiguous()
    da, dc = side_sums_cuda(dz, B, L)
    if w_prod is None:
        return da, dc, None, None, None
    dw = dw_prod_cuda(P_e, L_e, dz).to(w_prod.dtype)
    gemm_precision(dz.dtype)
    dJ = dz @ w_prod.to(dz.dtype).t()
    dP, dL = side_sums_cuda(dJ, B, L, u=P_e.contiguous(), v=L_e.contiguous())
    return da, dc, dP.to(P_e.dtype), dL.to(L_e.dtype), dw


class _PairFirst(torch.autograd.Function):
    """z1 over every pair by ``fwd``; ``(da, dc, dP_e, dL_e, dW_prod)`` by
    ``bwd`` (the plain or the kernel implementations)."""

    @staticmethod
    def forward(ctx, a, c, P_e, L_e, w_prod, fwd, bwd):
        ctx.save_for_backward(a, c, P_e, L_e, w_prod)
        ctx.bwd = bwd
        return fwd(a, c, P_e, L_e, w_prod)

    @staticmethod
    def backward(ctx, dz):
        a, c, P_e, L_e, w_prod = ctx.saved_tensors
        return (*ctx.bwd(a, c, P_e, L_e, w_prod, dz.contiguous()), None, None)


def pair_first_layer(a: torch.Tensor, c: torch.Tensor, P_e: torch.Tensor, L_e: torch.Tensor,
                     w_prod: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense first layer over every pair: (B * L, H) in P_e's dtype,
    rows ``b * L + l``.  ``a`` (B, H) and ``c`` (L, H) are the float32 side
    products; ``w_prod`` (d, H) the prod block's weights (None for
    concat/diff).  CPU tensors take the plain version, CUDA tensors the
    kernels."""
    if _on_card(a, "dense first layer"):
        return _PairFirst.apply(a, c, P_e, L_e, w_prod, _first_fwd_cuda, _first_bwd_cuda)
    return pair_first_layer_reference(a, c, P_e, L_e, w_prod)


def pair_first_layer_reference(a, c, P_e, L_e, w_prod=None):
    """:func:`pair_first_layer` through its plain version, on any device."""
    return _PairFirst.apply(a, c, P_e, L_e, w_prod, _first_fwd_plain, _first_bwd_plain)


# ----------------------------------------------------------------------
# the scorer


def _first_weights(first: Params, d: int, feature_fusion: str, compute_dtype: torch.dtype):
    """``(w1_p, w1_l, w_prod)`` in float32: the first kernel rounded to the
    compute dtype (the JAX ``linear``'s cast) and split by input block, the
    diff block folded into the sides in float32.  Autograd sums the blocks'
    gradients in float32 and rounds the kernel's gradient once, as JAX
    rounds the transpose of its product."""
    W1 = first["kernel"].to(compute_dtype).float()
    w1_p, w1_l, w_prod = W1[:d], W1[d : 2 * d], None
    if feature_fusion == "concatenation_diff":
        w1_p, w1_l = w1_p + W1[2 * d : 3 * d], w1_l - W1[2 * d : 3 * d]
    elif feature_fusion == "concatenation_prod":
        w_prod = W1[2 * d : 3 * d]
    elif feature_fusion != "concatenation":
        raise ValueError(f"unknown feature fusion {feature_fusion}")
    return w1_p, w1_l, w_prod


def _side(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The float32 product of x's compute-dtype values and float32 ``w``."""
    gemm_precision(torch.float32)
    return x.float() @ w


def pair_logits_dense(
    p: Params,
    s: Optional[Params],
    P_e: torch.Tensor,  # (B, d)
    L_e: torch.Tensor,  # (L, d)
    feature_fusion: str = "concatenation",
    train: bool = False,
    dropout: float = 0.0,
    seed: Optional[torch.Tensor] = None,
    example_mask: Optional[torch.Tensor] = None,  # (B,)
    label_mask: Optional[torch.Tensor] = None,  # (L,)
    remat: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Materialised scoring of every (sequence, label) pair: ``((B, L)
    float32 logits, new output-MLP state or None)``, the JAX
    ``pair_logits_dense``.

    ``s`` None: no BatchNorm (the layers' biases instead).  ``train``: BN on
    the masked pair rows (``example_mask`` x ``label_mask``; all rows when
    neither is given), dropout at ``dropout`` after the ReLU of every layer
    but the last, its mask from ``seed`` (none without one, as JAX draws
    none without an rng).  ``remat`` (GRADIENT_CHECKPOINTING) recomputes the
    scorer after the side products in the backward.  Evaluation runs in
    label chunks of ``EVAL_CHUNK_ROWS`` pair rows.  CPU tensors take the
    plain versions, CUDA tensors the kernels."""
    if P_e.device.type == "cuda":
        check_card_widths([lin["kernel"].shape[1] for lin in p["layers"]], P_e.shape[1],
                          feature_fusion, train)
    return _dense(p, s, P_e, L_e, feature_fusion, train, dropout, seed, example_mask,
                  label_mask, remat, compute_dtype, _KERNEL_OPS)


def check_card_widths(widths, d: int, feature_fusion: str, train: bool) -> None:
    """Raise ``ValueError`` before any launch for widths the card's dense
    scorer does not take: every layer's width a multiple of 256 (the column
    blocks of K5, K6 and the side sums); with ``concatenation_prod`` the
    latent width ``d`` a multiple of 256 in training (the side sums of dJ)
    and of 128 in evaluation (``pair_train_prod``)."""
    bad = [w for w in widths if w % _BN_COLS]
    if bad:
        raise ValueError(f"the dense scorer on the card takes layer widths that are multiples "
                         f"of {_BN_COLS}, not {bad}")
    step = _BN_COLS if train else 128
    if feature_fusion == "concatenation_prod" and d % step:
        mode = "training" if train else "evaluation"
        raise ValueError(f"concatenation_prod on the card takes in {mode} a latent width that "
                         f"is a multiple of {step}, not {d}")


def pair_logits_dense_reference(p, s, P_e, L_e, feature_fusion="concatenation", train=False,
                                dropout=0.0, seed=None, example_mask=None, label_mask=None,
                                remat=False, compute_dtype=None):
    """:func:`pair_logits_dense` through the plain versions, on any device."""
    return _dense(p, s, P_e, L_e, feature_fusion, train, dropout, seed, example_mask,
                  label_mask, remat, compute_dtype, _PLAIN_OPS)


_KERNEL_OPS = (pair_first_layer, bn_relu_dropout, bias_relu_dropout, affine_relu)
_PLAIN_OPS = (pair_first_layer_reference, bn_relu_dropout_reference,
              bias_relu_dropout_reference, affine_relu_reference)


def _dense(p, s, P_e, L_e, feature_fusion, train, rate, seed, example_mask, label_mask, remat,
           compute_dtype, ops):
    first_fn, bn_fn, bias_fn, affine_fn = ops
    cd = compute_dtype or P_e.dtype
    P_e, L_e = P_e.to(cd), L_e.to(cd)
    B, d = P_e.shape
    L = L_e.shape[0]
    layers = p["layers"]
    n_layers = len(layers)
    w1_p, w1_l, w_prod = _first_weights(layers[0], d, feature_fusion, cd)
    a, c = _side(P_e, w1_p), _side(L_e, w1_l)
    w_out = p["out"]

    def act(i, z, rows=None, n=None, drop=0.0):
        """Layer i's activation of z; in training also its new BN state."""
        lin = layers[i]
        if s is None:
            return bias_fn(z, lin["bias"], seed, i, drop), None
        bp, bs = p["bns"][i], s["bns"][i]
        if not train:
            return affine_fn(z, *_affine(bp["scale"], bp["bias"], bs["mean"], bs["var"])), None
        y, mean, var = bn_fn(z, rows, n, bp["scale"], bp["bias"], seed, i, drop)
        return y, _update_running(bs, mean, var, n)

    def chain(a, c, P_e, L_e, w_prod, rows=None, n=None):
        z = first_fn(a, c, P_e, L_e, w_prod)
        new_bns = []
        for i in range(n_layers):
            if i > 0:
                z = y @ layers[i]["kernel"].to(cd)
            drop = rate if (train and rate > 0 and seed is not None and i < n_layers - 1) \
                else 0.0
            y, bs = act(i, z, rows, n, drop)
            new_bns.append(bs)
        return linear(w_out, y)[..., 0].float(), new_bns

    if not train:
        chunk = max(1, EVAL_CHUNK_ROWS // B)
        with torch.no_grad():
            parts = [chain(a, c[l0 : l0 + chunk], P_e, L_e[l0 : l0 + chunk], w_prod)[0]
                     .reshape(B, -1) for l0 in range(0, L, chunk)]
        return torch.cat(parts, dim=1), s

    em = (torch.ones(B, device=P_e.device) if example_mask is None else example_mask).float()
    lm = (torch.ones(L, device=P_e.device) if label_mask is None else label_mask).float()
    rows = (em[:, None] * lm[None, :]).reshape(B * L, 1)
    n = torch.clamp(rows.sum(), min=1.0)
    if remat:
        # the recomputation in the backward rebuilds the saved tensors only:
        # the logits and running statistics are the first forward's
        from torch.utils.checkpoint import checkpoint

        out, new_bns = checkpoint(chain, a, c, P_e, L_e, w_prod, rows, n, use_reentrant=False)
    else:
        out, new_bns = chain(a, c, P_e, L_e, w_prod, rows, n)
    return out.reshape(B, L), (None if s is None else {"bns": new_bns})


def dense_launches(n_layers: int, train: bool, batchnorm: bool, prod: bool, chunks: int = 1,
                   remat: bool = False, dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """The kernel launches of one call of the scorer on the card (with its
    backward when ``train``), from its schedule: evaluation runs ``chunks``
    label chunks; ``remat`` runs the training forward twice.  In float32
    the ``_f32`` forms launch, in bfloat16 the bf16 forms."""
    calls = (2 if remat else 1) if train else chunks
    out = {k: 0 for k in LAUNCHES}
    out["pair_train_prod" if prod else "pair_first_add"] = calls
    if batchnorm and train:
        out["bn_relu_dropout_forward"] = n_layers * calls
    elif not batchnorm:
        out["bias_relu_dropout_forward"] = n_layers * calls
    if train:
        out["pair_side_sums"] = 2 if prod else 1
        out["pair_train_dw_prod"] = int(prod)
        out["bn_relu_dropout_backward" if batchnorm else "bias_relu_dropout_backward"] = n_layers
    if dtype == torch.float32:
        out = {k: out[k[:-4]] if k.endswith("_f32") else 0 for k in LAUNCHES}
    return out
