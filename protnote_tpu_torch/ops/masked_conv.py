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

Three hand-written CUDA sources carry it on the card (bf16 only):

* ``csrc/masked_conv.cu``: ``masked_conv_forward``, an implicit GEMM on
  TMA + wgmma (``csrc/masked_conv.cuh``: persistent, warp-specialised, A
  formed in registers) with the BN prologue and the bias/mask/residual
  epilogue, and ``masked_mean_pool``;
* ``csrc/masked_conv_bwd.cu``: ``masked_conv_dx`` (the transposed dilated
  conv on the forward's mainloop, masks on both sides) and
  ``masked_conv_dw`` (dW a tap on TMA + wgmma over the K steps of a
  host-built plan, :func:`dw_step_plan`, summed in a fixed order; dbias);
* ``csrc/masked_bn.cu``: the train-mode masked BN + ReLU of the JAX
  ``batchnorm_apply(train=True, reduce_axes=(0, 1), mask, count)`` with its
  count rule (:func:`bn_mask_and_count`), forward and backward.

The conv kernels read their input through TMA, which takes rows that start
on 16 bytes: an activation is a strided ``(B, T, C)`` tensor whose rows lie
:func:`row_pitch` (C rounded up to 8) channels apart (:func:`padded_empty`,
:func:`pad_pitch`; 1,100 -> 1,104, 550 -> 552, the one-hot's 20 -> 24).  The
chain keeps its activations so; a wrapper copies an input of another pitch
into such a buffer (the copy is part of its time), and the forward writes
its output at that pitch.  The weights are re-laid once a version
(:func:`conv_weight_layout`, cached on the parameter tensor by
:func:`weight_layout`; re-laid every call under autograd), and each call
runs the tiles of a plan built on the host from the lengths
(:func:`conv_tile_plan`, and for dW :func:`dw_step_plan`; the lengths are
read back once a tensor).

:func:`masked_conv`, :func:`masked_bn_relu_train` and
:func:`masked_mean_pool` dispatch on the device: CPU tensors take the plain
PyTorch versions (the ``*_reference`` functions, which also run on the card
as the yardstick), CUDA tensors the kernels, through ``autograd.Function``s
when a gradient is wanted.  A CUDA call in another dtype than bfloat16
raises; nothing falls back to cuDNN.

Rounding points in the backward: each gradient is rounded to bf16 once,
after its float32 sum (dX, dW and dbias of a conv; dx of the BN), and the
master weights receive the bf16 value cast to float32.  JAX's own bf16
``_masked_conv`` cannot be differentiated (its conv's transpose mixes a
float32 cotangent with a bf16 operand and raises); the port rounds where
its transposed convs would with the cotangent cast to bf16.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from protnote_tpu_torch.models.layers import Params, batchnorm_train, gemm_precision

# Launches of each kernel entry point since the process started (or since a
# caller last set them to 0); one a call of its wrapper.
LAUNCHES = {"masked_conv_fwd": 0, "masked_mean_pool": 0, "masked_conv_dx": 0,
            "masked_conv_dw": 0, "masked_bn_relu_fwd": 0, "masked_bn_relu_bwd": 0}
_launch_lock = threading.Lock()

_H100_SMS = 132
_BN_MIN_CHUNK_ROWS = 256  # rows of a BN column-sum chunk, at least
_BN_MAX_CHUNKS = 128


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


def masked_mean_pool_reference(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, C) float32: the sum of the valid rows over ``max(length, 1)``,
    summed in a row-major copy (the same bits at any row pitch)."""
    feats = feats.contiguous()
    mask = valid_mask(lengths, feats.shape[1]).to(feats.dtype)
    denom = torch.clamp(lengths[:, None].float(), min=1.0)
    return (feats * mask).float().sum(dim=1) / denom


# ----------------------------------------------------------------------
# the conv kernels' layouts and plan

BLOCK_M = 128  # positions of a conv tile (csrc/masked_conv.cuh BM)
BLOCK_N = 184  # columns of a conv tile (BN): 552 = 3 x 184, 1104 = 6 x 184
BLOCK_K = 64  # channels of a K step (BK): one 128-byte swizzled row
PITCH_CHANNELS = 8  # a row pitch is a multiple of 8 bf16 channels: 16 bytes


def row_pitch(channels: int) -> int:
    """The row pitch of a ``channels``-wide activation: rounded up to 8."""
    return -(-channels // PITCH_CHANNELS) * PITCH_CHANNELS


def padded_empty(B: int, T: int, C: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised ``(B, T, C)`` tensor whose rows lie :func:`row_pitch`
    (C) elements apart (strided, not a view: its padding channels are never
    read or written)."""
    P = row_pitch(C)
    return torch.empty_strided((B, T, C), (T * P, P, 1), dtype=dtype, device=device)


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
    """:func:`conv_weight_layout` of ``kernel`` cast to ``dtype``, cached on
    the kernel tensor (:func:`_cached`)."""
    return _cached(kernel, ("layout", dx, dtype),
                   lambda: conv_weight_layout(kernel.detach().to(dtype), dx))


def conv_tile_plan(lengths, T: int, taps: int, dilation: int, n: int, dx: bool) -> np.ndarray:
    """The conv kernels' schedule: int32 tile codes ``(b * mtiles + row tile)
    * ntiles + column tile`` (``mtiles`` = ceil(T / 128), ``ntiles`` =
    ceil(n / 184)) of every tile whose first row is valid (t0 < min(L, T)),
    the most taps first (ties in code order).  A tile runs the taps whose
    shifted rows meet [0, L) for its rows [t0, t0 + 128) (the kernel's
    ``conv_tile``).  The persistent blocks take tiles i, i + grid, ...; the
    rows of the other row tiles are written after them (zeros, or the
    residual)."""
    lens = np.clip(np.asarray(lengths, np.int64).reshape(-1), 0, T)
    mtiles, ntiles = -(-T // BLOCK_M), -(-n // BLOCK_N)
    step = -dilation if dx else dilation
    t0 = np.arange(mtiles)[None, :, None] * BLOCK_M
    s = step * (np.arange(taps) - (taps - 1) // 2)[None, None, :]
    L = lens[:, None, None]
    hit = (t0 < L) & (t0 + s < L) & (t0 + BLOCK_M + s > 0)  # (B, mtiles, taps)
    j = np.arange(taps)
    jlo = np.where(hit, j, taps).min(axis=2)
    jhi = np.where(hit, j, -1).max(axis=2)
    count = np.maximum(jhi - jlo + 1, 0).reshape(-1)  # taps a row tile runs
    rows = np.flatnonzero(count > 0)
    order = rows[np.argsort(-count[rows], kind="stable")]
    codes = (order[:, None] * ntiles + np.arange(ntiles)[None, :]).reshape(-1)
    return codes.astype(np.int32)


def _plan_on(lengths: torch.Tensor, T: int, taps: int, dilation: int, n: int, dx: bool,
             device) -> torch.Tensor:
    """:func:`conv_tile_plan` as an int32 tensor on ``device`` (its length in
    ``.tiles``), kept on the lengths tensor (:func:`_cached`): a chain's 11
    convs share 7 plans and one read-back of the lengths to the host."""
    def make():
        host = (lengths if lengths.device.type == "cpu"
                else _cached(lengths, "host", lambda: lengths.cpu()))
        codes = torch.from_numpy(conv_tile_plan(host.numpy(), T, taps, dilation, n, dx))
        plan = (codes.pin_memory().to(device, non_blocking=True) if len(codes)
                else torch.zeros(1, dtype=torch.int32, device=device))
        plan.tiles = len(codes)
        return plan

    return _cached(lengths, ("plan", T, taps, dilation, n, dx, str(device)), make)


DW_BLOCK_M = 128  # input channels of a dW tile (csrc/masked_conv_bwd.cu DW_BM)
DW_BLOCK_N = 192  # output channels of a dW tile (DW_BN): 550 -> 3 x 192, 1100 -> 6 x 192
DW_STEP = 64  # positions of a dW K step (DW_BK), all of one sequence


def dw_tiles(taps: int, cin: int, cout: int) -> int:
    """dW's output tiles: one a (tap, row tile, column tile)."""
    return taps * -(-cin // DW_BLOCK_M) * -(-cout // DW_BLOCK_N)


def dw_splits(taps: int, cin: int, cout: int, sms: int = _H100_SMS) -> int:
    """How many ranges ``masked_conv_dw`` cuts each tap's K steps into: the
    most that keep its work items within one wave of ``sms`` blocks, at
    least one (a step's full width: 9 x 1,100 x 550 has 243 tiles, 1;
    1 x 550 x 1,100 has 30, 4; conv1's 9 x 20 x 1,100 has 54, 2).  Each
    split past the first costs float32 partials of the whole dW."""
    return max(1, sms // dw_tiles(taps, cin, cout))


def dw_step_plan(lengths, T: int, taps: int, dilation: int, cin: int, cout: int,
                 sms: int = _H100_SMS) -> Tuple[np.ndarray, int, int]:
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
    - s)); its steps cover them in (b, t) order, 64 positions at most and
    never two sequences a step (``rows`` of them valid from t0), and split
    sp takes steps [floor(sp n / splits), floor((sp + 1) n / splits)) of the
    tap's n."""
    lens = np.clip(np.asarray(lengths, np.int64).reshape(-1), 0, T)
    if T > 0xFFFF:
        raise ValueError(f"dW's plan packs a position in 16 bits: T {T} is too long")
    splits = dw_splits(taps, cin, cout, sms)
    mtiles, ntiles = -(-cin // DW_BLOCK_M), -(-cout // DW_BLOCK_N)
    shift = dilation * (np.arange(taps) - (taps - 1) // 2)
    lo = np.maximum(0, -shift)[:, None]  # (taps, 1)
    hi = np.minimum(lens[None, :], lens[None, :] - shift[:, None])  # (taps, B)
    n = np.maximum(0, -(-(hi - lo) // DW_STEP)).reshape(-1)  # steps of each (tap, sequence)
    pair = np.repeat(np.arange(n.size), n)  # each step's (tap, sequence)
    t0 = np.repeat(lo, len(lens), axis=1).reshape(-1)[pair] + DW_STEP * (
        np.arange(pair.size) - np.repeat(np.cumsum(n) - n, n))
    rows = np.minimum(DW_STEP, hi.reshape(-1)[pair] - t0)
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
                device) -> torch.Tensor:
    """:func:`dw_step_plan` as an int32 tensor on ``device`` (``.splits``,
    ``.items``), kept on the lengths tensor as :func:`_plan_on` keeps the
    conv plans (the same read-back of the lengths)."""
    def make():
        host = (lengths if lengths.device.type == "cpu"
                else _cached(lengths, "host", lambda: lengths.cpu()))
        plan, splits, items = dw_step_plan(host.numpy(), T, taps, dilation, cin, cout,
                                           _num_sms(device))
        out = torch.from_numpy(plan).pin_memory().to(device, non_blocking=True)
        out.splits, out.items = splits, items
        return out

    return _cached(lengths, ("dw_plan", T, taps, dilation, cin, cout, str(device)), make)


@functools.lru_cache(maxsize=None)
def _num_sms(device) -> int:
    """The conv kernels' grid: one persistent block an SM (those left without
    a tile write the rows past the lengths)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# ----------------------------------------------------------------------
# the kernels' wrappers

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGS = {
    ("masked_conv", "masked_conv_forward"): [_P] * 9 + [_I] * 13 + [_P],
    ("masked_conv", "masked_mean_pool"): [_P] * 3 + [_I] * 4 + [_P],
    ("masked_conv_bwd", "masked_conv_dx"): [_P] * 5 + [_I] * 12 + [_P],
    ("masked_conv_bwd", "masked_conv_dw"): [_P] * 8 + [_I] * 11 + [_P],
    ("masked_bn", "masked_bn_relu_forward"): [_P] * 7 + [_F] * 3 + [_P] * 6 + [_I] * 4
                                             + [_LL, _P],
    ("masked_bn", "masked_bn_relu_backward"): [_P] * 14 + [_I] * 4 + [_LL, _P],
}


def _launch(library: str, symbol: str, counter: str, device: torch.device, *args) -> None:
    """Call a C entry point on ``device``'s current stream, raise on its CUDA
    error, count the launch."""
    from protnote_tpu_torch.ops.kernels import kernel_function

    fn = kernel_function(library, symbol, _ARGS[(library, symbol)])
    with torch.cuda.device(device):  # the C launch goes to the thread's device
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES[counter] += 1


def check_compute_dtype(dtype: torch.dtype) -> None:
    """The kernels compute in bfloat16; any other dtype on the card raises."""
    if dtype != torch.bfloat16:
        raise ValueError(f"the CUDA encoder kernels (K7) compute in bfloat16, not {dtype} "
                         "(MIXED_PRECISION: True)")


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


def masked_mean_pool_cuda(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``masked_mean_pool``: bf16 (B, T, C) at any row pitch -> float32 (B,
    C)."""
    if feats.device.type != "cuda":
        raise ValueError(f"masked_mean_pool needs CUDA tensors, not {feats.device}")
    B, T, C = feats.shape
    feats, pitch = _rows("feats", feats, (B, T, C), feats.device)
    lengths = _lengths_on(lengths, feats.device)
    out = torch.empty(B, C, dtype=torch.float32, device=feats.device)
    _launch("masked_conv", "masked_mean_pool", "masked_mean_pool", feats.device,
            feats.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, T, C, pitch)
    return out


def masked_conv_dx_cuda(dy: torch.Tensor, kernel: torch.Tensor, lengths: torch.Tensor,
                        dilation: int, layout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``masked_conv_dx``: the input gradient (B, T, C_in) bf16, contiguous,
    of a masked conv from its output gradient ``dy`` (B, T, C_out) (copied
    into a buffer at :func:`row_pitch` (C_out) unless it is at such a pitch)
    and ``kernel`` (taps, C_in, C_out) (or ``layout``, its dX layout)."""
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
    dx = torch.empty(B, T, cin, dtype=torch.bfloat16, device=dev)
    _launch("masked_conv_bwd", "masked_conv_dx", "masked_conv_dx", dev, dyp.data_ptr(),
            layout.data_ptr(), lengths.data_ptr(), plan.data_ptr(), dx.data_ptr(), B, T, cin,
            cout, dyp.stride(1), cin, k_pad, n_pad, taps, dilation, plan.tiles, _num_sms(dev))
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


def bn_chunks(rows: int) -> Tuple[int, int]:
    """``(chunks, rows_per_chunk)`` of the BN kernels' column sums."""
    per = max(_BN_MIN_CHUNK_ROWS, math.ceil(rows / _BN_MAX_CHUNKS))
    return math.ceil(rows / per), per


def _em_on(example_mask: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if example_mask is None:
        return None
    return example_mask.to(device=device, dtype=torch.float32).contiguous()


def masked_bn_relu_forward_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                run_mean: torch.Tensor, run_var: torch.Tensor,
                                lengths: torch.Tensor, example_mask: Optional[torch.Tensor],
                                eps: float, momentum: float):
    """``masked_bn_relu_forward``: ``(y, new_mean, new_var, stats, counts)``
    with ``stats`` (5, C) = mean, var, rstd, inv, shift and ``counts`` (2,)
    = n, n_valid (float32), for the backward."""
    B, T, C = x.shape
    dev, f32 = x.device, torch.float32
    _check("x", x, (B, T, C), torch.bfloat16, dev)
    if C % 2:
        raise ValueError(f"the BN kernels take an even channel count, not {C}")
    vec = [t.detach().to(f32).contiguous() for t in (scale, bias, run_mean, run_var)]
    for name, t in zip(("scale", "bias", "running mean", "running var"), vec):
        _check(name, t, (C,), f32, dev)
    lengths = _lengths_on(lengths, dev)
    em = _em_on(example_mask, dev)
    chunks, per = bn_chunks(B * T)
    part = torch.empty(chunks, C, dtype=f32, device=dev)
    counts = torch.empty(2, dtype=f32, device=dev)
    stats = torch.empty(5, C, dtype=f32, device=dev)
    new_mean, new_var = torch.empty(C, dtype=f32, device=dev), torch.empty(C, dtype=f32, device=dev)
    y = torch.empty_like(x)
    _launch("masked_bn", "masked_bn_relu_forward", "masked_bn_relu_fwd", dev, x.data_ptr(),
            lengths.data_ptr(), _ptr(em), *[t.data_ptr() for t in vec], float(momentum),
            float(1.0 - momentum), float(eps), part.data_ptr(), counts.data_ptr(),
            stats.data_ptr(), new_mean.data_ptr(), new_var.data_ptr(), y.data_ptr(), B, T, C,
            chunks, per)
    return y, new_mean, new_var, stats, counts


def masked_bn_relu_backward_cuda(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                                 scale: torch.Tensor, stats: torch.Tensor,
                                 counts: torch.Tensor, lengths: torch.Tensor,
                                 example_mask: Optional[torch.Tensor]):
    """``masked_bn_relu_backward``: ``(dx bf16, dscale, dbias float32)``."""
    B, T, C = x.shape
    dev, f32 = x.device, torch.float32
    for name, t in (("x", x), ("y", y), ("dy", dy)):
        _check(name, t, (B, T, C), torch.bfloat16, dev)
    scale = scale.detach().to(f32).contiguous()
    _check("scale", scale, (C,), f32, dev)
    lengths = _lengths_on(lengths, dev)
    em = _em_on(example_mask, dev)
    chunks, per = bn_chunks(B * T)
    part, part2 = (torch.empty(chunks, C, dtype=f32, device=dev) for _ in range(2))
    coef = torch.empty(2, C, dtype=f32, device=dev)
    dscale, dbias = torch.empty(C, dtype=f32, device=dev), torch.empty(C, dtype=f32, device=dev)
    dx = torch.empty_like(x)
    _launch("masked_bn", "masked_bn_relu_backward", "masked_bn_relu_bwd", dev, x.data_ptr(),
            y.data_ptr(), dy.data_ptr(), lengths.data_ptr(), _ptr(em), scale.data_ptr(),
            stats.data_ptr(), counts.data_ptr(), part.data_ptr(), part2.data_ptr(),
            coef.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), dx.data_ptr(), B, T, C,
            chunks, per)
    return dx, dscale, dbias


# ----------------------------------------------------------------------
# autograd


class _MaskedConv(torch.autograd.Function):
    # The weights are re-laid at every call (they change every step): for the
    # forward here, for dX in the backward.  The input is saved at the padded
    # pitch (the copy the forward reads anyway) and dy is copied to it once,
    # for dX and dW, which both read them through TMA.
    @staticmethod
    def forward(ctx, x, kernel, bias, residual, lengths, dilation):
        x = pad_pitch(x)
        ctx.save_for_backward(x, kernel, lengths)
        ctx.dilation = dilation
        return masked_conv_cuda(x, kernel, bias, lengths, dilation, residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, kernel, lengths = ctx.saved_tensors
        dx = dw = db = None
        dy = pad_pitch(g)
        if ctx.needs_input_grad[0]:
            dx = masked_conv_dx_cuda(dy, kernel, lengths, ctx.dilation)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = masked_conv_dw_cuda(x, dy, lengths, kernel.shape[0], ctx.dilation)
        return dx, dw, db, (g if ctx.needs_input_grad[3] else None), None, None


class _MaskedBNRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, run_mean, run_var, lengths, example_mask, eps, momentum):
        y, new_mean, new_var, stats, counts = masked_bn_relu_forward_cuda(
            x, scale, bias, run_mean, run_var, lengths, example_mask, eps, momentum)
        ctx.save_for_backward(x, y, scale, stats, counts, lengths, example_mask)
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, g, _mean, _var):
        x, y, scale, stats, counts, lengths, example_mask = ctx.saved_tensors
        dx, dscale, dbias = masked_bn_relu_backward_cuda(x, y, g.contiguous(), scale, stats,
                                                         counts, lengths, example_mask)
        return dx, dscale, dbias, None, None, None, None, None, None


class _MaskedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, lengths):
        ctx.save_for_backward(lengths)
        ctx.shape, ctx.dtype = feats.shape, feats.dtype
        return masked_mean_pool_cuda(feats, lengths)

    @staticmethod
    def backward(ctx, g):
        # the pool's transpose: bf16(g / max(length, 1)) on the valid rows
        (lengths,) = ctx.saved_tensors
        mask = valid_mask(lengths, ctx.shape[1]).to(ctx.dtype)
        denom = torch.clamp(lengths[:, None].float(), min=1.0)
        return (g / denom).to(ctx.dtype)[:, None, :] * mask, None


# ----------------------------------------------------------------------
# dispatch


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def masked_conv(x: torch.Tensor, p: Params, lengths: torch.Tensor, dilation: int,
                bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One masked conv of the encoder with the parameters ``p`` (``kernel``
    (taps, C_in, C_out), ``bias``), in ``x``'s dtype: the plain version on
    the CPU, ``masked_conv_forward`` on the card (its backward kernels when a
    gradient is wanted; without, the weights' layout cached on the kernel
    tensor).  ``bn`` is eval mode only.  The result's rows lie
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
    bias = _cached(p["bias"], ("cast", x.dtype), lambda: p["bias"].detach().to(x.dtype))
    return masked_conv_cuda(x, p["kernel"], bias, lengths, dilation, bn, residual,
                            layout=weight_layout(p["kernel"], x.dtype, dx=False))


def masked_bn_relu_train(x: torch.Tensor, p: Params, s: Params, lengths: torch.Tensor,
                         example_mask: Optional[torch.Tensor], eps: float,
                         momentum: float) -> Tuple[torch.Tensor, Params]:
    """``(relu(BN(x)), new_state)``, train-mode masked BN under the count
    rule: the plain version on the CPU, the K7-BN kernels on the card."""
    if x.device.type == "cpu":
        return masked_bn_relu_reference(x, p, s, lengths, example_mask, eps, momentum)
    if x.device.type != "cuda":
        raise ValueError(f"no masked BatchNorm for device {x.device}")
    check_compute_dtype(x.dtype)
    lengths = _lengths_on(lengths, x.device)
    em = _em_on(example_mask, x.device)
    if _wants_grad(x, p["scale"], p["bias"]):
        y, mean, var = _MaskedBNRelu.apply(x.contiguous(), p["scale"], p["bias"], s["mean"],
                                           s["var"], lengths, em, eps, momentum)
    else:
        y, mean, var, _, _ = masked_bn_relu_forward_cuda(
            x.contiguous(), p["scale"], p["bias"], s["mean"], s["var"], lengths, em, eps,
            momentum)
    return y, {"mean": mean.to(s["mean"].dtype), "var": var.to(s["var"].dtype)}


def masked_mean_pool(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 masked mean pool: the plain version on the CPU,
    ``masked_mean_pool`` on the card."""
    if feats.device.type == "cpu":
        return masked_mean_pool_reference(feats, lengths)
    if feats.device.type != "cuda":
        raise ValueError(f"no masked pool for device {feats.device}")
    check_compute_dtype(feats.dtype)
    if _wants_grad(feats):
        return _MaskedPool.apply(feats, _lengths_on(lengths, feats.device))
    return masked_mean_pool_cuda(feats, lengths)
