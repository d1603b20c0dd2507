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
  mma.sync with the BN prologue and the bias/mask/residual epilogue, and
  ``masked_mean_pool``;
* ``csrc/masked_conv_bwd.cu``: ``masked_conv_dx`` (the transposed dilated
  conv, masks on both sides) and ``masked_conv_dw`` (dW a tap and dbias,
  split over sequences and summed in a fixed order);
* ``csrc/masked_bn.cu``: the train-mode masked BN + ReLU of the JAX
  ``batchnorm_apply(train=True, reduce_axes=(0, 1), mask, count)`` with its
  count rule (:func:`bn_mask_and_count`), forward and backward.

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
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from protnote_tpu_torch.models.layers import Params, batchnorm_train, gemm_precision

# Launches of each kernel entry point since the process started (or since a
# caller last set them to 0); one a call of its wrapper.
LAUNCHES = {"masked_conv_fwd": 0, "masked_mean_pool": 0, "masked_conv_dx": 0,
            "masked_conv_dw": 0, "masked_bn_relu_fwd": 0, "masked_bn_relu_bwd": 0}
_launch_lock = threading.Lock()

_H100_SMS = 132
_DW_TILE = 128  # masked_conv_dw's C_in x C_out block tile
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
    y, new_state = batchnorm_train(p, s, x, eps, momentum, reduce_axes=(0, 1), mask=mask,
                                   count=count)
    return torch.relu(y), new_state


def masked_mean_pool_reference(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, C) float32: the sum of the valid rows over ``max(length, 1)``."""
    mask = valid_mask(lengths, feats.shape[1]).to(feats.dtype)
    denom = torch.clamp(lengths[:, None].float(), min=1.0)
    return (feats * mask).float().sum(dim=1) / denom


# ----------------------------------------------------------------------
# the kernels' wrappers

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGS = {
    ("masked_conv", "masked_conv_forward"): [_P] * 8 + [_I] * 6 + [_P],
    ("masked_conv", "masked_mean_pool"): [_P] * 3 + [_I] * 3 + [_P],
    ("masked_conv_bwd", "masked_conv_dx"): [_P] * 4 + [_I] * 6 + [_P],
    ("masked_conv_bwd", "masked_conv_dw"): [_P] * 7 + [_I] * 7 + [_P],
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


def _lengths_on(lengths: torch.Tensor, device) -> torch.Tensor:
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def masked_conv_cuda(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     lengths: torch.Tensor, dilation: int,
                     bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``masked_conv_forward``: bf16 ``x`` (B, T, C_in), ``kernel`` (taps,
    C_in, C_out), ``bias`` (C_out,), optional float32 ``bn`` (inv, shift)
    (C_in,) and bf16 ``residual`` (B, T, C_out); returns (B, T, C_out)."""
    if x.device.type != "cuda":
        raise ValueError(f"masked_conv_forward needs CUDA tensors, not {x.device}")
    B, T, cin = x.shape
    taps, cout = kernel.shape[0], kernel.shape[2]
    bf16 = torch.bfloat16
    _check("x", x, (B, T, cin), bf16, x.device)
    _check("kernel", kernel, (taps, cin, cout), bf16, x.device)
    _check("bias", bias, (cout,), bf16, x.device)
    if bn is not None:
        for name, t in zip(("bn inv", "bn shift"), bn):
            _check(name, t, (cin,), torch.float32, x.device)
    if residual is not None:
        _check("residual", residual, (B, T, cout), bf16, x.device)
    lengths = _lengths_on(lengths, x.device)
    y = torch.empty(B, T, cout, dtype=bf16, device=x.device)
    inv, shift = bn if bn is not None else (None, None)
    _launch("masked_conv", "masked_conv_forward", "masked_conv_fwd", x.device, x.data_ptr(),
            kernel.data_ptr(), bias.data_ptr(), _ptr(inv), _ptr(shift), _ptr(residual),
            lengths.data_ptr(), y.data_ptr(), B, T, cin, cout, taps, dilation)
    return y


def masked_mean_pool_cuda(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``masked_mean_pool``: bf16 (B, T, C) -> float32 (B, C)."""
    if feats.device.type != "cuda":
        raise ValueError(f"masked_mean_pool needs CUDA tensors, not {feats.device}")
    B, T, C = feats.shape
    _check("feats", feats, (B, T, C), torch.bfloat16, feats.device)
    lengths = _lengths_on(lengths, feats.device)
    out = torch.empty(B, C, dtype=torch.float32, device=feats.device)
    _launch("masked_conv", "masked_mean_pool", "masked_mean_pool", feats.device,
            feats.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, T, C)
    return out


def masked_conv_dx_cuda(dy: torch.Tensor, kernel: torch.Tensor, lengths: torch.Tensor,
                        dilation: int) -> torch.Tensor:
    """``masked_conv_dx``: the input gradient (B, T, C_in) bf16 of a masked
    conv from its output gradient ``dy`` (B, T, C_out)."""
    B, T, cout = dy.shape
    taps, cin = kernel.shape[0], kernel.shape[1]
    _check("dy", dy, (B, T, cout), torch.bfloat16, dy.device)
    _check("kernel", kernel, (taps, cin, cout), torch.bfloat16, dy.device)
    lengths = _lengths_on(lengths, dy.device)
    dx = torch.empty(B, T, cin, dtype=torch.bfloat16, device=dy.device)
    _launch("masked_conv_bwd", "masked_conv_dx", "masked_conv_dx", dy.device, dy.data_ptr(),
            kernel.data_ptr(), lengths.data_ptr(), dx.data_ptr(), B, T, cin, cout, taps,
            dilation)
    return dx


def dw_splits(B: int, taps: int, cin: int, cout: int) -> int:
    """Sequence ranges of ``masked_conv_dw``: enough blocks for four of them
    an SM, at most one range a sequence."""
    tiles = taps * math.ceil(cin / _DW_TILE) * math.ceil(cout / _DW_TILE)
    return max(1, min(B, math.ceil(4 * _H100_SMS / tiles)))


def masked_conv_dw_cuda(x: torch.Tensor, dy: torch.Tensor, lengths: torch.Tensor,
                        taps: int, dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_conv_dw``: ``(dW (taps, C_in, C_out), dbias (C_out,))`` bf16
    from the conv's input ``x`` (B, T, C_in) and output gradient ``dy``."""
    B, T, cin = x.shape
    cout = dy.shape[2]
    _check("x", x, (B, T, cin), torch.bfloat16, x.device)
    _check("dy", dy, (B, T, cout), torch.bfloat16, x.device)
    lengths = _lengths_on(lengths, x.device)
    splits = dw_splits(B, taps, cin, cout)
    partial = torch.empty(splits, taps, cin, cout, dtype=torch.float32, device=x.device)
    bias_part = torch.empty(B, cout, dtype=torch.float32, device=x.device)
    dw = torch.empty(taps, cin, cout, dtype=torch.bfloat16, device=x.device)
    db = torch.empty(cout, dtype=torch.bfloat16, device=x.device)
    _launch("masked_conv_bwd", "masked_conv_dw", "masked_conv_dw", x.device, x.data_ptr(),
            dy.data_ptr(),
            lengths.data_ptr(), partial.data_ptr(), bias_part.data_ptr(), dw.data_ptr(),
            db.data_ptr(), B, T, cin, cout, taps, dilation, splits)
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
    @staticmethod
    def forward(ctx, x, kernel, bias, residual, lengths, dilation):
        ctx.save_for_backward(x, kernel, lengths)
        ctx.dilation = dilation
        return masked_conv_cuda(x, kernel, bias, lengths, dilation, residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, kernel, lengths = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = masked_conv_dx_cuda(g, kernel, lengths, ctx.dilation)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = masked_conv_dw_cuda(x, g, lengths, kernel.shape[0], ctx.dilation)
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
    gradient is wanted).  ``bn`` is eval mode only."""
    if x.device.type == "cpu":
        return masked_conv_reference(x, p["kernel"], p["bias"], lengths, dilation, bn, residual)
    if x.device.type != "cuda":
        raise ValueError(f"no masked conv for device {x.device}")
    check_compute_dtype(x.dtype)
    kernel, bias = p["kernel"].to(x.dtype), p["bias"].to(x.dtype)
    if _wants_grad(x, kernel, bias, residual):
        if bn is not None:
            raise ValueError("the conv's BatchNorm prologue is eval mode: no gradient")
        return _MaskedConv.apply(x.contiguous(), kernel.contiguous(), bias, residual,
                                 _lengths_on(lengths, x.device), dilation)
    return masked_conv_cuda(x.contiguous(), kernel.contiguous(), bias, lengths, dilation, bn,
                            residual)


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
        return _MaskedPool.apply(feats.contiguous(), _lengths_on(lengths, feats.device))
    return masked_mean_pool_cuda(feats.contiguous(), lengths)
