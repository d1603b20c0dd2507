"""Residual add + LayerNorm of the label text tower (K8b).

Port of ``protnote_tpu/models/text_transformer.py:_layer_norm`` (line 159)
with the residual add in front of it (the post-LN layers of bert compute
``LN(x + a)``): over the last axis,

    v   = x + residual            (in x's dtype, as JAX adds)
    mu  = mean(f32(v)),  var = mean((f32(v) - mu)^2)     (two passes)
    y   = ((f32(v) - mu) * rsqrt(var + eps) * scale + bias) in x's dtype

``residual=None`` is the plain LayerNorm of the embeddings, the pre-LN
branches and the final LN.

:func:`add_layer_norm` dispatches on the device: CPU tensors take the plain
PyTorch version (:func:`add_layer_norm_reference`), CUDA tensors the
hand-written kernel of ``csrc/layer_norm.cu`` (a width that is a multiple
of 256 up to 2048: persistent warps that walk rows, each with the next
row's loads in flight, scale and bias kept in registers), in bf16 or, with
``MIXED_PRECISION False``, in float32: one kernel template on the element
type, the entry point chosen by x's dtype (:func:`entry_points`); input the
kernel does not take raises, and nothing falls back.

**Backward (K8b-bwd).**  When a gradient is wanted, :func:`add_layer_norm`
goes through an ``autograd.Function``: the forward also keeps each row's mu
and rstd (the kernel writes them on request), and the backward is, with g
the cotangent of y,

    xh = (f32(v) - mu) * rstd,   gh = f32(g) * scale
    dx = (gh - mean(gh) - xh * mean(gh * xh)) * rstd   in x's dtype
    dscale = sum_rows f32(g) * xh,   dbias = sum_rows f32(g)   (float32)

with dx also the residual's gradient (the add's operands share it).
:func:`add_layer_norm_backward_reference` is the plain version; on CUDA
tensors :func:`add_layer_norm_backward_cuda` launches the row kernel and the
fixed-order reduction of ``csrc/layer_norm.cu`` (no float atomics).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

MAX_WIDTH = 2048  # a lane keeps its H / 32 values in registers

# Launches of the kernel since the process started (or since a caller last
# set it to 0); BWD_LAUNCHES counts the backward kernels' launches (two a
# call: the row kernel and the reduction of the scale and bias sums).
# F32_LAUNCHES and F32_BWD_LAUNCHES count the float32 forms' the same way.
LAUNCHES = 0
BWD_LAUNCHES = 0
F32_LAUNCHES = 0
F32_BWD_LAUNCHES = 0
_launch_lock = threading.Lock()

# the C entry points of csrc/layer_norm.cu by element type: (forward, backward)
_ENTRY_POINTS = {torch.bfloat16: ("add_layer_norm", "add_layer_norm_backward"),
                 torch.float32: ("add_layer_norm_f32", "add_layer_norm_backward_f32")}


def entry_points(dtype: torch.dtype):
    """``(forward, backward)``: the kernel entry points that take elements
    of ``dtype`` (bf16, or float32 under ``MIXED_PRECISION False``); raises
    on any other dtype."""
    if dtype not in _ENTRY_POINTS:
        raise ValueError(f"the LayerNorm kernel takes bfloat16 or float32 tensors, not {dtype}")
    return _ENTRY_POINTS[dtype]


def add_layer_norm_reference(x: torch.Tensor, residual: Optional[torch.Tensor],
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """The JAX ``_layer_norm(p, x + residual, eps)`` in eager PyTorch."""
    y, _ = _reference_with_stats(x, residual, scale, bias, eps)
    return y


def _reference_with_stats(x, residual, scale, bias, eps):
    """``(y, stats)``: the plain forward and each row's (mu, rstd), (..., 2)."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    y = (xf - mu) * rs
    return (y * scale.float() + bias.float()).to(x.dtype), torch.cat([mu, rs], dim=-1)


def add_layer_norm_backward_reference(x: torch.Tensor, residual: Optional[torch.Tensor],
                                      scale: torch.Tensor, stats: torch.Tensor,
                                      g: torch.Tensor):
    """``(dx, dscale, dbias)``: the backward of :func:`add_layer_norm` in
    eager PyTorch, from the forward's ``stats`` (..., 2) = (mu, rstd); dx in
    x's dtype (also the residual's gradient), dscale and dbias float32."""
    v = x + residual if residual is not None else x
    mu, rs = stats[..., :1], stats[..., 1:]
    xh = (v.float() - mu) * rs
    gf = g.float()
    gh = gf * scale.float()
    dx = (gh - gh.mean(-1, keepdim=True) - xh * (gh * xh).mean(-1, keepdim=True)) * rs
    rows = gf.reshape(-1, gf.shape[-1])
    return dx.to(x.dtype), (gf * xh).reshape(rows.shape).sum(0), rows.sum(0)


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
_BWD_BLOCKS_PER_SM = 8  # the backward's row-kernel grid: 8 blocks of 4 warps an SM


def _fn(symbol: str, args=None):
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("layer_norm", symbol, _ARGS if args is None else args)


def _check_cuda(x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
                bias: torch.Tensor) -> None:
    """What the forward and backward kernels take: x and the residual of one
    dtype that :func:`entry_points` takes; raises on anything else."""
    device, H = x.device, x.shape[-1]
    entry_points(x.dtype)
    if residual is not None and residual.dtype != x.dtype:
        raise ValueError(f"residual must be {x.dtype} as x is, not {residual.dtype}")
    if device.type != "cuda":
        raise ValueError(f"the LayerNorm kernel needs CUDA tensors, not {device}")
    if H % 256 or not 256 <= H <= MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernel takes widths that are multiples of 256 up "
                         f"to {MAX_WIDTH}, not {H}")
    for name, t in (("x", x), ("residual", residual)):
        if t is None:
            continue
        if t.device != device or t.shape != x.shape:
            raise ValueError(f"{name} must be {x.dtype} {tuple(x.shape)} on {device}, not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (H,) \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 ({H},) "
                             f"tensor on {device}")


def add_layer_norm_cuda(x: torch.Tensor, residual: Optional[torch.Tensor],
                        scale: torch.Tensor, bias: torch.Tensor, eps: float,
                        stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's wrapper: checks what the kernel takes, launches its form
    for x's dtype on the current stream and counts the launch (float32 in
    ``F32_LAUNCHES``).  ``stats`` (rows, 2) float32, when given, receives
    each row's mu and rstd."""
    global LAUNCHES, F32_LAUNCHES
    _check_cuda(x, residual, scale, bias)
    device, H = x.device, x.shape[-1]
    if stats is not None and (stats.dtype != torch.float32 or not stats.is_contiguous()
                              or stats.numel() != 2 * (x.numel() // H)):
        raise ValueError("stats must be a contiguous float32 (rows, 2) tensor")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the C launch goes to the thread's device
        err = _fn(entry_points(x.dtype)[0])(
            x.data_ptr(), None if residual is None else residual.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), None if stats is None else stats.data_ptr(),
            x.numel() // H, H, float(eps), stream)
        if err != 0:
            raise RuntimeError(f"add_layer_norm launch failed: CUDA error {err}")
        with _launch_lock:
            if x.dtype == torch.float32:
                F32_LAUNCHES += 1
            else:
                LAUNCHES += 1
    return y


def add_layer_norm_backward_cuda(x: torch.Tensor, residual: Optional[torch.Tensor],
                                 scale: torch.Tensor, stats: torch.Tensor, g: torch.Tensor):
    """The backward kernels' wrapper: ``(dx, dscale, dbias)`` from the row
    kernel and the fixed-order reduction of x's dtype on the current stream;
    counts both launches in ``BWD_LAUNCHES`` (float32: ``F32_BWD_LAUNCHES``)."""
    global BWD_LAUNCHES, F32_BWD_LAUNCHES
    _check_cuda(x, residual, scale, scale)
    device, H = x.device, x.shape[-1]
    if g.shape != x.shape or g.dtype != x.dtype or g.device != device \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(f"g must be a contiguous {x.dtype} tensor shaped like x")
    rows = x.numel() // H
    if stats.dtype != torch.float32 or not stats.is_contiguous() or stats.numel() != 2 * rows:
        raise ValueError("stats must be the forward's contiguous float32 (rows, 2) tensor")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(-(-rows // 4), _BWD_BLOCKS_PER_SM * sms))
    dx = torch.empty_like(x)
    partial = torch.empty(blocks, 2, H, dtype=torch.float32, device=device)
    out = torch.empty(2, H, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _fn(entry_points(x.dtype)[1], _BWD_ARGS)(
            x.data_ptr(), None if residual is None else residual.data_ptr(), g.data_ptr(),
            scale.data_ptr(), stats.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            out.data_ptr(), blocks, rows, H, stream)
        if err != 0:
            raise RuntimeError(f"add_layer_norm_backward launch failed: CUDA error {err}")
        with _launch_lock:  # the row kernel and the reduction
            if x.dtype == torch.float32:
                F32_BWD_LAUNCHES += 2
            else:
                BWD_LAUNCHES += 2
    return dx, out[0], out[1]


def _forward(x, residual, scale, bias, eps, want_stats: bool):
    if x.device.type == "cpu":
        return _reference_with_stats(x, residual, scale, bias, eps)
    if x.device.type == "cuda":
        stats = (torch.empty(x.numel() // x.shape[-1], 2, dtype=torch.float32, device=x.device)
                 if want_stats else None)
        return add_layer_norm_cuda(x, residual, scale, bias, eps, stats), stats
    raise ValueError(f"no LayerNorm for device {x.device}")


def add_layer_norm_backward(x: torch.Tensor, residual: Optional[torch.Tensor],
                            scale: torch.Tensor, stats: torch.Tensor, g: torch.Tensor):
    """``(dx, dscale, dbias)``: the plain version on CPU tensors, the kernels
    on CUDA tensors."""
    if x.device.type == "cpu":
        return add_layer_norm_backward_reference(x, residual, scale, stats, g)
    if x.device.type == "cuda":
        return add_layer_norm_backward_cuda(x, residual, scale, stats, g)
    raise ValueError(f"no LayerNorm backward for device {x.device}")


class _AddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps):
        y, stats = _forward(x, residual, scale, bias, eps, want_stats=True)
        ctx.save_for_backward(x, residual, scale, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, residual, scale, stats = ctx.saved_tensors
        dx, dscale, dbias = add_layer_norm_backward(x, residual, scale, stats, g.contiguous())
        return (dx, None if residual is None else dx, dscale.to(scale.dtype),
                dbias.to(scale.dtype), None)


def add_layer_norm(x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``LN(x + residual)`` (or ``LN(x)``) in ``x``'s dtype on ``x``'s
    device; through the autograd Function (K8b-bwd on the way back) when a
    gradient is wanted."""
    wanted = [t for t in (x, residual, scale, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in wanted):
        return _AddLayerNorm.apply(x, residual, scale, bias, eps)
    return _forward(x, residual, scale, bias, eps, want_stats=False)[0]
