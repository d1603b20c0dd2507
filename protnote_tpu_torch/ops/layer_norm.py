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
hand-written kernel of ``csrc/layer_norm.cu`` (bf16, a width that is a
multiple of 256 up to 2048: persistent warps that walk rows, each with the
next row's loads in flight, scale and bias kept in registers); input the
kernel does not take raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

MAX_WIDTH = 2048  # a lane keeps its H / 32 values in registers

# Launches of the kernel since the process started (or since a caller last
# set it to 0).
LAUNCHES = 0
_launch_lock = threading.Lock()


def add_layer_norm_reference(x: torch.Tensor, residual: Optional[torch.Tensor],
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """The JAX ``_layer_norm(p, x + residual, eps)`` in eager PyTorch."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p]


def _fn():
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("layer_norm", "add_layer_norm", _ARGS)


def add_layer_norm_cuda(x: torch.Tensor, residual: Optional[torch.Tensor],
                        scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's wrapper: checks what the kernel takes, launches it on the
    current stream and counts the launch."""
    global LAUNCHES
    device, H = x.device, x.shape[-1]
    if device.type != "cuda":
        raise ValueError(f"the LayerNorm kernel needs CUDA tensors, not {device}")
    if H % 256 or not 256 <= H <= MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernel takes widths that are multiples of 256 up "
                         f"to {MAX_WIDTH}, not {H}")
    for name, t in (("x", x), ("residual", residual)):
        if t is None:
            continue
        if t.device != device or t.dtype != torch.bfloat16 or t.shape != x.shape:
            raise ValueError(f"{name} must be bfloat16 {tuple(x.shape)} on {device}, not "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (H,) \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 ({H},) "
                             f"tensor on {device}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the C launch goes to the thread's device
        err = _fn()(x.data_ptr(), None if residual is None else residual.data_ptr(),
                    scale.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // H, H,
                    float(eps), stream)
        if err != 0:
            raise RuntimeError(f"add_layer_norm launch failed: CUDA error {err}")
        with _launch_lock:
            LAUNCHES += 1
    return y


def add_layer_norm(x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``LN(x + residual)`` (or ``LN(x)``) in ``x``'s dtype on ``x``'s device."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, residual, scale, bias, eps)
    if x.device.type == "cuda":
        return add_layer_norm_cuda(x, residual, scale, bias, eps)
    raise ValueError(f"no LayerNorm for device {x.device}")
