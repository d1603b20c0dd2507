"""Masked softmax attention of the label text tower (K8a).

Port of the attention core of ``protnote_tpu/models/text_transformer.py:
_attention`` (lines 182-190): with q, k, v (B, nh, T, hd) in the compute
dtype,

    scores = (q . k^T in float32) * float32(1 / sqrt(hd)) + bias
    probs  = softmax(scores) in float32, rounded to the compute dtype
    ctx    = (probs . v in float32), rounded to the compute dtype

where ``bias`` is -1e9 on every key whose ``key_mask`` is 0 and, with
``causal``, on every key after the query (0 elsewhere).  The JAX source
divides by the constant ``sqrt(hd)``; jitted, XLA compiles that into a
multiply by its float32 reciprocal, and both versions here multiply.  The
bias is added to every key rather than leaving masked keys out, so a row
whose keys are all masked (the filler rows of a padded chunk) gets the
uniform softmax JAX gives it, not 0/0.

:func:`masked_attention` dispatches on the device: CPU tensors take the
plain PyTorch version (:func:`masked_attention_reference`), CUDA tensors the
hand-written kernel of ``csrc/text_attention.cu`` (bf16, hd 64, T <= 512)
or, for float32 tensors (``MIXED_PRECISION False``), of
``csrc/text_attention_f32.cu``: the core at ``Precision.HIGHEST``, nothing
rounded to bf16, its products on the tensor cores through a 3xTF32 split
held to float32 (:func:`entry_points` picks the form by dtype); input the
kernels do not take raises, and nothing falls back.

**Backward (K8a-bwd).**  When a gradient is wanted (the tower trains),
:func:`masked_attention` goes through an ``autograd.Function`` whose
backward is the VJP JAX derives from the same core.  Its rounding points,
read from ``jax.make_jaxpr`` of ``jax.vjp`` of the core at bfloat16 on the
CPU::

    h   = (q . k in f32) * scale + bias,  m = max h,  y = exp(h - m),  z = sum y
    dV  = bf16(bf16(y / z)^T . f32(dctx))          the forward's bf16 P
    dP  = bf16(f32(dctx) . v^T)                    rounded to bf16, used as f32
    D   = sum((dP * z^-2) * y)
    dS  = ((dP / z) + (-D)) * y * scale            float32, never rounded
    dQ  = bf16(dS . k),  dK = bf16(dS^T . q)       f32 sums of f32 x bf16

(JAX divides dS by sqrt(hd) = 8.0, a multiply by 1/8 exactly.)
:func:`masked_attention_backward_reference` is that chain in plain PyTorch;
on CUDA tensors :func:`masked_attention_backward_cuda` launches
``csrc/text_attention_bwd.cu``, which recomputes h from q and k (no score
row is kept by the forward, whose launch is unchanged) and takes m, z and D
itself: at T <= :data:`ONE_PASS_T` (every path that trains the tower pads
its descriptions to 128 tokens) one wgmma kernel a call with a (b, h)'s
whole score matrix in the block, above it two mma.sync kernels
(:func:`backward_launches`, by shape only).  A row whose keys are all masked
has y = 1 on every key: the gradient of JAX's uniform softmax, not NaN.
In float32 every ``.to(q.dtype)`` above is a no-op, and
``csrc/text_attention_f32.cu`` computes that chain with the same counts: up
to :data:`ONE_PASS_T` one kernel a (b, h) that forms s and dP once, above
it a dQ kernel writing each row's m, z and D, then a dK/dV kernel from
them; it never falls back to the bf16 kernels.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from protnote_tpu_torch.models.layers import gemm_precision

MAX_T = 512  # label text is truncated at 510 tokens; the kernel's key bias row holds 512
HEAD_DIM = 64  # the head width of every tower the port loads
ONE_PASS_T = 128  # the backward's one-pass kernel takes T up to here
MASKED = -1e9  # the JAX package's additive mask value

# Launches of the kernel since the process started (or since a caller last
# set it to 0); BWD_LAUNCHES counts the backward kernels' launches
# (:func:`backward_launches` a call).  F32_LAUNCHES and F32_BWD_LAUNCHES
# count the float32 forms' the same way.
LAUNCHES = 0
BWD_LAUNCHES = 0
F32_LAUNCHES = 0
F32_BWD_LAUNCHES = 0
_launch_lock = threading.Lock()

# the kernels by element type: (library under protnote_tpu_torch/csrc, entry point)
_ENTRY_POINTS = {
    torch.bfloat16: {"forward": ("text_attention", "masked_attention"),
                     "backward": ("text_attention_bwd", "masked_attention_backward")},
    torch.float32: {"forward": ("text_attention_f32", "masked_attention_f32"),
                    "backward": ("text_attention_f32", "masked_attention_backward_f32")},
}


def scale_for(head_dim: int) -> float:
    """``float32(1 / float32(sqrt(head_dim)))``: what jitted XLA multiplies
    by where the JAX source divides by ``math.sqrt(head_dim)``."""
    return float(1.0 / torch.tensor(math.sqrt(head_dim), dtype=torch.float32))


def entry_points(dtype: torch.dtype) -> dict:
    """The kernels that take q, k, v of ``dtype`` (bf16, or float32 under
    ``MIXED_PRECISION False``): ``forward`` and ``backward``, each a
    ``(library, symbol)`` of ``csrc/``; raises on any other dtype."""
    if dtype not in _ENTRY_POINTS:
        raise ValueError(f"the attention kernel takes bfloat16 or float32 tensors, not {dtype}")
    return _ENTRY_POINTS[dtype]


def backward_launches(T: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Kernel launches of one backward call at T tokens, in bf16 and in
    float32 alike: one kernel up to :data:`ONE_PASS_T`, two above (dQ,
    then dK and dV)."""
    entry_points(dtype)
    return 1 if T <= ONE_PASS_T else 2


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_mask: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, nh, T, hd) alike: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, T, _ = q.shape
    if tuple(key_mask.shape) != (B, T):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} vs (B, T) = {(B, T)}")


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               key_mask: torch.Tensor, causal: bool) -> torch.Tensor:
    """The JAX attention core in eager PyTorch (ctx in ``q``'s dtype)."""
    check_inputs(q, k, v, key_mask)
    T, hd = q.shape[2], q.shape[3]
    gemm_precision(torch.float32)
    scale = torch.tensor(scale_for(hd), dtype=torch.float32, device=q.device)
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    keep = (key_mask > 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores + torch.where(keep, 0.0, MASKED).to(torch.float32)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: torch.Tensor) -> None:
    """What the forward and backward kernels take: q, k and v of one dtype
    that :func:`entry_points` takes; raises on anything else."""
    check_inputs(q, k, v, key_mask)
    entry_points(q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype, not {q.dtype}, {k.dtype}, {v.dtype}")
    T, hd = q.shape[2], q.shape[3]
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the attention kernel needs CUDA tensors, not {device}")
    if T > MAX_T:
        raise ValueError(f"the attention kernel takes at most {MAX_T} tokens (label text "
                         f"is truncated at 510), not {T}")
    if hd != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head width {HEAD_DIM}, not {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"{name} must be on {device}, not {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if key_mask.device != device or key_mask.dtype != torch.int32 or \
            not key_mask.is_contiguous():
        raise ValueError("key_mask must be a contiguous int32 tensor on the same device")


def masked_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor, causal: bool) -> torch.Tensor:
    """The kernel's wrapper: checks what the kernel takes, launches its form
    for q's dtype on the current stream and counts the launch (float32 in
    ``F32_LAUNCHES``)."""
    global LAUNCHES, F32_LAUNCHES
    from protnote_tpu_torch.ops.kernels import kernel_function

    _check_cuda(q, k, v, key_mask)
    B, nh, T, hd = q.shape
    device = q.device
    ctx = torch.empty_like(q)
    fn = kernel_function(*entry_points(q.dtype)["forward"], _FWD_ARGS)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the C launch goes to the thread's device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), ctx.data_ptr(),
                 B, nh, T, hd, int(bool(causal)), scale_for(hd), stream)
        if err != 0:
            raise RuntimeError(f"masked_attention launch failed: CUDA error {err}")
        with _launch_lock:
            if q.dtype == torch.float32:
                F32_LAUNCHES += 1
            else:
                LAUNCHES += 1
    return ctx


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
             causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, key_mask, causal)
    if q.device.type == "cuda":
        return masked_attention_cuda(q, k, v, key_mask, causal)
    raise ValueError(f"no attention for device {q.device}")


def masked_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        key_mask: torch.Tensor, causal: bool,
                                        dctx: torch.Tensor):
    """``(dq, dk, dv)`` in the inputs' dtypes: the JAX VJP of the attention
    core in eager PyTorch, rounded where JAX rounds (module docstring)."""
    check_inputs(q, k, v, key_mask)
    T, hd = q.shape[2], q.shape[3]
    gemm_precision(torch.float32)
    scale = torch.tensor(scale_for(hd), dtype=torch.float32, device=q.device)
    keep = (key_mask > 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    h = (q.float() @ k.float().transpose(-1, -2)) * scale
    h = h + torch.where(keep, 0.0, MASKED).to(torch.float32)
    y = torch.exp(h - h.amax(-1, keepdim=True))
    z = y.sum(-1, keepdim=True)
    p = (y / z).to(q.dtype).float()
    g = dctx.float()
    dv = (p.transpose(-1, -2) @ g).to(v.dtype)
    dp = (g @ v.float().transpose(-1, -2)).to(q.dtype).float()
    d = ((dp * (1.0 / (z * z))) * y).sum(-1, keepdim=True)
    ds = ((dp / z) + (-d)) * y * scale
    return (ds @ k.float()).to(q.dtype), (ds.transpose(-1, -2) @ q.float()).to(k.dtype), dv


def _backward_launch(library: str, symbol: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, key_mask: torch.Tensor, causal: bool, dctx: torch.Tensor,
                     stats: bool):
    """``(dq, dk, dv)`` in q's dtype from the entry point ``symbol`` of
    ``csrc/<library>.cu`` on the current stream (``stats``: with the
    two-kernel forms' per-row scratch)."""
    from protnote_tpu_torch.ops.kernels import kernel_function

    _check_cuda(q, k, v, key_mask)
    if dctx.shape != q.shape or dctx.dtype != q.dtype or dctx.device != q.device \
            or not dctx.is_contiguous() or dctx.data_ptr() % 16:
        raise ValueError(f"dctx must be a contiguous {q.dtype} tensor shaped like q")
    B, nh, T, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty(3, B * nh * T, dtype=torch.float32, device=q.device) if stats else None
    fn = kernel_function(library, symbol, _BWD_ARGS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):  # the C launch goes to the thread's device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dctx.data_ptr(), key_mask.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, nh, T, hd,
                 int(bool(causal)), scale_for(hd), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    return dq, dk, dv


def masked_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   key_mask: torch.Tensor, causal: bool, dctx: torch.Tensor):
    """The backward kernels' wrapper: ``(dq, dk, dv)`` in q's dtype, the
    form chosen by dtype and T alone (:func:`backward_launches`), its
    launches counted in ``BWD_LAUNCHES`` (float32: ``F32_BWD_LAUNCHES``)."""
    global BWD_LAUNCHES, F32_BWD_LAUNCHES
    T, dtype = q.shape[2], q.dtype
    n = backward_launches(T, dtype)
    out = _backward_launch(*entry_points(dtype)["backward"], q, k, v, key_mask, causal, dctx,
                           stats=n == 2)
    with _launch_lock:
        if dtype == torch.float32:
            F32_BWD_LAUNCHES += n
        else:
            BWD_LAUNCHES += n
    return out


def two_kernel_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             key_mask: torch.Tensor, causal: bool, dctx: torch.Tensor):
    """The two-kernel form at any T <= 512, uncounted: what the card tests
    and ``chip_variants.py`` compare the one-pass kernel with at T <= 128.
    The port's paths reach the two kernels only through
    :func:`masked_attention_backward_cuda` above 128 tokens."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the two-kernel bf16 backward takes bfloat16, not {q.dtype}")
    return _backward_launch("text_attention_bwd", "masked_attention_backward_two_kernels", q, k,
                            v, key_mask, causal, dctx, stats=True)


_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def masked_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_mask: torch.Tensor, causal: bool, dctx: torch.Tensor):
    """``(dq, dk, dv)``: the plain version on CPU tensors, the kernels on
    CUDA tensors."""
    if q.device.type == "cpu":
        return masked_attention_backward_reference(q, k, v, key_mask, causal, dctx)
    if q.device.type == "cuda":
        return masked_attention_backward_cuda(q, k, v, key_mask, causal, dctx)
    raise ValueError(f"no attention backward for device {q.device}")


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.causal = causal
        return _forward(q, k, v, key_mask, causal)

    @staticmethod
    def backward(ctx, dctx):
        q, k, v, key_mask = ctx.saved_tensors
        dq, dk, dv = masked_attention_backward(q, k, v, key_mask, ctx.causal,
                                               dctx.contiguous())
        return dq, dk, dv, None, None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: torch.Tensor, causal: bool) -> torch.Tensor:
    """``ctx`` (B, nh, T, hd) in ``q``'s dtype on ``q``'s device; through
    the autograd Function (K8a-bwd on the way back) when a gradient is
    wanted."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _MaskedAttention.apply(q, k, v, key_mask, causal)
    return _forward(q, k, v, key_mask, causal)
