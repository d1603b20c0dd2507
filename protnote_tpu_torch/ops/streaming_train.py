"""Training forward of the pair MLP: the decomposed dense scorer (K4) and
masked BatchNorm + ReLU with a two-pass backward (K5).

Port of ``protnote_tpu/ops/streaming_train.py``.  Train-mode BatchNorm needs
statistics over all B x L (sequence, label) pair rows, so the layer-1
statistics are taken analytically from the per-side products
(``mean_b(a) + mean_l(c)``, ``var_b(a) + var_l(c)``), the layer-1 affine is
distributed to the sides (``a2 = bf16(a * inv1)``, ``c2 = bf16(c * inv1 +
shift1)``), and each later layer is a GEMM followed by shifted single-pass
masked moments, BN and ReLU.

Two hand-written kernels carry the (B * L, H) tensors:

* **K4** (:func:`pair_hidden`, ``csrc/pair_train.cu``): ``z2 = x1 @ W2`` with
  ``x1 = relu(a2[b] + c2[l])`` formed in the GEMM's operand staging, so x1
  never exists in memory.  Its backward is plain PyTorch inside the
  ``autograd.Function`` (x1 re-formed, two products, the ReLU gate, f32
  side sums); a hand-written backward is a ROADMAP item (K4-bwd).
* **K5** (:func:`bn_relu`, ``csrc/bn_relu.cu``): masked BN + ReLU whose
  residual is only the bf16 pre-activation; forward one moment pass and one
  elementwise pass, backward one pass for ``sum g`` and ``sum g * xhat`` and
  one for ``dz`` (the JAX ``_bn_relu`` custom VJP).  It serves every layer
  after the first.

Each kernel has its plain PyTorch version beside it.  For tensors on the CPU
the wrappers run the plain version; for CUDA tensors they launch the kernel
or raise (no fallback).  The ``*_reference`` functions run the plain
versions on any device, for comparisons against the kernels on the card.

Cast points are the JAX path's: the per-side products are float32 products
of operands rounded to the compute dtype, ``a2``/``c2`` are rounded before
their sum (which is rounded once), every pre-activation is stored in the
compute dtype with its moments and the affine in float32, and the output
linear runs in the compute dtype (bias added there) before the cast of the
logits to float32.

The streamed exact-BN scorer (K6, ``pair_logits_streaming_train``) is not
ported: it exists to bound memory on a 16 GB TPU chip, and an 80 GB card
trains the default width without it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from protnote_tpu_torch.models.layers import Params, linear
from protnote_tpu_torch.ops.pair_scorer import BN_EPS, _f32_product

BN_MOMENTUM = 0.1  # torch BatchNorm1d default, as the JAX package

STREAMING_LATER = ("the streamed exact-BN training scorer (K6, "
                   "TRAIN_STREAMING_LABEL_TILE > 0) is not ported (ROADMAP.md queue 1, "
                   "item 6); the decomposed scorer trains the default width on one card")
CHECKPOINTING_LATER = ("GRADIENT_CHECKPOINTING is not ported (ROADMAP.md queue 1, item "
                       "5e): the decomposed scorer keeps bf16 pre-activations only")

# Launches of each kernel entry point since the process started (or since a
# caller last set them to 0).
LAUNCHES = {"pair_train_hidden": 0, "bn_relu_forward": 0, "bn_relu_backward": 0}
_launch_lock = threading.Lock()


# ----------------------------------------------------------------------
# BatchNorm statistics (plain PyTorch, the JAX building blocks)


def _masked_moments(x: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-feature (mean, biased var, count) over rows with mask (N, 1)."""
    xf = x.float()
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    mean = (xf * m).sum(0) / n
    var = ((xf - mean) ** 2 * m).sum(0) / n
    return mean, var, n


def _affine(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = torch.rsqrt(var + BN_EPS) * scale.float()
    shift = bias.float() - mean * inv
    return inv, shift


def _shifted_moments(z: torch.Tensor, rows: torch.Tensor, n: torch.Tensor,
                     running_mean: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pass per-feature (mean, biased var) over masked rows, shifted
    by the detached running mean r: ``var = E[(z-r)^2] - E[z-r]^2`` is exact
    for any constant r and does not cancel where |mean| >> std."""
    r = running_mean.detach().float()
    zc = z.float() - r
    zm = zc * rows
    s1 = zm.sum(0) / n
    s2 = (zm * zc).sum(0) / n
    return s1 + r, torch.clamp(s2 - s1 * s1, min=0.0)


def _update_running(s_bn: Params, mean: torch.Tensor, var: torch.Tensor,
                    n: torch.Tensor) -> Params:
    """The new running statistics (unbiased variance), detached: the loss
    does not depend on them."""
    mean, var, n = mean.detach(), var.detach(), n.detach()
    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    return {
        "mean": (1 - BN_MOMENTUM) * s_bn["mean"] + BN_MOMENTUM * mean.to(s_bn["mean"].dtype),
        "var": (1 - BN_MOMENTUM) * s_bn["var"] + BN_MOMENTUM * unbiased.to(s_bn["var"].dtype),
    }


# ----------------------------------------------------------------------
# K5: masked BN + ReLU


def _bn_relu_fwd_plain(z, rows, n, scale, bias, running_mean):
    """K5's forward in plain PyTorch: ``(y, mean, var, istd, inv, shift)``."""
    mean, var = _shifted_moments(z, rows, n, running_mean)
    inv, shift = _affine(scale, bias, mean, var)
    istd = torch.rsqrt(var + BN_EPS)
    y = torch.relu(z.float() * inv + shift).to(z.dtype)
    return y, mean, var, istd, inv, shift


def _bn_relu_grads(z, dy, rows, n, scale, mean, istd, inv, shift):
    """The two-pass backward of ``_bn_relu_bwd`` in plain PyTorch:
    ``(dz, dscale, dbias)``.  The gate is the forward expression."""
    zf = z.float()
    xhat = (zf - mean) * istd
    g = torch.where(zf * inv + shift > 0, dy.float(), 0.0)
    G1 = g.sum(0)
    G2 = (g * xhat).sum(0)
    mn = rows / n
    dz = istd * scale.float() * (g - mn * (G1 + G2 * xhat))
    return dz.to(z.dtype), G2.to(scale.dtype), G1.to(scale.dtype)


def _chunks(N: int) -> Tuple[int, int]:
    """Row chunks of the column reductions: about 1,000 rows each, at most
    1,024 chunks (12,288 blocks at H = 3072)."""
    chunks = max(1, min(1024, -(-N // 1000)))
    per = -(-N // chunks)
    return -(-N // per), per


_BN_COLS = 256  # columns per reduction block (csrc/bn_relu.cu COLS)


def _check_bn_cuda(z: torch.Tensor, rows: torch.Tensor, n: torch.Tensor,
                   vectors) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"the CUDA BN+ReLU kernels need CUDA tensors, not {z.device}")
    if z.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA BN+ReLU kernels take bfloat16 pre-activations, not "
                         f"{z.dtype} (MIXED_PRECISION: True)")
    if z.dim() != 2 or z.shape[1] % _BN_COLS:
        raise ValueError(f"pre-activations {tuple(z.shape)}: the width must be a "
                         f"multiple of {_BN_COLS}")
    N, H = z.shape
    if tuple(rows.shape) != (N, 1) or rows.dtype != torch.float32 or n.numel() != 1:
        raise ValueError("rows must be (N, 1) float32 and n one float32 value")
    for t in (z, rows, n, *vectors):
        if t.device != z.device or not t.is_contiguous():
            raise ValueError("every tensor must be contiguous on the pre-activations' device")
    for t in vectors:
        if tuple(t.shape) != (H,) or t.dtype != torch.float32:
            raise ValueError(f"per-feature tensors must be ({H},) float32")


def _bn_lib():
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    lib = load_kernel_library("bn_relu").lib
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bn_relu_forward.argtypes = [p] * 14 + [ll, i, i, ll, p]
    lib.bn_relu_backward.argtypes = [p] * 14 + [ll, i, i, ll, p]
    lib.bn_relu_forward.restype = lib.bn_relu_backward.restype = ctypes.c_int
    return lib


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _bn_relu_fwd_cuda(z, rows, n, scale, bias, running_mean):
    """K5's forward kernels (``bn_relu_forward``), the outputs of
    :func:`_bn_relu_fwd_plain`; scale/istd/inv/shift come back float32."""
    n = n.reshape(1).float().contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    r = running_mean.detach().float().contiguous()
    _check_bn_cuda(z, rows, n, (scale, bias, r))
    N, H = z.shape
    chunks, per = _chunks(N)
    f32 = dict(dtype=torch.float32, device=z.device)
    part1, part2 = torch.empty(chunks, H, **f32), torch.empty(chunks, H, **f32)
    mean, var, istd, inv, shift = (torch.empty(H, **f32) for _ in range(5))
    y = torch.empty_like(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        _raise_on(_bn_lib().bn_relu_forward(
            z.data_ptr(), rows.data_ptr(), n.data_ptr(), r.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), part1.data_ptr(), part2.data_ptr(), mean.data_ptr(),
            var.data_ptr(), istd.data_ptr(), inv.data_ptr(), shift.data_ptr(), y.data_ptr(),
            N, H, chunks, per, stream), "bn_relu_forward")
        _count("bn_relu_forward")
    return y, mean, var, istd, inv, shift


def _bn_relu_grads_cuda(z, dy, rows, n, scale, mean, istd, inv, shift):
    """K5's backward kernels (``bn_relu_backward``): ``(dz, dscale,
    dbias)`` as :func:`_bn_relu_grads`."""
    dy = dy.to(z.dtype).contiguous()
    n = n.reshape(1).float().contiguous()
    scale_f = scale.float().contiguous()
    _check_bn_cuda(z, rows, n, (scale_f, mean, istd, inv, shift))
    if dy.shape != z.shape or dy.device != z.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not match z {tuple(z.shape)}")
    N, H = z.shape
    chunks, per = _chunks(N)
    f32 = dict(dtype=torch.float32, device=z.device)
    part1, part2 = torch.empty(chunks, H, **f32), torch.empty(chunks, H, **f32)
    G1, G2 = torch.empty(H, **f32), torch.empty(H, **f32)
    dz = torch.empty_like(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        _raise_on(_bn_lib().bn_relu_backward(
            z.data_ptr(), dy.data_ptr(), rows.data_ptr(), n.data_ptr(), scale_f.data_ptr(),
            mean.data_ptr(), istd.data_ptr(), inv.data_ptr(), shift.data_ptr(),
            part1.data_ptr(), part2.data_ptr(), G1.data_ptr(), G2.data_ptr(), dz.data_ptr(),
            N, H, chunks, per, stream), "bn_relu_backward")
        _count("bn_relu_backward")
    return dz, G2.to(scale.dtype), G1.to(scale.dtype)


class _BnRelu(torch.autograd.Function):
    """Masked BN + ReLU, ``(y, mean, var)``; mean and var feed the running
    statistics only and carry no gradient.  ``fwd``/``grads`` are the plain
    or the kernel implementations."""

    @staticmethod
    def forward(ctx, z, rows, n, scale, bias, running_mean, fwd, grads):
        z = z.contiguous()
        y, mean, var, istd, inv, shift = fwd(z, rows, n, scale, bias, running_mean)
        ctx.save_for_backward(z, rows, n, scale, mean, istd, inv, shift)
        ctx.grads = grads
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        z, *rest = ctx.saved_tensors
        dz, dscale, dbias = ctx.grads(z, dy, *rest)
        return dz, None, None, dscale, dbias, None, None, None


def bn_relu(z: torch.Tensor, rows: torch.Tensor, n: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, running_mean: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked BN + ReLU of (N, H) pre-activations: ``(y, mean, var)``.

    ``rows`` (N, 1) float32 is the pair mask, ``n`` the masked count,
    ``running_mean`` the (detached) shift of the moments.  CPU tensors take
    the plain version, CUDA tensors the kernels."""
    if z.device.type == "cpu":
        return bn_relu_reference(z, rows, n, scale, bias, running_mean)
    if z.device.type == "cuda":
        return _BnRelu.apply(z, rows, n, scale, bias, running_mean, _bn_relu_fwd_cuda,
                             _bn_relu_grads_cuda)
    raise ValueError(f"no BN+ReLU for device {z.device}")


def bn_relu_reference(z, rows, n, scale, bias, running_mean):
    """:func:`bn_relu` through its plain version, on any device."""
    return _BnRelu.apply(z, rows, n, scale, bias, running_mean, _bn_relu_fwd_plain,
                         _bn_relu_grads)


# ----------------------------------------------------------------------
# K4: the first hidden GEMM over all pairs


def _pair_x1(a2: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """``relu(a2[b] + c2[l])`` as (B * L, H), in a2's dtype."""
    B, L = a2.shape[0], c2.shape[0]
    return torch.relu(a2[:, None, :] + c2[None, :, :]).reshape(B * L, -1)


def _pair_hidden_backward(a2, c2, w, dz):
    """K4's backward in plain PyTorch: ``(da2, dc2, dw)`` in the compute
    dtype.  x1 is formed again; the gate ``x1 > 0`` is the ReLU's
    ``pre > 0``."""
    B, L = a2.shape[0], c2.shape[0]
    x1 = _pair_x1(a2, c2)
    dw = x1.T @ dz
    gate = x1 > 0
    del x1
    dx1 = dz @ w.T
    dx1.mul_(gate)
    del gate
    dx1 = dx1.view(B, L, -1)
    return dx1.sum(1), dx1.sum(0), dw


def _pair_hidden_fwd_plain(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4's forward in plain PyTorch: x1 materialised, then one product."""
    return _pair_x1(a2, c2) @ w


_K4_BLOCK_N, _K4_BLOCK_K, _K4_BLOCK_M = 128, 32, 128
_K4_MAX_ROW_BLOCKS = 65535  # the kernel's grid.y


def _check_pair_cuda(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> None:
    if a2.device.type != "cuda" or c2.device != a2.device or w.device != a2.device:
        raise ValueError("the CUDA pair-train kernel needs a2, c2 and w on one CUDA device")
    if {a2.dtype, c2.dtype, w.dtype} != {torch.bfloat16}:
        raise ValueError("the CUDA pair-train kernel computes in bfloat16 "
                         f"(MIXED_PRECISION: True), not {a2.dtype}/{c2.dtype}/{w.dtype}")
    if a2.dim() != 2 or c2.dim() != 2 or a2.shape[1] != c2.shape[1] or \
            w.shape[0] != a2.shape[1]:
        raise ValueError(f"a2 {tuple(a2.shape)}, c2 {tuple(c2.shape)}, w {tuple(w.shape)} "
                         "must be (B, K), (L, K), (K, N)")
    if a2.shape[1] % _K4_BLOCK_K or w.shape[1] % _K4_BLOCK_N:
        raise ValueError(f"widths {tuple(w.shape)} must be multiples of "
                         f"{_K4_BLOCK_K} (in) and {_K4_BLOCK_N} (out)")


def _pair_lib():
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    fn = load_kernel_library("pair_train").lib.pair_train_hidden
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _pair_hidden_fwd_cuda(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4's kernel (``csrc/pair_train.cu``), one launch per label chunk that
    keeps the grid within 65,535 row blocks (one chunk at the default
    width)."""
    a2, c2, w = a2.contiguous(), c2.contiguous(), w.contiguous()
    _check_pair_cuda(a2, c2, w)
    B, K = a2.shape
    L, N = c2.shape[0], w.shape[1]
    z = torch.empty(B * L, N, dtype=torch.bfloat16, device=a2.device)
    chunk = max(1, min(L, _K4_MAX_ROW_BLOCKS * _K4_BLOCK_M // B))
    fn = _pair_lib()
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        for l0 in range(0, L, chunk):
            nl = min(chunk, L - l0)
            _raise_on(fn(a2.data_ptr(), c2.data_ptr(), w.data_ptr(), z.data_ptr(),
                         nl, l0, L, B * nl, K, N, stream), "pair_train_hidden")
            _count("pair_train_hidden")
    return z


class _PairHidden(torch.autograd.Function):
    """``z = relu(a2[b] + c2[l]) @ w`` (B * L, H2) by ``fwd`` (the plain or
    the kernel forward); the backward is :func:`_pair_hidden_backward`."""

    @staticmethod
    def forward(ctx, a2, c2, w, fwd):
        ctx.save_for_backward(a2, c2, w)
        return fwd(a2, c2, w)

    @staticmethod
    def backward(ctx, dz):
        return (*_pair_hidden_backward(*ctx.saved_tensors, dz.contiguous()), None)


def pair_hidden(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``relu(a2[b] + c2[l]) @ w`` over all pairs, (B * L, H2) with rows
    ``b * L + l``, in the compute dtype.  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if a2.device.type == "cpu":
        return pair_hidden_reference(a2, c2, w)
    if a2.device.type == "cuda":
        return _PairHidden.apply(a2, c2, w, _pair_hidden_fwd_cuda)
    raise ValueError(f"no pair-train scorer for device {a2.device}")


def pair_hidden_reference(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`pair_hidden` through its plain version, on any device."""
    return _PairHidden.apply(a2, c2, w, _pair_hidden_fwd_plain)


# ----------------------------------------------------------------------
# the decomposed training scorer


def pair_logits_dense_decomposed(
    p: Params,
    s: Params,
    P_e: torch.Tensor,  # (B, d)
    L_e: torch.Tensor,  # (L, d)
    feature_fusion: str = "concatenation",
    example_mask: Optional[torch.Tensor] = None,  # (B,)
    label_mask: Optional[torch.Tensor] = None,  # (L,)
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, list]]:
    """Train-mode forward over every (sequence, label) pair:
    ``((B, L) float32 logits, {"bns": new running statistics})``, through
    K4 and K5 (their plain versions for CPU tensors).

    ``TRAIN_FUSED_BN_VJP`` is ignored: its two JAX settings compute one
    function, and the port always runs K5's two-pass backward.  ``remat``
    (GRADIENT_CHECKPOINTING) raises."""
    return _decomposed(p, s, P_e, L_e, feature_fusion, example_mask, label_mask,
                       compute_dtype, remat, pair_hidden, bn_relu)


def pair_logits_dense_decomposed_reference(
    p: Params,
    s: Params,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    feature_fusion: str = "concatenation",
    example_mask: Optional[torch.Tensor] = None,
    label_mask: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, list]]:
    """:func:`pair_logits_dense_decomposed` through the plain versions of K4
    and K5, on any device."""
    return _decomposed(p, s, P_e, L_e, feature_fusion, example_mask, label_mask,
                       compute_dtype, remat, pair_hidden_reference, bn_relu_reference)


def _decomposed(p, s, P_e, L_e, feature_fusion, example_mask, label_mask, compute_dtype,
                remat, hidden_fn, bn_relu_fn):
    if remat:
        raise NotImplementedError(CHECKPOINTING_LATER)
    if feature_fusion not in ("concatenation", "concatenation_diff"):
        raise ValueError(f"decomposed path does not support {feature_fusion}")
    if s is None:
        raise ValueError("decomposed path requires BatchNorm state")
    B, d = P_e.shape
    L = L_e.shape[0]
    dev = P_e.device
    em = (torch.ones(B, device=dev) if example_mask is None else example_mask).float()
    lm = (torch.ones(L, device=dev) if label_mask is None else label_mask).float()

    layers, bns = p["layers"], p["bns"]
    W1 = layers[0]["kernel"].float()
    w1_p, w1_l = W1[:d], W1[d : 2 * d]
    if feature_fusion == "concatenation_diff":
        w1_x = W1[2 * d : 3 * d]
        w1_p = w1_p + w1_x
        w1_l = w1_l - w1_x
    a = _f32_product(P_e, w1_p, compute_dtype)
    c = _f32_product(L_e, w1_l, compute_dtype)
    if "bias" in layers[0]:
        c = c + layers[0]["bias"].float()
    rows = (em[:, None] * lm[None, :]).reshape(B * L, 1)

    # analytic layer-1 statistics from the per-side tensors (float32)
    mean_a, var_a, n_b = _masked_moments(a, em[:, None])
    mean_c, var_c, n_l = _masked_moments(c, lm[:, None])
    mean1, var1, n_pairs = mean_a + mean_c, var_a + var_c, n_b * n_l
    inv1, shift1 = _affine(bns[0]["scale"], bns[0]["bias"], mean1, var1)
    new_bns = [_update_running(s["bns"][0], mean1, var1, n_pairs)]
    # the affine distributed to the sides before the broadcast
    a2 = (a * inv1).to(compute_dtype)
    c2 = (c * inv1 + shift1).to(compute_dtype)
    if len(layers) == 1:
        h = _pair_x1(a2, c2)
    for i in range(1, len(layers)):
        if i == 1:
            z = hidden_fn(a2, c2, layers[1]["kernel"].to(compute_dtype))
            if "bias" in layers[1]:
                z = z + layers[1]["bias"].to(compute_dtype)
        else:
            z = linear(layers[i], h)
        h, mean_i, var_i = bn_relu_fn(z, rows, n_pairs, bns[i]["scale"], bns[i]["bias"],
                                      s["bns"][i]["mean"])
        new_bns.append(_update_running(s["bns"][i], mean_i, var_i, n_pairs))
    out = linear(p["out"], h)[..., 0].float()
    return out.reshape(B, L), {"bns": new_bns}


def pair_logits_streaming_train(*args, **kwargs):
    """K6 is not ported; see :data:`STREAMING_LATER`."""
    raise NotImplementedError(STREAMING_LATER)
