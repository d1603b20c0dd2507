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
  ``x1 = relu(a2[b] + c2[l])`` formed in the GEMM's A-operand registers, so
  x1 never exists in memory; one persistent launch over all pairs, its
  tiles laid out by :func:`pair_train_plan`.
* **K4-bwd** (``csrc/pair_train_bwd.cu``), the backward of K4 as two
  kernels: ``pair_train_dx`` computes ``dx1 = bf16(dz @ W2^T)`` gated by
  ``a2[b] + c2[l] > 0`` and reduces it to ``da2`` and ``dc2`` in its
  epilogue (:func:`pair_dx_plan`); ``pair_train_dw`` computes
  ``dW2 = x1^T @ dz`` with x1 formed in its operand staging, the pair rows
  split into ranges whose f32 partial sums a second pass adds
  (:func:`pair_dw_plan`).  Neither x1, its gate nor dx1 is stored.
* **K5** (:func:`bn_relu`, ``csrc/bn_relu.cu``): masked BN + ReLU whose
  residual is only the bf16 pre-activation; forward one moment pass and one
  elementwise pass, backward one pass for ``sum g`` and ``sum g * xhat`` and
  one for ``dz`` (the JAX ``_bn_relu`` custom VJP).  It serves every layer
  after the first.

In float32 (``MIXED_PRECISION False``) the same chain runs through the
float32 forms: K4 is ``csrc/pair_scorer_f32.cu:pair_train_hidden_f32`` (K1's
float32 mainloop, the products split into bf16 pieces, :func:`stacked_pieces`),
K4-bwd ``csrc/pair_train_bwd_f32.cu`` (``pair_train_dx_f32``: a block a
(label tile, 64 input columns) walking every sequence, dc2's sums in
registers, da2's partials a label tile and an ordered sum;
``pair_train_dw_f32``: ``dW^T = dz^T @ x1`` with x1's pieces formed in shared
memory, on :func:`pair_dw_plan`'s 128-column tiles), and K5
``bn_relu_forward_f32`` / ``bn_relu_backward_f32`` (K5's kernels on float32
elements).  Nothing is rounded to bf16 but the split's exact pieces.  The
streamed scorer's kernels (K6) have their float32 forms too (the ``_f32``
entry points of ``csrc/streamed_bn.cu``), with the head's h, w and ``dh =
dout * w`` kept in float32.

The streamed scorer (:func:`pair_logits_streaming_train`,
``TRAIN_STREAMING_LABEL_TILE``) computes the same function in O(B * tile *
H) memory: the labels are cut into tiles and each later layer's statistics
are summed over one sweep of every tile, each tile under
``torch.utils.checkpoint`` so that the backward recomputes it.  Three
kernel families of ``csrc/streamed_bn.cu`` (K6) carry a tile's (B * tile,
H) tensors beside K4 and K4-bwd:

* :func:`stream_moments`: the tile's masked shifted column sums ``sum
  rows * (z - r)`` and ``sum rows * (z - r)^2``; backward ``dz = rows * (g1
  + 2 * g2 * (z - r))``;
* :func:`affine_relu`: ``relu(f32(z) * inv + shift)`` with an affine that
  earlier sweeps took; backward ``dz``, ``dinv``, ``dshift`` in one sweep;
* :func:`stream_head`: the last layer's affine + ReLU fused with the output
  matvec, so the last activations are never stored; backward ``dz``,
  ``dinv``, ``dshift``, ``dw_out``, ``db_out`` in one sweep.

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

``remat`` (GRADIENT_CHECKPOINTING) recomputes the block after the per-side
products in the backward, as the JAX path's ``jax.checkpoint(post)``:
``torch.utils.checkpoint`` around it, so K4 and K5 run again through their
autograd Functions and only ``a``, ``c`` and the inputs are kept.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from protnote_tpu_torch.models.layers import Params, gemm_precision, linear
from protnote_tpu_torch.ops.pair_scorer import (
    _BLOCK_N,
    _H100_SMS,
    BLOCK_M,
    BN_EPS,
    _block_n,
    _f32_product,
    stacked_pieces,
)

BN_MOMENTUM = 0.1  # torch BatchNorm1d default, as the JAX package

# Launches of each kernel entry point since the process started (or since a
# caller last set them to 0).
LAUNCHES = {"pair_train_hidden": 0, "pair_train_dx": 0, "pair_train_dw": 0,
            "bn_relu_forward": 0, "bn_relu_backward": 0,
            "pair_train_hidden_f32": 0, "pair_train_dx_f32": 0, "pair_train_dw_f32": 0,
            "bn_relu_forward_f32": 0, "bn_relu_backward_f32": 0,
            "stream_moments": 0, "stream_moments_backward": 0, "affine_relu": 0,
            "affine_relu_backward": 0, "stream_head": 0, "stream_head_backward": 0,
            "stream_moments_f32": 0, "stream_moments_backward_f32": 0, "affine_relu_f32": 0,
            "affine_relu_backward_f32": 0, "stream_head_f32": 0,
            "stream_head_backward_f32": 0}
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


def _check_bn_cuda(z: torch.Tensor, rows: Optional[torch.Tensor], n: Optional[torch.Tensor],
                   vectors) -> None:
    """The inputs that K5's and K6's column kernels take: (N, H) ``z`` with
    H a multiple of 256, bfloat16 (or float32: the ``_f32`` forms), ``rows``
    (N, 1) and ``n`` one value where the kernel reads them, (H,) float32
    ``vectors``, all contiguous on z's CUDA device."""
    if z.device.type != "cuda":
        raise ValueError(f"the CUDA BN kernels need CUDA tensors, not {z.device}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA BN kernels take bfloat16 or float32 pre-activations, not "
                         f"{z.dtype}")
    if z.dim() != 2 or z.shape[1] % _BN_COLS:
        raise ValueError(f"pre-activations {tuple(z.shape)}: the width must be a "
                         f"multiple of {_BN_COLS}")
    N, H = z.shape
    if rows is not None and (tuple(rows.shape) != (N, 1) or rows.dtype != torch.float32):
        raise ValueError("rows must be (N, 1) float32")
    if n is not None and n.numel() != 1:
        raise ValueError("n must be one float32 value")
    for t in (z, rows, n, *vectors):
        if t is not None and (t.device != z.device or not t.is_contiguous()):
            raise ValueError("every tensor must be contiguous on the pre-activations' device")
    for t in vectors:
        if tuple(t.shape) != (H,) or t.dtype != torch.float32:
            raise ValueError(f"per-feature tensors must be ({H},) float32")


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_BN_ARGS = [_P] * 14 + [_LL, _I, _I, _LL, _P]


def _bn_fn(symbol: str):
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("bn_relu", symbol, _BN_ARGS)


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _symbol(z: torch.Tensor, name: str) -> str:
    """A kernel's entry point for z's dtype: ``name``, or its float32 form."""
    return f"{name}_f32" if z.dtype == torch.float32 else name


def _bn_relu_fwd_cuda(z, rows, n, scale, bias, running_mean):
    """K5's forward kernels (``bn_relu_forward``, or ``bn_relu_forward_f32``
    for float32 z), the outputs of :func:`_bn_relu_fwd_plain`;
    scale/istd/inv/shift come back float32."""
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
    symbol = _symbol(z, "bn_relu_forward")
    with torch.cuda.device(z.device):
        _raise_on(_bn_fn(symbol)(
            z.data_ptr(), rows.data_ptr(), n.data_ptr(), r.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), part1.data_ptr(), part2.data_ptr(), mean.data_ptr(),
            var.data_ptr(), istd.data_ptr(), inv.data_ptr(), shift.data_ptr(), y.data_ptr(),
            N, H, chunks, per, stream), symbol)
        _count(symbol)
    return y, mean, var, istd, inv, shift


def _bn_relu_grads_cuda(z, dy, rows, n, scale, mean, istd, inv, shift):
    """K5's backward kernels (``bn_relu_backward``, or
    ``bn_relu_backward_f32`` for float32 z): ``(dz, dscale, dbias)`` as
    :func:`_bn_relu_grads`."""
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
    symbol = _symbol(z, "bn_relu_backward")
    with torch.cuda.device(z.device):
        _raise_on(_bn_fn(symbol)(
            z.data_ptr(), dy.data_ptr(), rows.data_ptr(), n.data_ptr(), scale_f.data_ptr(),
            mean.data_ptr(), istd.data_ptr(), inv.data_ptr(), shift.data_ptr(),
            part1.data_ptr(), part2.data_ptr(), G1.data_ptr(), G2.data_ptr(), dz.data_ptr(),
            N, H, chunks, per, stream), symbol)
        _count(symbol)
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


def _pair_hidden_backward_plain(a2, c2, w, dz):
    """K4's backward in plain PyTorch: ``(da2, dc2, dw)`` in the compute
    dtype.  x1 is formed again; the gate ``x1 > 0`` is the ReLU's
    ``pre > 0``; dx1 is rounded to the compute dtype before its sums."""
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


_K4_STORE_BOX = 64  # rows and columns of one TMA store box (a warpgroup's rows)


@dataclass(frozen=True)
class PairTrainPlan:
    """K4's launch geometry (K1's tiles, ``csrc/pair_train.cu``): ``tiles``
    tiles of ``BLOCK_M`` labels of one sequence x ``block_n`` columns,
    walked by ``grid`` persistent blocks (block i takes tiles i, i + grid,
    ...).  Tile t is column tile ``t % tiles_n`` of sequence
    ``(t // tiles_n) % batch`` in label tile ``t // (tiles_n * batch)``:
    label tiles outermost, so the blocks in flight share one c2 tile and W
    in L2 (the kernel's ``tile_at``)."""

    batch: int
    labels: int
    width_in: int  # K
    width_out: int  # N
    block_n: int
    tiles_l: int  # label tiles a sequence: ceil(L / BLOCK_M)
    tiles_n: int  # column tiles: N / block_n
    grid: int

    @property
    def tiles(self) -> int:
        return self.tiles_l * self.batch * self.tiles_n

    def tile(self, t: int) -> Tuple[int, int, int]:
        """(sequence b, first label l0, first column n0) of tile t."""
        u, nt = divmod(t, self.tiles_n)
        lt, b = divmod(u, self.batch)
        return b, lt * BLOCK_M, nt * self.block_n

    def stores(self, t: int) -> List[Tuple[int, int, int, int, int]]:
        """The z elements tile t writes, as (b, l_start, l_stop, n_start,
        n_stop) boxes: one 64 x 64 box for each 64 rows (a warpgroup's) and
        64 columns, through the 3-D map over z as (B, L, N), which clips rows
        at L (a box wholly past L writes nothing and is left out)."""
        b, l0, n0 = self.tile(t)
        out = []
        for r0 in range(l0, min(l0 + BLOCK_M, self.labels), _K4_STORE_BOX):
            for c0 in range(n0, n0 + self.block_n, _K4_STORE_BOX):
                out.append((b, r0, min(r0 + _K4_STORE_BOX, self.labels), c0,
                            c0 + _K4_STORE_BOX))
        return out


def pair_train_plan(B: int, L: int, K: int, N: int, num_sms: int = _H100_SMS) -> PairTrainPlan:
    """K4's plan for a2 (B, K), c2 (L, K) and W (K, N).  The column tile is
    256 where N allows it, else 128.  Raises for widths the kernel does not
    take: K and N must be multiples of 128."""
    if B <= 0 or L <= 0 or num_sms <= 0:
        raise ValueError(f"no K4 plan for B {B}, L {L} on {num_sms} SMs")
    if K <= 0 or N <= 0 or K % _BLOCK_N or N % _BLOCK_N:
        raise ValueError(f"the CUDA pair-train kernel takes widths (in {K}, out {N}) that are "
                         f"multiples of {_BLOCK_N}")
    block_n = _block_n(N)
    tiles_l, tiles_n = -(-L // BLOCK_M), N // block_n
    if tiles_l * B * tiles_n > 2**31 - 1:
        raise ValueError(f"B {B} x L {L} x N {N}: more tiles than the kernel counts")
    return PairTrainPlan(B, L, K, N, block_n, tiles_l, tiles_n,
                         min(num_sms, tiles_l * B * tiles_n))


def _check_pair_cuda(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> None:
    """K4's and K4-bwd's operands: on one CUDA device, all bfloat16 or all
    float32 (the float32 forms)."""
    if a2.device.type != "cuda" or c2.device != a2.device or w.device != a2.device:
        raise ValueError("the CUDA pair-train kernel needs a2, c2 and w on one CUDA device")
    if {a2.dtype, c2.dtype, w.dtype} not in ({torch.bfloat16}, {torch.float32}):
        raise ValueError("the CUDA pair-train kernels compute in bfloat16 or in float32, all "
                         f"operands alike, not {a2.dtype}/{c2.dtype}/{w.dtype}")
    if a2.dim() != 2 or c2.dim() != 2 or w.dim() != 2 or a2.shape[1] != c2.shape[1] or \
            w.shape[0] != a2.shape[1]:
        raise ValueError(f"a2 {tuple(a2.shape)}, c2 {tuple(c2.shape)}, w {tuple(w.shape)} "
                         "must be (B, K), (L, K), (K, N)")


def _pair_fn():
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_train", "pair_train_hidden", [_P] * 4 + [_I] * 6 + [_P])


def _pair_f32_fn():
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_scorer_f32", "pair_train_hidden_f32", [_P] * 4 + [_I] * 5 + [_P])


# K4's float32 forms (csrc/pair_scorer_f32.cu, csrc/pair_train_bwd_f32.cu):
# tiles and the shared memory each launch asks for, as the sources lay it out
F32_TILE = 128  # rows and columns of a forward tile; the dW tile; a dX label tile
F32_DX_COLS = 64  # input columns of a dX tile
F32_STORE_ROWS, F32_STORE_COLS = 64, 32  # one float32 TMA store box of the forward
SMEM_LIMIT = 232448  # the shared memory a block may use on an H100


def f32_train_smem_bytes() -> Dict[str, int]:
    """The dynamic shared memory of the float32 K4 forward (K1's A_PAIR
    layout with store boxes: two 80 KB stages), dX (three 56 KB stages and
    the da2 reduction's two slots) and dW (two 64 KB stages and two piece
    buffers of 48 KB), each with its 1 KB alignment slack and mbarriers."""
    stage = 3 * F32_TILE * 64 * 2 + 2 * F32_TILE * 32 * 4
    epi = 2 * 2 * F32_STORE_ROWS * 128
    fit = (SMEM_LIMIT - 1024 - 256 - epi) // (stage + 256)
    stages = min(fit, 4)
    forward = 1024 + stages * stage + epi + stages * 256 + 2 * stages * 8
    dx_stage = 3 * F32_DX_COLS * 64 * 2 + 2 * F32_TILE * 32 * 4
    dx = 1024 + 3 * dx_stage + 2 * 8 * F32_DX_COLS * 4 + 2 * 3 * 8
    dw = 1024 + 2 * (8 * 64 * 32 * 4) + 2 * 3 * F32_TILE * 64 * 2 + 2 * 2 * 8
    return {"forward": forward, "dx": dx, "dw": dw}


@dataclass(frozen=True)
class PairTrainF32Plan:
    """The float32 K4 forward's launch geometry: each sequence's labels
    padded to ``nl_pad`` (a multiple of 128), ``tiles`` 128 x 128 tiles of
    one sequence's labels walked by ``grid`` persistent blocks, column tiles
    fastest (tile t is row tile ``t // tiles_n``: sequence ``r // tiles_l``,
    labels ``(r % tiles_l) * 128``)."""

    batch: int
    labels: int
    width_in: int  # K
    width_out: int  # N
    tiles_l: int
    tiles_n: int
    grid: int

    @property
    def nl_pad(self) -> int:
        return self.tiles_l * F32_TILE

    @property
    def tiles(self) -> int:
        return self.batch * self.tiles_l * self.tiles_n

    def tile(self, t: int) -> Tuple[int, int, int]:
        """(sequence b, first label l0, first column n0) of tile t."""
        r, nt = divmod(t, self.tiles_n)
        b, lt = divmod(r, self.tiles_l)
        return b, lt * F32_TILE, nt * F32_TILE

    def stores(self, t: int) -> List[Tuple[int, int, int, int, int]]:
        """The z elements tile t writes, as (b, l_start, l_stop, n_start,
        n_stop): a 64-row x 32-column box for each warpgroup and 32 columns,
        through the 3-D map over (B, L, N) that clips rows at L (a box wholly
        past L is left out)."""
        b, l0, n0 = self.tile(t)
        return [(b, r0, min(r0 + F32_STORE_ROWS, self.labels), c0, c0 + F32_STORE_COLS)
                for r0 in range(l0, min(l0 + F32_TILE, self.labels), F32_STORE_ROWS)
                for c0 in range(n0, n0 + F32_TILE, F32_STORE_COLS)]


def pair_train_f32_plan(B: int, L: int, K: int, N: int,
                        num_sms: int = _H100_SMS) -> PairTrainF32Plan:
    """The float32 K4 forward's plan for a2 (B, K), c2 (L, K), W (K, N).
    Raises for widths the kernel does not take: K and N multiples of 128."""
    if B <= 0 or L <= 0 or num_sms <= 0:
        raise ValueError(f"no float32 K4 plan for B {B}, L {L} on {num_sms} SMs")
    if K <= 0 or N <= 0 or K % F32_TILE or N % F32_TILE:
        raise ValueError(f"the float32 pair-train kernels take widths (in {K}, out {N}) that "
                         f"are multiples of {F32_TILE}")
    tiles_l, tiles_n = -(-L // F32_TILE), N // F32_TILE
    if B * tiles_l * tiles_n > 2**31 - 1:
        raise ValueError(f"B {B} x L {L} x N {N}: more tiles than the kernel counts")
    return PairTrainF32Plan(B, L, K, N, tiles_l, tiles_n, min(num_sms, B * tiles_l * tiles_n))


@dataclass(frozen=True)
class PairDxF32Plan:
    """The float32 dX kernel's schedule (``pair_train_dx_f32``): ``units``
    (label tile of 128, 64 input columns) walked by ``grid`` persistent
    blocks, column tiles fastest; each unit runs every sequence in order and
    writes its dc2 rows and one da2 partial a sequence, which a second
    kernel adds over the ``tiles_l`` label tiles in order."""

    batch: int
    labels: int
    width_in: int  # K
    width_out: int  # N
    tiles_l: int
    tiles_k: int
    grid: int

    @property
    def units(self) -> int:
        return self.tiles_l * self.tiles_k

    def unit(self, u: int) -> Tuple[int, int]:
        """(first label l0, first input column k0) of unit u."""
        lt, kt = divmod(u, self.tiles_k)
        return lt * F32_TILE, kt * F32_DX_COLS


def pair_dx_f32_plan(B: int, L: int, K: int, N: int, num_sms: int = _H100_SMS) -> PairDxF32Plan:
    """The float32 dX kernel's plan: K a multiple of 128, N of 64."""
    if B <= 0 or L <= 0 or num_sms <= 0:
        raise ValueError(f"no float32 K4-bwd plan for B {B}, L {L} on {num_sms} SMs")
    if K <= 0 or N <= 0 or K % F32_TILE or N % F32_DX_COLS:
        raise ValueError(f"the float32 pair-train kernels take widths (in {K}, out {N}) that "
                         f"are multiples of {F32_TILE}")
    tiles_l, tiles_k = -(-L // F32_TILE), K // F32_DX_COLS
    if tiles_l * tiles_k > 2**31 - 1:
        raise ValueError(f"L {L} x K {K}: more units than the kernel counts")
    return PairDxF32Plan(B, L, K, N, tiles_l, tiles_k, min(num_sms, tiles_l * tiles_k))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pair_hidden_fwd_f32_cuda(a2, c2, w):
    """K4's float32 form (``pair_train_hidden_f32``), one launch over all
    pairs: W split into its bf16 pieces once a call."""
    B, K = a2.shape
    L, N = c2.shape[0], w.shape[1]
    plan = pair_train_f32_plan(B, L, K, N, _sms(a2.device))
    wt3 = stacked_pieces(w, transpose=True)
    z = torch.empty(B * L, N, dtype=torch.float32, device=a2.device)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        _raise_on(_pair_f32_fn()(a2.data_ptr(), c2.data_ptr(), wt3.data_ptr(), z.data_ptr(), B,
                                 L, K, N, plan.grid, stream), "pair_train_hidden_f32")
        _count("pair_train_hidden_f32")
    return z


def _pair_hidden_fwd_cuda(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4's kernel (``csrc/pair_train.cu``), one launch over all pairs.  W is
    transposed once a call into the K-major layout of the kernel's TMA box
    (18 MB at H 3072, a few microseconds; W changes every step)."""
    a2, c2 = a2.contiguous(), c2.contiguous()
    _check_pair_cuda(a2, c2, w)
    if a2.dtype == torch.float32:
        return _pair_hidden_fwd_f32_cuda(a2, c2, w)
    B, K = a2.shape
    L, N = c2.shape[0], w.shape[1]
    plan = pair_train_plan(B, L, K, N,
                           torch.cuda.get_device_properties(a2.device).multi_processor_count)
    wt = w.t().contiguous()
    z = torch.empty(B * L, N, dtype=torch.bfloat16, device=a2.device)
    fn = _pair_fn()
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        _raise_on(fn(a2.data_ptr(), c2.data_ptr(), wt.data_ptr(), z.data_ptr(), B, L, K, N,
                     plan.block_n, plan.grid, stream), "pair_train_hidden")
        _count("pair_train_hidden")
    return z


# ----------------------------------------------------------------------
# K4-bwd: dX with the gate and side sums, and dW with x1 formed on chip

_DX_LABELS = 64  # labels of a dX tile: each consumer warpgroup's rows, one sequence each
_DX_COLS = 256  # input columns of a dX tile (csrc/pair_train_bwd.cu DX_BN)
_DX_STAGE_BYTES = 2 * _DX_LABELS * 64 * 2 + _DX_COLS * 64 * 2  # two dz boxes + the W box
_DW_ROWS = 64  # labels of a dW label block
_DW_C_BYTES = 2 * 64 * 64 * 2  # a label block's c2: two 64 x 64 boxes


def _part(i: int, n: int, parts: int) -> int:
    """The first of n things in part i of ``parts`` (the kernels'
    ``part_begin``): parts differ in size by at most one."""
    return i * n // parts


@dataclass(frozen=True)
class PairDxPlan:
    """The dX kernel's schedule (``pair_train_dx``): ``grid`` = tiles_k x
    ranges x groups blocks, one launch.  Block i owns column tile ``i %
    tiles_k`` (256 input columns), a contiguous range of 64-label tiles
    (``ranges`` ranges) and a contiguous range of sequence pairs (``groups``
    groups of the ceil(B / 2) pairs (2p, 2p + 1)); it walks its label tiles
    in order and, in each, its pairs in order, warpgroup 0 on sequence 2p
    and warpgroup 1 on 2p + 1 (2p + 1 = B, for odd B, is zeros).  Each pair
    reduces over N in 64-column stages; dc2's f32 sum over the pairs stays in
    shared memory and is stored once a unit (as bf16, or as the group's f32
    partial when groups > 1), da2's column sums are added in label-tile
    order into the block's row of a (ranges, B, K) f32 scratch, and a second
    kernel adds the ranges (and the groups) in order.  The ranges are as
    many as the column tiles leave SMs for (11 at K 3072 on 132 SMs), so the
    blocks of one range read the same dz rows at once; groups split the
    pairs only where label tiles are too few to fill the card (small L)."""

    batch: int
    labels: int
    width_in: int  # K
    width_out: int  # N
    tiles_l: int  # ceil(L / 64)
    tiles_k: int  # ceil(K / 256): the last holds 128 real columns when K / 128 is odd
    ranges: int
    groups: int

    @property
    def pairs(self) -> int:
        return -(-self.batch // 2)

    @property
    def grid(self) -> int:
        return self.tiles_k * self.ranges * self.groups

    def block(self, i: int) -> Tuple[int, int, Tuple[int, int], Tuple[int, int]]:
        """(label range r, first input column k0, label tiles [lt0, lt1),
        pairs [p0, p1)) of block i (group i // (tiles_k * ranges))."""
        kt, r = i % self.tiles_k, (i // self.tiles_k) % self.ranges
        g = i // (self.tiles_k * self.ranges)
        return (r, kt * _DX_COLS, (_part(r, self.tiles_l, self.ranges),
                                   _part(r + 1, self.tiles_l, self.ranges)),
                (_part(g, self.pairs, self.groups), _part(g + 1, self.pairs, self.groups)))

    @property
    def smem_bytes_per_kflop(self) -> float:
        """Bytes a stage brings into shared memory for each kFLOP of its
        products (the padded tile's: 2 x 64 labels x 256 columns x 64)."""
        return _DX_STAGE_BYTES / (2.0 * 2 * _DX_LABELS * _DX_COLS * 64 / 1e3)


def pair_dx_plan(B: int, L: int, K: int, N: int, num_sms: int = _H100_SMS) -> PairDxPlan:
    """The dX kernel's plan for a2 (B, K), c2 (L, K), W (K, N) and dz (B * L,
    N).  Raises for widths it does not take: K a multiple of 128, N of 64."""
    if B <= 0 or L <= 0 or num_sms <= 0:
        raise ValueError(f"no K4-bwd plan for B {B}, L {L} on {num_sms} SMs")
    if K <= 0 or N <= 0 or K % _BLOCK_N or N % _DW_ROWS:
        raise ValueError(f"the CUDA pair-train backward takes widths (in {K}, out {N}) that "
                         f"are multiples of {_BLOCK_N}")
    tiles_l, tiles_k = -(-L // _DX_LABELS), -(-K // _DX_COLS)
    ranges = min(tiles_l, max(1, num_sms // tiles_k))
    groups = min(-(-B // 2), max(1, num_sms // (tiles_k * ranges)))
    if tiles_k * ranges * groups > 2**31 - 1:
        raise ValueError(f"L {L} x K {K}: more blocks than the kernel counts")
    return PairDxPlan(B, L, K, N, tiles_l, tiles_k, ranges, groups)


@dataclass(frozen=True)
class PairDwPlan:
    """The dW kernel's schedule (``pair_train_dw``): ``items`` work items
    walked by ``grid`` persistent blocks (block i takes items i, i + grid,
    ...).  An output tile is 128 rows (input columns k) x ``block_n`` (256,
    or 128 where N is an odd multiple of 128) columns (output columns n); its
    reduction runs over 64-label blocks (``lblocks`` = ceil(L / 64)), label
    block outermost and every sequence inside it.  Tiles 0 .. full-1 (the
    whole waves of the card's SMs) are items 0 .. full-1, each the whole
    reduction, stored as bf16; each of the other ``tail`` tiles is cut into
    ``pieces`` ranges of label blocks, item full + p * tail + t being range p
    of tile full + t, written as f32 partial sums to slot p * tail + t, which
    a second pass adds in range order.  Ordering the pieces range first keeps
    the blocks in flight on the same dz rows."""

    batch: int
    labels: int
    width_in: int  # K
    width_out: int  # N
    block_n: int
    tiles_m: int
    tiles_n: int
    full: int
    pieces: int
    grid: int

    @property
    def lblocks(self) -> int:
        return -(-self.labels // _DW_ROWS)

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def tail(self) -> int:
        return self.tiles - self.full

    @property
    def items(self) -> int:
        return self.full + self.tail * self.pieces

    @property
    def slots(self) -> int:
        """f32 partial tiles the pieces write (0 when every tile is whole)."""
        return self.tail * self.pieces if self.pieces > 1 else 0

    def item(self, t: int) -> Tuple[int, int, int, int, Optional[int]]:
        """(first input column m0, first output column n0, label blocks
        [lb0, lb1), partial slot or None for a whole tile) of item t."""
        tile, lb0, lb1, slot = t, 0, self.lblocks, None
        if t >= self.full:
            p, tt = divmod(t - self.full, self.tail)
            tile = self.full + tt
            if self.pieces > 1:
                lb0, lb1 = _part(p, self.lblocks, self.pieces), _part(p + 1, self.lblocks,
                                                                    self.pieces)
                slot = t - self.full
        mt, nt = divmod(tile, self.tiles_n)
        return mt * BLOCK_M, nt * self.block_n, lb0, lb1, slot

    @property
    def smem_bytes_per_kflop(self) -> float:
        """Bytes the stages bring into shared memory for each kFLOP of the
        products (the padded label blocks'): the dz boxes of every step and a
        label block's c2 once for its B steps."""
        step_flop = 2.0 * BLOCK_M * self.block_n * _DW_ROWS
        return (self.block_n * _DW_ROWS * 2 + _DW_C_BYTES / self.batch) / (step_flop / 1e3)


def pair_dw_plan(B: int, L: int, K: int, N: int, num_sms: int = _H100_SMS,
                 block_n: Optional[int] = None) -> PairDwPlan:
    """The dW kernel's plan for a2 (B, K), c2 (L, K) and dz (B * L, N): the
    column tile is 256 where N allows it, else 128 (``block_n`` 128: the
    float32 kernel's).  The whole waves run whole; the last wave's ``tail``
    tiles are cut into as many label-block ranges as fill the SMs that they
    leave (at the training shape 288 tiles on 132 SMs: 264 whole, 24 x 5
    pieces in one wave, 2.2 tile times a block where whole tiles take 3; in
    float32 576 tiles: 528 whole, 48 x 2 pieces).  Raises for widths it does
    not take: K and N multiples of 128."""
    if B <= 0 or L <= 0 or num_sms <= 0:
        raise ValueError(f"no K4-bwd plan for B {B}, L {L} on {num_sms} SMs")
    if K <= 0 or N <= 0 or K % _BLOCK_N or N % _BLOCK_N:
        raise ValueError(f"the CUDA pair-train backward takes widths (in {K}, out {N}) that "
                         f"are multiples of {_BLOCK_N}")
    block_n = block_n or _block_n(N)
    tiles_m, tiles_n = K // BLOCK_M, N // block_n
    tiles, lblocks = tiles_m * tiles_n, -(-L // _DW_ROWS)
    full = tiles // num_sms * num_sms
    tail = tiles - full
    pieces = max(1, min(num_sms // tail, lblocks)) if tail else 1
    items = full + tail * pieces
    if items > 2**31 - 1 or lblocks * B > 2**31 - 1:
        raise ValueError(f"B {B} x L {L}: more work items than the kernel counts")
    return PairDwPlan(B, L, K, N, block_n, tiles_m, tiles_n, full, pieces, min(num_sms, items))


def _dx_fn():
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_train_bwd", "pair_train_dx", [_P] * 8 + [_I] * 6 + [_P])


def _dw_fn():
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_train_bwd", "pair_train_dw", [_P] * 5 + [_I] * 8 + [_P])


def _pair_dx_cuda(a2, c2, w, dz, plan: PairDxPlan, stream: int):
    """The dX kernel on its plan: (da2, dc2) bf16, with the float32 scratch
    its sums need."""
    B, K = a2.shape
    L = c2.shape[0]
    f32 = dict(dtype=torch.float32, device=a2.device)
    da2_part = torch.empty(plan.ranges, B, K, **f32)
    dc2_part = torch.empty(plan.groups, L, K, **f32) if plan.groups > 1 else None
    da2 = torch.empty(B, K, dtype=torch.bfloat16, device=a2.device)
    dc2 = torch.empty(L, K, dtype=torch.bfloat16, device=a2.device)
    _raise_on(_dx_fn()(dz.data_ptr(), w.data_ptr(), a2.data_ptr(), c2.data_ptr(),
                       da2_part.data_ptr(), None if dc2_part is None else dc2_part.data_ptr(),
                       da2.data_ptr(), dc2.data_ptr(), B, L, K, plan.width_out, plan.ranges,
                       plan.groups, stream), "pair_train_dx")
    return da2, dc2


def _pair_dw_cuda(a2, c2, dz, plan: PairDwPlan, stream: int):
    """The dW kernel on its plan: dW bf16, with the float32 slots of its
    pieces."""
    B, K = a2.shape
    L, N = c2.shape[0], plan.width_out
    partial = (torch.empty(plan.slots, BLOCK_M, plan.block_n, dtype=torch.float32,
                           device=a2.device) if plan.slots else None)
    dw = torch.empty(K, N, dtype=torch.bfloat16, device=a2.device)
    _raise_on(_dw_fn()(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(),
                       None if partial is None else partial.data_ptr(), dw.data_ptr(), B, L, K,
                       N, plan.block_n, plan.full, plan.pieces, plan.grid, stream),
              "pair_train_dw")
    return dw


def _dx_f32_fn():
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_train_bwd_f32", "pair_train_dx_f32",
                           [_P] * 7 + [_I] * 5 + [_P])


def _dw_f32_fn():
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_train_bwd_f32", "pair_train_dw_f32",
                           [_P] * 5 + [_I] * 7 + [_P])


def _pair_dx_f32_cuda(a2, c2, w3, dz, plan: PairDxF32Plan, stream: int):
    """The float32 dX kernel on its plan: (da2, dc2) float32, with the
    (label tiles, B, K) partials of da2."""
    B, K = a2.shape
    L = c2.shape[0]
    f32 = dict(dtype=torch.float32, device=a2.device)
    da2_part = torch.empty(plan.tiles_l, B, K, **f32)
    da2, dc2 = torch.empty(B, K, **f32), torch.empty(L, K, **f32)
    _raise_on(_dx_f32_fn()(dz.data_ptr(), w3.data_ptr(), a2.data_ptr(), c2.data_ptr(),
                           da2_part.data_ptr(), da2.data_ptr(), dc2.data_ptr(), B, L, K,
                           plan.width_out, plan.grid, stream), "pair_train_dx_f32")
    return da2, dc2


def _pair_dw_f32_cuda(a2, c2, dz, plan: PairDwPlan, stream: int):
    """The float32 dW kernel on its plan (128-column tiles): dW float32,
    with the float32 slots of its pieces."""
    K, N = a2.shape[1], plan.width_out
    partial = (torch.empty(plan.slots, F32_TILE, F32_TILE, dtype=torch.float32,
                           device=a2.device) if plan.slots else None)
    dw = torch.empty(K, N, dtype=torch.float32, device=a2.device)
    _raise_on(_dw_f32_fn()(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(),
                           None if partial is None else partial.data_ptr(), dw.data_ptr(),
                           a2.shape[0], c2.shape[0], K, N, plan.full, plan.pieces, plan.grid,
                           stream), "pair_train_dw_f32")
    return dw


def _pair_hidden_backward_f32_cuda(a2, c2, w, dz):
    """K4-bwd's float32 kernels (``csrc/pair_train_bwd_f32.cu``): ``(da2,
    dc2, dw)`` float32, each sum in a fixed order; W split into its pieces
    once a call."""
    B, K = a2.shape
    L, N = c2.shape[0], w.shape[1]
    sms = _sms(a2.device)
    dx_plan = pair_dx_f32_plan(B, L, K, N, sms)
    dw_plan = pair_dw_plan(B, L, K, N, sms, block_n=F32_TILE)
    w3 = stacked_pieces(w, transpose=False)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        da2, dc2 = _pair_dx_f32_cuda(a2, c2, w3, dz, dx_plan, stream)
        _count("pair_train_dx_f32")
        dw = _pair_dw_f32_cuda(a2, c2, dz, dw_plan, stream)
        _count("pair_train_dw_f32")
    return da2, dc2, dw


def _pair_hidden_backward_cuda(a2, c2, w, dz):
    """K4-bwd's two kernels (``csrc/pair_train_bwd.cu``, or their float32
    forms for float32 operands): ``(da2, dc2, dw)`` in the operands' dtype
    as :func:`_pair_hidden_backward_plain`, each sum in a fixed order (the
    same bits every call)."""
    a2, c2, dz = a2.contiguous(), c2.contiguous(), dz.contiguous()
    w = w.contiguous()
    _check_pair_cuda(a2, c2, w)
    B, K = a2.shape
    L, N = c2.shape[0], w.shape[1]
    if tuple(dz.shape) != (B * L, N) or dz.dtype != a2.dtype or dz.device != a2.device:
        raise ValueError(f"dz {tuple(dz.shape)} {dz.dtype} does not match z ({B * L}, {N}) "
                         f"{a2.dtype} on the inputs' device")
    if a2.dtype == torch.float32:
        return _pair_hidden_backward_f32_cuda(a2, c2, w, dz)
    sms = torch.cuda.get_device_properties(a2.device).multi_processor_count
    dx_plan = pair_dx_plan(B, L, K, N, sms)
    dw_plan = pair_dw_plan(B, L, K, N, sms)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        da2, dc2 = _pair_dx_cuda(a2, c2, w, dz, dx_plan, stream)
        _count("pair_train_dx")
        dw = _pair_dw_cuda(a2, c2, dz, dw_plan, stream)
        _count("pair_train_dw")
    return da2, dc2, dw


class _PairHidden(torch.autograd.Function):
    """``z = relu(a2[b] + c2[l]) @ w`` (B * L, H2) by ``fwd``, its gradients
    by ``bwd`` (the plain or the kernel implementations)."""

    @staticmethod
    def forward(ctx, a2, c2, w, fwd, bwd):
        ctx.save_for_backward(a2, c2, w)
        ctx.bwd = bwd
        return fwd(a2, c2, w)

    @staticmethod
    def backward(ctx, dz):
        return (*ctx.bwd(*ctx.saved_tensors, dz.contiguous()), None, None)


def pair_hidden(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``relu(a2[b] + c2[l]) @ w`` over all pairs, (B * L, H2) with rows
    ``b * L + l``, in the compute dtype.  CPU tensors take the plain
    version, CUDA tensors the kernels (K4 forward, K4-bwd backward)."""
    if a2.device.type == "cpu":
        return pair_hidden_reference(a2, c2, w)
    if a2.device.type == "cuda":
        return _PairHidden.apply(a2, c2, w, _pair_hidden_fwd_cuda, _pair_hidden_backward_cuda)
    raise ValueError(f"no pair-train scorer for device {a2.device}")


def pair_hidden_reference(a2: torch.Tensor, c2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`pair_hidden` through its plain version, on any device."""
    return _PairHidden.apply(a2, c2, w, _pair_hidden_fwd_plain, _pair_hidden_backward_plain)


# ----------------------------------------------------------------------
# K6: the streamed scorer's passes over one label tile


def _stream_moments_plain(z, rows, r):
    """K6's ``stream_moments`` in plain PyTorch: ``(sum rows * zc, sum rows *
    zc^2)`` over the rows, ``zc = f32(z) - r`` (the JAX sweeps' per-tile
    sums, before the division by the pair count)."""
    zc = z.float() - r
    zm = zc * rows
    return zm.sum(0), (zm * zc).sum(0)


def _stream_moments_grad_plain(z, rows, r, g1, g2):
    """Its backward: ``dz = rows * (g1 + 2 * g2 * zc)`` in z's dtype."""
    return (rows * (g1 + 2 * g2 * (z.float() - r))).to(z.dtype)


def _affine_relu_plain(z, inv, shift):
    """K6's ``affine_relu`` in plain PyTorch: ``relu(f32(z) * inv + shift)``
    in z's dtype."""
    return torch.relu(z.float() * inv + shift).to(z.dtype)


def _affine_relu_grads_plain(z, dy, inv, shift):
    """Its backward: ``(dz, dinv, dshift)``; the gate is the forward
    expression."""
    zf = z.float()
    g = torch.where(zf * inv + shift > 0, dy.float(), 0.0)
    return (g * inv).to(z.dtype), (g * zf).sum(0), g.sum(0)


def _stream_head_plain(z, inv, shift, w, b):
    """K6's ``stream_head`` in plain PyTorch: ``h @ w`` with ``h =
    relu(f32(z) * inv + shift)`` in z's dtype, the products summed in
    float32 (w in z's dtype), plus ``b``: (N,) float32."""
    gemm_precision(z.dtype)
    h = torch.relu(z.float() * inv + shift).to(z.dtype)
    return h.float() @ w.float() + b


def _stream_head_grads_plain(z, inv, shift, w, dout):
    """Its backward at JAX's cast points (the transpose of a bf16 dot with a
    float32 result): ``dh = (dout * w)`` rounded to z's dtype, ``dz = g *
    inv`` with g the gated dh, ``dw = dout @ h`` rounded to w's dtype, ``db
    = sum dout``: ``(dz, dinv, dshift, dw, db)``."""
    gemm_precision(z.dtype)
    zf = z.float()
    x = zf * inv + shift
    h = torch.relu(x).to(z.dtype)
    dh = (dout[:, None] * w.float()).to(z.dtype)
    g = torch.where(x > 0, dh.float(), 0.0)
    return ((g * inv).to(z.dtype), (g * zf).sum(0), g.sum(0), (dout @ h.float()).to(w.dtype),
            dout.sum())


# the ctypes signatures of csrc/streamed_bn.cu's entry points (pointers,
# then N, H and for the reductions their row chunks, then the stream); each
# float32 form (``_f32``) takes its bf16 form's
_K6_REDUCE = [_LL, _I, _I, _LL, _P]
K6_SIGNATURES = {
    "stream_moments": [_P] * 7 + _K6_REDUCE,
    "stream_moments_backward": [_P] * 6 + [_LL, _I, _P],
    "affine_relu": [_P] * 4 + [_LL, _I, _P],
    "affine_relu_backward": [_P] * 9 + _K6_REDUCE,
    "stream_head": [_P] * 6 + [_LL, _I, _P],
    "stream_head_backward": [_P] * 11 + _K6_REDUCE,
}
K6_SIGNATURES.update({f"{k}_f32": v for k, v in list(K6_SIGNATURES.items())})


def _launch_k6(name: str, z: torch.Tensor, *args) -> None:
    """K6's entry point ``name`` (its float32 form for float32 z) on z's
    device and current stream, counted."""
    from protnote_tpu_torch.ops.kernels import kernel_function

    symbol = _symbol(z, name)
    fn = kernel_function("streamed_bn", symbol, K6_SIGNATURES[symbol])
    with torch.cuda.device(z.device):
        _raise_on(fn(*args, torch.cuda.current_stream(z.device).cuda_stream), symbol)
        _count(symbol)


def _stream_moments_cuda(z, rows, r):
    """``stream_moments`` (``csrc/streamed_bn.cu``): the plain version's sums,
    added per row chunk and then over the chunks in a fixed order."""
    z, r = z.contiguous(), r.float().contiguous()
    _check_bn_cuda(z, rows, None, (r,))
    N, H = z.shape
    chunks, per = _chunks(N)
    f32 = dict(dtype=torch.float32, device=z.device)
    part = torch.empty(2, chunks, H, **f32)
    s1, s2 = torch.empty(H, **f32), torch.empty(H, **f32)
    _launch_k6("stream_moments", z, z.data_ptr(),
               rows.data_ptr(), r.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
               s1.data_ptr(), s2.data_ptr(), N, H, chunks, per)
    return s1, s2


def _stream_moments_grad_cuda(z, rows, r, g1, g2):
    """``stream_moments_backward``: dz as :func:`_stream_moments_grad_plain`."""
    g1, g2, r = (t.float().contiguous() for t in (g1, g2, r))
    _check_bn_cuda(z, rows, None, (r, g1, g2))
    N, H = z.shape
    dz = torch.empty_like(z)
    _launch_k6("stream_moments_backward", z, z.data_ptr(),
               rows.data_ptr(), r.data_ptr(), g1.data_ptr(), g2.data_ptr(), dz.data_ptr(), N, H)
    return dz


def _affine_relu_cuda(z, inv, shift):
    """``affine_relu``: y as :func:`_affine_relu_plain`."""
    z, inv, shift = z.contiguous(), inv.contiguous(), shift.contiguous()
    _check_bn_cuda(z, None, None, (inv, shift))
    N, H = z.shape
    y = torch.empty_like(z)
    _launch_k6("affine_relu", z, z.data_ptr(), inv.data_ptr(),
               shift.data_ptr(), y.data_ptr(), N, H)
    return y


def _affine_relu_grads_cuda(z, dy, inv, shift):
    """``affine_relu_backward``: ``(dz, dinv, dshift)`` in one sweep over z
    and dy, the sums in a fixed order."""
    dy = dy.to(z.dtype).contiguous()
    _check_bn_cuda(z, None, None, (inv, shift))
    if dy.shape != z.shape or dy.device != z.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not match z {tuple(z.shape)}")
    N, H = z.shape
    chunks, per = _chunks(N)
    f32 = dict(dtype=torch.float32, device=z.device)
    part = torch.empty(2, chunks, H, **f32)
    dinv, dshift = torch.empty(H, **f32), torch.empty(H, **f32)
    dz = torch.empty_like(z)
    _launch_k6("affine_relu_backward", z, z.data_ptr(),
               dy.data_ptr(), inv.data_ptr(), shift.data_ptr(), dz.data_ptr(),
               part[0].data_ptr(), part[1].data_ptr(), dinv.data_ptr(), dshift.data_ptr(), N, H,
               chunks, per)
    return dz, dinv, dshift


def _check_head(z, w, b: Optional[torch.Tensor] = None) -> None:
    if w.dtype != z.dtype or tuple(w.shape) != (z.shape[1],) or w.device != z.device:
        raise ValueError(f"the head takes w ({z.shape[1]},) {z.dtype} on z's device, not "
                         f"{tuple(w.shape)} {w.dtype}")
    if b is not None and (b.numel() != 1 or b.dtype != torch.float32 or b.device != z.device):
        raise ValueError(f"the head takes one float32 b on z's device, not {b.dtype}")


def _stream_head_cuda(z, inv, shift, w, b):
    """``stream_head``: logits (N,) float32 as :func:`_stream_head_plain`, a
    warp a row."""
    z, w, b = z.contiguous(), w.contiguous(), b.reshape(1).contiguous()
    _check_bn_cuda(z, None, None, (inv, shift))
    _check_head(z, w, b)
    N, H = z.shape
    out = torch.empty(N, dtype=torch.float32, device=z.device)
    _launch_k6("stream_head", z, z.data_ptr(), inv.data_ptr(),
               shift.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, H)
    return out


def _stream_head_grads_cuda(z, inv, shift, w, dout):
    """``stream_head_backward``: ``(dz, dinv, dshift, dw, db)`` as
    :func:`_stream_head_grads_plain`, one sweep over z; dw's float32 sum is
    rounded to w's dtype here."""
    w, dout = w.contiguous(), dout.float().contiguous()
    _check_bn_cuda(z, None, None, (inv, shift))
    _check_head(z, w)
    N, H = z.shape
    if tuple(dout.shape) != (N,) or dout.device != z.device:
        raise ValueError(f"dout {tuple(dout.shape)} does not match z's {N} rows")
    chunks, per = _chunks(N)
    f32 = dict(dtype=torch.float32, device=z.device)
    part = torch.empty(3, chunks, H, **f32)
    dinv, dshift, dw = (torch.empty(H, **f32) for _ in range(3))
    db = torch.empty((), **f32)
    dz = torch.empty_like(z)
    _launch_k6("stream_head_backward", z, z.data_ptr(),
               inv.data_ptr(), shift.data_ptr(), w.data_ptr(), dout.data_ptr(), dz.data_ptr(),
               part.data_ptr(), dinv.data_ptr(), dshift.data_ptr(), dw.data_ptr(), db.data_ptr(),
               N, H, chunks, per)
    return dz, dinv, dshift, dw.to(w.dtype), db


class _StreamMoments(torch.autograd.Function):
    """``(s1, s2)`` of one tile by ``fwd``, dz by ``bwd`` (the plain or the
    kernel implementations); the rows and the shift carry no gradient."""

    @staticmethod
    def forward(ctx, z, rows, r, fwd, bwd):
        z = z.contiguous()
        ctx.save_for_backward(z, rows, r)
        ctx.bwd = bwd
        return fwd(z, rows, r)

    @staticmethod
    def backward(ctx, g1, g2):
        return ctx.bwd(*ctx.saved_tensors, g1, g2), None, None, None, None


class _AffineRelu(torch.autograd.Function):
    """``relu(f32(z) * inv + shift)`` by ``fwd``; ``(dz, dinv, dshift)`` by
    ``bwd``."""

    @staticmethod
    def forward(ctx, z, inv, shift, fwd, bwd):
        z = z.contiguous()
        ctx.save_for_backward(z, inv, shift)
        ctx.bwd = bwd
        return fwd(z, inv, shift)

    @staticmethod
    def backward(ctx, dy):
        z, inv, shift = ctx.saved_tensors
        return (*ctx.bwd(z, dy, inv, shift), None, None)


class _StreamHead(torch.autograd.Function):
    """The head's logits by ``fwd``; ``(dz, dinv, dshift, dw, db)`` by
    ``bwd``."""

    @staticmethod
    def forward(ctx, z, inv, shift, w, b, fwd, bwd):
        z = z.contiguous()
        ctx.save_for_backward(z, inv, shift, w)
        ctx.bwd = bwd
        ctx.b_shape = b.shape
        return fwd(z, inv, shift, w, b)

    @staticmethod
    def backward(ctx, dout):
        dz, dinv, dshift, dw, db = ctx.bwd(*ctx.saved_tensors, dout.contiguous())
        return dz, dinv, dshift, dw, db.reshape(ctx.b_shape), None, None


def _k6_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {t.device}")
    return t.device.type == "cuda"


def stream_moments(z: torch.Tensor, rows: torch.Tensor, r: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tile's masked shifted column sums ``(sum rows * (z - r), sum rows
    * (z - r)^2)`` (float32, (H,)) of (N, H) pre-activations; ``rows`` (N,
    1) float32, ``r`` the detached running mean.  CPU tensors take the plain
    version, CUDA tensors the kernels."""
    if _k6_device(z, "streamed moments"):
        return _StreamMoments.apply(z, rows, r, _stream_moments_cuda, _stream_moments_grad_cuda)
    return stream_moments_reference(z, rows, r)


def stream_moments_reference(z, rows, r):
    """:func:`stream_moments` through its plain version, on any device."""
    return _StreamMoments.apply(z, rows, r, _stream_moments_plain, _stream_moments_grad_plain)


def affine_relu(z: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``relu(f32(z) * inv + shift)`` in z's dtype, with a fixed (float32,
    (H,)) affine.  CPU tensors take the plain version, CUDA tensors the
    kernels."""
    if _k6_device(z, "affine + ReLU"):
        return _AffineRelu.apply(z, inv, shift, _affine_relu_cuda, _affine_relu_grads_cuda)
    return affine_relu_reference(z, inv, shift)


def affine_relu_reference(z, inv, shift):
    """:func:`affine_relu` through its plain version, on any device."""
    return _AffineRelu.apply(z, inv, shift, _affine_relu_plain, _affine_relu_grads_plain)


def stream_head(z: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``relu(f32(z) * inv + shift) @ w + b`` as (N,) float32 logits, the
    activations rounded to z's dtype and the products summed in float32 (w
    (H,) in z's dtype, b a float32 scalar).  CPU tensors take the plain
    version, CUDA tensors the kernels."""
    if _k6_device(z, "streamed head"):
        return _StreamHead.apply(z, inv, shift, w, b, _stream_head_cuda, _stream_head_grads_cuda)
    return stream_head_reference(z, inv, shift, w, b)


def stream_head_reference(z, inv, shift, w, b):
    """:func:`stream_head` through its plain version, on any device."""
    return _StreamHead.apply(z, inv, shift, w, b, _stream_head_plain, _stream_head_grads_plain)


# ----------------------------------------------------------------------
# the decomposed training scorer


def _side_products(first: Params, P_e: torch.Tensor, L_e: torch.Tensor,
                   feature_fusion: str, compute_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first layer decomposed: ``a = P_e @ W1_p`` (B, H) and ``c = L_e @
    W1_l (+ b1)`` (L, H), float32 products of operands in the compute
    dtype."""
    d = P_e.shape[1]
    W1 = first["kernel"].float()
    w1_p, w1_l = W1[:d], W1[d : 2 * d]
    if feature_fusion == "concatenation_diff":
        w1_x = W1[2 * d : 3 * d]
        w1_p = w1_p + w1_x
        w1_l = w1_l - w1_x
    a = _f32_product(P_e, w1_p, compute_dtype)
    c = _f32_product(L_e, w1_l, compute_dtype)
    if "bias" in first:
        c = c + first["bias"].float()
    return a, c


def _first_layer_bn(a, c, em, lm, p_bn: Params, s_bn: Params, compute_dtype):
    """The first layer's analytic BN statistics over the masked product set,
    distributed to the sides: ``(a2, c2, n_pairs, new running
    statistics)``."""
    mean_a, var_a, n_b = _masked_moments(a, em[:, None])
    mean_c, var_c, n_l = _masked_moments(c, lm[:, None])
    mean1, var1, n_pairs = mean_a + mean_c, var_a + var_c, n_b * n_l
    inv1, shift1 = _affine(p_bn["scale"], p_bn["bias"], mean1, var1)
    # the affine distributed to the sides before the broadcast
    a2 = (a * inv1).to(compute_dtype)
    c2 = (c * inv1 + shift1).to(compute_dtype)
    return a2, c2, n_pairs, _update_running(s_bn, mean1, var1, n_pairs)


def _masks(B: int, L: int, example_mask, label_mask, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    em = (torch.ones(B, device=dev) if example_mask is None else example_mask).float()
    lm = (torch.ones(L, device=dev) if label_mask is None else label_mask).float()
    return em, lm


def _first_hidden(a2, c2, layer: Params, compute_dtype, hidden_fn):
    """The first hidden GEMM ``relu(a2[b] + c2[l]) @ W (+ bias)`` through
    ``hidden_fn`` (K4 or its plain version)."""
    z = hidden_fn(a2, c2, layer["kernel"].to(compute_dtype))
    if "bias" in layer:
        z = z + layer["bias"].to(compute_dtype)
    return z


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
    (GRADIENT_CHECKPOINTING) recomputes everything after the per-side
    products in the backward."""
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
    if feature_fusion not in ("concatenation", "concatenation_diff"):
        raise ValueError(f"decomposed path does not support {feature_fusion}")
    if s is None:
        raise ValueError("decomposed path requires BatchNorm state")
    B, L = P_e.shape[0], L_e.shape[0]
    em, lm = _masks(B, L, example_mask, label_mask, P_e.device)
    layers, bns = p["layers"], p["bns"]
    a, c = _side_products(layers[0], P_e, L_e, feature_fusion, compute_dtype)
    rows = (em[:, None] * lm[None, :]).reshape(B * L, 1)

    def post(a, c):
        a2, c2, n_pairs, bn0 = _first_layer_bn(a, c, em, lm, bns[0], s["bns"][0],
                                               compute_dtype)
        new_bns = [bn0]
        if len(layers) == 1:
            h = _pair_x1(a2, c2)
        for i in range(1, len(layers)):
            if i == 1:
                z = _first_hidden(a2, c2, layers[1], compute_dtype, hidden_fn)
            else:
                z = linear(layers[i], h)
            h, mean_i, var_i = bn_relu_fn(z, rows, n_pairs, bns[i]["scale"], bns[i]["bias"],
                                          s["bns"][i]["mean"])
            new_bns.append(_update_running(s["bns"][i], mean_i, var_i, n_pairs))
        out = linear(p["out"], h)[..., 0].float()
        return out.reshape(B, L), new_bns

    if remat:
        # the recomputation in the backward rebuilds the saved tensors only:
        # the logits and running statistics are the first forward's
        from torch.utils.checkpoint import checkpoint

        logits, new_bns = checkpoint(post, a, c, use_reentrant=False)
    else:
        logits, new_bns = post(a, c)
    return logits, {"bns": new_bns}


# ----------------------------------------------------------------------
# the streamed training scorer (K6)

CPU_CACHE_BUDGET = 15.2e9  # the JAX rule's budget where the device reports no limit
CACHE_HEADROOM = 0.55e9  # kept free of the card's memory by the cache rule


def streaming_cache_first(batch: int, labels: int, label_tile: int, width: int,
                          itemsize: int, n_layers: int, device: torch.device) -> bool:
    """The JAX rule for ``cache_first=None``: keep z1 when it and its
    gradient (``2 * z1``) plus four tiles of transients fit the budget: the
    card's memory less 0.55 GB, or 15.2 GB where there is no card (the CPU).
    ``labels`` is the count padded to whole tiles."""
    if n_layers < 2:
        return False
    z1_bytes = batch * labels * width * itemsize
    tile_bytes = batch * label_tile * width * itemsize
    budget = CPU_CACHE_BUDGET
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory - CACHE_HEADROOM
    return 2 * z1_bytes + 4 * tile_bytes <= budget


def streamed_launches(n_layers: int, num_tiles: int, cache_first: bool,
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """The kernel launches of one forward and backward of the streamed
    scorer, from its schedule: each tile's forward runs once in the forward
    and once more when the backward recomputes it, and each kernel's
    backward runs once for each forward call, over every key of
    ``LAUNCHES`` (K5 never; in float32 the ``_f32`` forms of K4, K4-bwd and
    K6, in bfloat16 their bf16 forms).  Per tile: sweep A (with the
    cache) one K4 and one moment sum; the statistics sweep of hidden layer
    li its pre-activation (K4 unless it starts from z1, li - 1 affines and
    products) and one moment sum; the loss pass every layer again (from z1
    when no sweep used it) and the head."""
    cache = cache_first and n_layers > 1
    k4 = moments = affine = 0
    if cache:
        k4, moments = 1, 1
    first = 2 if cache else 1
    for li in range(first, n_layers):
        k4 += 0 if cache and li == first else 1
        affine += li - 1
        moments += 1
    if n_layers > 1:
        k4 += 0 if cache and n_layers == 2 else 1
        affine += n_layers - 2
    calls = {"pair_train_hidden": k4, "stream_moments": moments, "affine_relu": affine,
             "stream_head": 1}
    out = {k: 2 * v * num_tiles for k, v in calls.items()}
    out.update({f"{k}_backward": v * num_tiles for k, v in calls.items()
                if k != "pair_train_hidden"})
    out.update(pair_train_dx=k4 * num_tiles, pair_train_dw=k4 * num_tiles)
    if dtype == torch.float32:
        out = {f"{k}_f32": v for k, v in out.items()}
    return {k: out.get(k, 0) for k in LAUNCHES}


def pair_logits_streaming_train(
    p: Params,
    s: Params,
    P_e: torch.Tensor,  # (B, d)
    L_e: torch.Tensor,  # (L, d)
    feature_fusion: str = "concatenation",
    example_mask: Optional[torch.Tensor] = None,  # (B,)
    label_mask: Optional[torch.Tensor] = None,  # (L,)
    label_tile: int = 2048,
    compute_dtype: torch.dtype = torch.bfloat16,
    cache_first: Optional[bool] = None,
) -> Tuple[torch.Tensor, Dict[str, list]]:
    """The function of :func:`pair_logits_dense_decomposed` (train-mode BN
    over every masked pair) with (B * ``label_tile``, H) tensors only:
    ``((B, L) float32 logits, {"bns": new running statistics})``, through
    K4, K4-bwd and K6 (their plain versions for CPU tensors).

    The labels are padded to whole tiles (padded labels carry no weight in
    the statistics and are sliced off the logits).  For each hidden layer
    after the first, one sweep over the tiles recomputes the forward up to
    its pre-activation and sums its shifted moments; the loss pass then
    recomputes each tile through every layer with the streamed affines and
    ends in the fused head.  Each tile runs under ``torch.utils.checkpoint``,
    so the backward runs the sweeps in reverse and recomputes each tile.
    ``cache_first`` keeps the first hidden GEMM's output z1 (B * L, H) for
    its one later consumer, the next sweep (the layer-3 statistics, or the
    loss pass at depth 2), at the cost of z1 and its gradient; ``None``
    decides by :func:`streaming_cache_first`."""
    return _streaming(p, s, P_e, L_e, feature_fusion, example_mask, label_mask, label_tile,
                      compute_dtype, cache_first,
                      (pair_hidden, stream_moments, affine_relu, stream_head))


def pair_logits_streaming_train_reference(
    p: Params,
    s: Params,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    feature_fusion: str = "concatenation",
    example_mask: Optional[torch.Tensor] = None,
    label_mask: Optional[torch.Tensor] = None,
    label_tile: int = 2048,
    compute_dtype: torch.dtype = torch.bfloat16,
    cache_first: Optional[bool] = None,
) -> Tuple[torch.Tensor, Dict[str, list]]:
    """:func:`pair_logits_streaming_train` through the plain versions of K4
    and K6, on any device."""
    return _streaming(p, s, P_e, L_e, feature_fusion, example_mask, label_mask, label_tile,
                      compute_dtype, cache_first,
                      (pair_hidden_reference, stream_moments_reference, affine_relu_reference,
                       stream_head_reference))


def _streaming(p, s, P_e, L_e, feature_fusion, example_mask, label_mask, label_tile,
               compute_dtype, cache_first, ops):
    from torch.utils.checkpoint import checkpoint

    if feature_fusion not in ("concatenation", "concatenation_diff"):
        raise ValueError(f"streaming path does not support {feature_fusion}")
    if s is None:
        raise ValueError("streaming path requires BatchNorm state")
    if label_tile <= 0:
        raise ValueError(f"label_tile must be positive, not {label_tile}")
    hidden_fn, moments_fn, affine_fn, head_fn = ops
    B, L = P_e.shape[0], L_e.shape[0]
    dev = P_e.device
    em, lm = _masks(B, L, example_mask, label_mask, dev)
    layers, bns = p["layers"], p["bns"]
    n_layers = len(layers)
    a, c = _side_products(layers[0], P_e, L_e, feature_fusion, compute_dtype)
    a2, c2, n_pairs, bn0 = _first_layer_bn(a, c, em, lm, bns[0], s["bns"][0], compute_dtype)
    new_bns = [bn0]
    # every tile of every sweep reads a2 and c2: their per-tile gradients (in
    # the compute dtype, from K4-bwd) are added in float32 and rounded once,
    # where JAX's scan adds them in bf16 (the forward reads the same values)
    a2, c2 = a2.float(), c2.float()

    num_tiles = -(-L // label_tile)
    Lp = num_tiles * label_tile
    c_tiles = torch.nn.functional.pad(c2, (0, 0, 0, Lp - L)).split(label_tile)
    lm_tiles = torch.nn.functional.pad(lm, (0, Lp - L)).split(label_tile)
    if cache_first is None:
        cache_first = streaming_cache_first(
            B, Lp, label_tile, layers[1]["kernel"].shape[1] if n_layers > 1 else 0,
            torch.empty((), dtype=compute_dtype).element_size(), n_layers, dev)
    cache_first = bool(cache_first) and n_layers > 1
    # affines[k]: the streamed (inv, shift) of hidden layer k + 1's BatchNorm
    affines: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def rows_of(lm_t):
        return (em[:, None] * lm_t[None, :]).reshape(B * label_tile, 1)

    def pre(li, c_t, z1_t=None):
        """Hidden layer li's pre-activation on one tile, from c2's tile or
        restarted from the cached z1 tile."""
        if li == 1:
            if z1_t is not None:
                return z1_t
            return _first_hidden(a2.to(compute_dtype), c_t.to(compute_dtype), layers[1],
                                 compute_dtype, hidden_fn)
        return linear(layers[li], affine_fn(pre(li - 1, c_t, z1_t), *affines[li - 2]))

    running = {li: s["bns"][li]["mean"].detach().float() for li in range(1, n_layers)}

    def finish(li, s_sum, s_sq):
        s1 = s_sum / n_pairs
        mean = s1 + running[li]
        var = torch.clamp(s_sq / n_pairs - s1 * s1, min=0.0)
        affines.append(_affine(bns[li]["scale"], bns[li]["bias"], mean, var))
        new_bns.append(_update_running(s["bns"][li], mean, var, n_pairs))

    z1_tiles = None
    if cache_first:
        # sweep A: z1 of every tile kept, with its statistics
        def sweep_a(c_t, lm_t):
            z = pre(1, c_t)
            return (*moments_fn(z, rows_of(lm_t), running[1]), z)

        sums, z1_tiles = [0.0, 0.0], []
        for c_t, lm_t in zip(c_tiles, lm_tiles):
            ds, dq, z = checkpoint(sweep_a, c_t, lm_t, use_reentrant=False)
            sums = [sums[0] + ds, sums[1] + dq]
            z1_tiles.append(z)
        finish(1, *sums)

    z1_spent = False
    for li in range(2 if cache_first else 1, n_layers):
        use_z1 = z1_tiles is not None and not z1_spent

        def stat_tile(x_t, lm_t, li=li, use_z1=use_z1):
            z = pre(li, None, x_t) if use_z1 else pre(li, x_t)
            return moments_fn(z, rows_of(lm_t), running[li])

        sums = [0.0, 0.0]
        for x_t, lm_t in zip(z1_tiles if use_z1 else c_tiles, lm_tiles):
            ds, dq = checkpoint(stat_tile, x_t, lm_t, use_reentrant=False)
            sums = [sums[0] + ds, sums[1] + dq]
        z1_spent = z1_spent or use_z1
        finish(li, *sums)

    # the loss pass: every layer recomputed, the last affine fused into the head
    loss_from_z1 = z1_tiles is not None and not z1_spent
    w_out, b_out = p["out"]["kernel"][:, 0], p["out"]["bias"][0].float()

    def logit_tile(x_t):
        w = w_out.float().to(compute_dtype)
        if n_layers == 1:
            x1 = a2.to(compute_dtype)[:, None, :] + x_t.to(compute_dtype)[None, :, :]
            z = x1.reshape(B * label_tile, -1)
            inv = torch.ones(z.shape[1], device=dev)
            return head_fn(z, inv, torch.zeros_like(inv), w, b_out).reshape(B, label_tile)
        z = pre(n_layers - 1, None, x_t) if loss_from_z1 else pre(n_layers - 1, x_t)
        return head_fn(z, *affines[-1], w, b_out).reshape(B, label_tile)

    tiles = [checkpoint(logit_tile, x_t, use_reentrant=False)
             for x_t in (z1_tiles if loss_from_z1 else c_tiles)]
    return torch.cat(tiles, dim=1)[:, :L], {"bns": new_bns}
