"""Pairwise (sequence x label) fusion-MLP scoring, eval path.

Port of ``protnote_tpu/ops/pair_scorer.py``.  The first MLP layer is
decomposed per side (``W1 @ concat(p, l) = W1p@p + W1l@l``), eval BatchNorm is
folded into the weights (:func:`fold_output_mlp`), and each (sequence, label)
pair then runs ``relu(a[b] + c[l])`` through the hidden H x H GEMM + bias +
ReLU layers and a dot with ``w_out``.

:func:`pair_logits_tiled` is the entry point.  For tensors on the CPU it runs
the plain PyTorch version, :func:`pair_logits_tiled_reference`; for CUDA
tensors it launches the hand-written kernel ``csrc/pair_scorer.cu`` and never
falls back to the plain version: input the kernel does not take raises.

Cast points follow the JAX path exactly: the per-side products ``a`` and
``c`` are float32 products of operands rounded to the compute dtype
(``preferred_element_type=float32``), ``relu(a + c)`` is formed in float32
and then rounded, each hidden layer accumulates in float32, adds the float32
bias, applies ReLU and rounds, and the logit is the float32 dot of the
rounded activations with the rounded ``w_out`` plus the float32 ``b_out``.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from protnote_tpu_torch.models.layers import Params, fold_batchnorm, gemm_precision

BN_EPS = 1e-5  # torch BatchNorm1d defaults used by get_mlp / torchvision MLP


@dataclass
class FoldedOutputMLP:
    """Output MLP with eval BatchNorm folded into the linear layers.

    ``w1_p``/``w1_l`` are the split halves of layer 1, so the joint tensor is
    never built; for ``concatenation_diff`` the diff block is folded into
    them.  ``w1_prod`` (``concatenation_prod`` only) multiplies ``p * l`` per
    label chunk.
    """

    w1_p: torch.Tensor  # (d, H)
    w1_l: torch.Tensor  # (d, H)
    b1: torch.Tensor  # (H,)
    w1_prod: Optional[torch.Tensor]  # (d, H) or None
    hidden: List[Tuple[torch.Tensor, torch.Tensor]]  # [(W (H, H), b (H,)), ...]
    w_out: torch.Tensor  # (H,)
    b_out: torch.Tensor  # () float32


def fold_output_mlp(p: Params, s: Optional[Params], feature_fusion: str,
                    latent_dim: int, dtype: torch.dtype = torch.float32
                    ) -> FoldedOutputMLP:
    """Fold eval-mode BN affines into weights; split layer 1 by input block."""
    d = latent_dim
    layers = p["layers"]

    def folded(i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        W = layers[i]["kernel"].float()
        b = layers[i].get("bias")
        b = W.new_zeros(W.shape[1]) if b is None else b.float()
        if s is not None:
            scale, shift = fold_batchnorm(p["bns"][i], s["bns"][i], BN_EPS)
            W = W * scale[None, :]
            b = b * scale + shift
        return W.to(dtype), b.to(dtype)

    W1, b1 = folded(0)
    w1_p, w1_l = W1[:d], W1[d : 2 * d]
    w1_prod = None
    if feature_fusion == "concatenation_diff":
        w1_x = W1[2 * d : 3 * d]
        w1_p = w1_p + w1_x
        w1_l = w1_l - w1_x
    elif feature_fusion == "concatenation_prod":
        w1_prod = W1[2 * d : 3 * d]

    hidden = [folded(i) for i in range(1, len(layers))]
    w_out = p["out"]["kernel"][:, 0].to(dtype)
    b_out = p["out"]["bias"][0].float()
    return FoldedOutputMLP(w1_p=w1_p, w1_l=w1_l, b1=b1, w1_prod=w1_prod,
                           hidden=hidden, w_out=w_out, b_out=b_out)


def _f32_product(x: torch.Tensor, w: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` of operands rounded to ``compute_dtype``, in float32.

    The JAX ``jnp.dot(..., preferred_element_type=float32)``: a bf16 @ bf16
    product in torch would round its result to bf16, so the rounded operands
    are multiplied in full float32 instead (each product of two bf16 values
    is exact in float32)."""
    gemm_precision(torch.float32)
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def _side_partials(folded: FoldedOutputMLP, P_e: torch.Tensor,
                   L_e: torch.Tensor, compute_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-layer decomposition: ``a`` (B, H) and ``c`` (L, H), float32."""
    a = _f32_product(P_e, folded.w1_p, compute_dtype)
    c = _f32_product(L_e, folded.w1_l, compute_dtype) + folded.b1.float()
    return a, c


def pair_logits_tiled_reference(
    folded: FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the JAX ``_tiled_scaffold`` +
    ``pair_logits_tiled``.  Returns (B, L) float32 logits.

    Pair rows are independent, so the ragged last label tile is computed at
    its own width; the JAX scaffold pads it to ``label_tile`` and slices the
    padded columns back off, which leaves the same values."""
    B = P_e.shape[0]
    L = L_e.shape[0]
    a, c = _side_partials(folded, P_e, L_e, compute_dtype)
    logits = torch.empty(B, L, dtype=torch.float32, device=P_e.device)
    for l0 in range(0, L, label_tile):
        c_t = c[l0 : l0 + label_tile]
        nl = c_t.shape[0]
        pre1 = a[:, None, :] + c_t[None, :, :]
        if folded.w1_prod is not None:
            prod = P_e[:, None, :] * L_e[None, l0 : l0 + nl, :]  # (B, nl, d)
            pre1 = pre1 + _f32_product(prod, folded.w1_prod, compute_dtype)
        h = torch.relu(pre1).reshape(B * nl, -1).to(compute_dtype)
        for W, b in folded.hidden:
            h = torch.relu(_f32_product(h, W, compute_dtype) + b.float()).to(compute_dtype)
        out = _f32_product(h, folded.w_out[:, None], compute_dtype)[:, 0]
        logits[:, l0 : l0 + nl] = (out + folded.b_out).reshape(B, nl)
    return logits


# ----------------------------------------------------------------------
# CUDA kernel (csrc/pair_scorer.cu)

# Launches of the pair-scorer kernel since the process started (or since a
# caller last set it to 0): one per hidden layer per label chunk.
LAUNCHES = 0
_launch_lock = threading.Lock()

_BLOCK_N = 128  # output columns per block (BN in the kernel; a multiple of BK)


def check_kernel_inputs(folded: FoldedOutputMLP, P_e: torch.Tensor,
                        L_e: torch.Tensor, compute_dtype: torch.dtype) -> None:
    """Raise on what the CUDA kernel does not take (there is no fallback)."""
    if compute_dtype != torch.bfloat16:
        raise ValueError(
            f"the CUDA pair scorer computes in bfloat16, not {compute_dtype} "
            "(MIXED_PRECISION: True)"
        )
    if folded.w1_prod is not None:
        raise ValueError("the CUDA pair scorer does not take concatenation_prod")
    if not folded.hidden:
        raise ValueError("the CUDA pair scorer needs at least one hidden layer "
                         "(OUTPUT_MLP_NUM_LAYERS >= 2)")
    H = folded.w1_p.shape[1]
    if H % _BLOCK_N:
        raise ValueError(f"hidden width {H} is not a multiple of {_BLOCK_N}")
    for W, b in folded.hidden:
        if tuple(W.shape) != (H, H) or tuple(b.shape) != (H,):
            raise ValueError(f"hidden layer shapes {tuple(W.shape)}, "
                             f"{tuple(b.shape)} do not match width {H}")
    if P_e.dim() != 2 or L_e.dim() != 2 or P_e.shape[1] != L_e.shape[1]:
        raise ValueError(f"P_e {tuple(P_e.shape)} and L_e {tuple(L_e.shape)} "
                         "must be (B, d) and (L, d)")


def _kernel_fn():
    """The C entry point of the built library, with its ctypes signature."""
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    fn = load_kernel_library("pair_scorer").lib.pair_mlp_layer
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def pair_logits_tiled_cuda(
    folded: FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's wrapper: (B, L) float32 logits for CUDA tensors.

    Per chunk of ``label_tile`` labels it launches one kernel per hidden
    layer: the first forms ``relu(a[b] + c[l])`` in shared memory as its A
    operand, the last reduces its activations against ``w_out`` into the
    logits (pre-filled with ``b_out``), and any layer between reads and
    writes bf16 activations in a workspace."""
    global LAUNCHES
    check_kernel_inputs(folded, P_e, L_e, compute_dtype)
    device = P_e.device
    tensors = [P_e, L_e, folded.w1_p, folded.w1_l, folded.b1, folded.w_out,
               folded.b_out] + [t for pair in folded.hidden for t in pair]
    if any(t.device != device for t in tensors) or device.type != "cuda":
        raise ValueError("the CUDA pair scorer needs every tensor on one CUDA device")
    B = P_e.shape[0]
    L = L_e.shape[0]
    H = folded.w1_p.shape[1]
    a, c = _side_partials(folded, P_e, L_e, compute_dtype)
    a, c = a.contiguous(), c.contiguous()
    weights = [W.to(torch.bfloat16).contiguous() for W, _ in folded.hidden]
    biases = [b.float().contiguous() for _, b in folded.hidden]
    w_out = folded.w_out.to(torch.bfloat16).contiguous()
    logits = torch.empty(B, L, dtype=torch.float32, device=device)
    logits.copy_(folded.b_out.float().expand(B, L))  # the kernel adds into it
    n = len(weights)
    tile = min(int(label_tile), L)
    work = [torch.empty(B * tile, H, dtype=torch.bfloat16, device=device)
            for _ in range(min(n - 1, 2))]
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the C launch goes to the thread's device
        for l0 in range(0, L, tile):
            nl = min(tile, L - l0)
            x_in = None
            for i in range(n):
                last = i == n - 1
                x_out = None if last else work[i % 2]
                mode = (1 if i == 0 else 0) | (2 if last else 0)
                err = fn(_ptr(a), _ptr(c), _ptr(x_in), _ptr(weights[i]),
                         _ptr(biases[i]), _ptr(x_out), _ptr(w_out), _ptr(logits),
                         nl, l0, L, B * nl, H, H, mode, stream)
                if err != 0:
                    raise RuntimeError(f"pair_mlp_layer launch failed: CUDA error {err}")
                with _launch_lock:
                    LAUNCHES += 1
                x_in = x_out
    return logits


def pair_logits_tiled(
    folded: FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Inference pair scoring, label-tiled.  Returns (B, L) float32 logits.

    CPU tensors take :func:`pair_logits_tiled_reference`; CUDA tensors take
    the kernel (:func:`pair_logits_tiled_cuda`)."""
    if P_e.device.type == "cpu":
        return pair_logits_tiled_reference(folded, P_e, L_e, label_tile, compute_dtype)
    if P_e.device.type == "cuda":
        return pair_logits_tiled_cuda(folded, P_e, L_e, label_tile, compute_dtype)
    raise ValueError(f"no pair scorer for device {P_e.device}")


# ----------------------------------------------------------------------
# Similarity fusion (reference ProtNote.py:281-284)


def similarity_logits(P_e: torch.Tensor, L_e: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    gemm_precision(P_e.dtype)
    pn = P_e / torch.linalg.vector_norm(P_e, dim=-1, keepdim=True).clamp(min=1e-12)
    ln = L_e / torch.linalg.vector_norm(L_e, dim=-1, keepdim=True).clamp(min=1e-12)
    return (pn @ ln.T) / temperature
