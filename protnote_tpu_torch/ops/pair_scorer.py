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
# int8 inference path (K2, PAIR_BACKEND=tiled_int8): the hidden H x H GEMMs
# on int8 codes with int32 accumulation.  Weights are folded-BN, symmetric
# per output channel; activations are quantized with static per-layer scales
# (calibrated, the int8 carry chain) or dynamic per-row scales.  The first
# layer's per-side products and the logit dot stay in the compute dtype.
# Port of protnote_tpu/ops/pair_scorer.py:265-460.


@dataclass
class Int8FoldedOutputMLP:
    """Folded inference MLP with int8-quantized hidden layers.

    ``act_scales``: one static activation scale per hidden layer
    (:func:`calibrate_act_scales`), or None for dynamic per-row scales."""

    w1_p: torch.Tensor  # (d, H)
    w1_l: torch.Tensor  # (d, H)
    b1: torch.Tensor  # (H,)
    hidden_q: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    # [(Wq (H, H) int8, s_w (H,) float32, b (H,) float32), ...]
    w_out: torch.Tensor  # (H,)
    b_out: torch.Tensor  # () float32
    act_scales: Optional[Tuple[float, ...]] = None


def quantize_folded(folded: FoldedOutputMLP,
                    act_scales: Optional[Tuple[float, ...]] = None) -> Int8FoldedOutputMLP:
    """Symmetric per-output-channel int8 quantization of the hidden GEMMs:
    ``s_w = max(max|W| over axis 0, 1e-12) / 127``, ``Wq = clip(round(W /
    s_w), -127, 127)``."""
    if folded.w1_prod is not None:
        raise ValueError("int8 path does not support concatenation_prod")
    hidden_q = []
    for W, b in folded.hidden:
        Wf = W.float()
        s_w = torch.clamp(Wf.abs().amax(dim=0), min=1e-12) / 127.0
        Wq = torch.clamp(torch.round(Wf / s_w[None, :]), -127, 127).to(torch.int8)
        hidden_q.append((Wq, s_w, b.float()))
    if act_scales is not None and len(act_scales) != len(hidden_q):
        raise ValueError(f"{len(act_scales)} act_scales for {len(hidden_q)} hidden layers")
    return Int8FoldedOutputMLP(
        w1_p=folded.w1_p, w1_l=folded.w1_l, b1=folded.b1, hidden_q=hidden_q,
        w_out=folded.w_out, b_out=folded.b_out,
        act_scales=None if act_scales is None else tuple(float(s) for s in act_scales))


def act_scale_maxes(folded: FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                    label_tile: int = 512, max_tiles: int = 4) -> torch.Tensor:
    """Per hidden layer, the max |GEMM input| over the first ``max_tiles``
    label tiles: a (num_hidden,) float32 tensor on the inputs' device.

    As the JAX function: bfloat16 operands with float32 products, the bf16
    hidden chain, and the max taken over each layer's float32 (unrounded)
    input."""
    B = P_e.shape[0]
    a, c = _side_partials(folded, P_e, L_e, torch.bfloat16)
    num_tiles = min(-(-L_e.shape[0] // label_tile), max_tiles)
    maxes = [torch.zeros((), dtype=torch.float32, device=P_e.device)] * len(folded.hidden)
    for t in range(num_tiles):
        c_t = c[t * label_tile : (t + 1) * label_tile]
        h = torch.relu(a[:, None, :] + c_t[None, :, :]).reshape(B * c_t.shape[0], -1)
        for i, (W, b) in enumerate(folded.hidden):
            maxes[i] = torch.maximum(maxes[i], h.abs().max())
            h = torch.relu(_f32_product(h, W, torch.bfloat16) + b.float())
    return torch.stack(maxes)


def calibrate_act_scales(folded: FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                         label_tile: int = 512, margin: float = 1.05,
                         max_tiles: int = 4) -> Tuple[float, ...]:
    """Static activation scales from one calibration batch: per hidden
    layer ``max |input| * margin / 127`` (in Python floats, as JAX)."""
    maxes = act_scale_maxes(folded, P_e, L_e, label_tile, max_tiles)
    return tuple(float(m) * margin / 127.0 for m in maxes.cpu().tolist())


def _f32(x: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar on ``device`` (on CUDA, PyTorch divides by a Python
    number or a CPU scalar as a multiply by its reciprocal; every step here
    says which of the two it does)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _inv(x: float, device: torch.device) -> torch.Tensor:
    """``float32(1) / float32(x)``, correctly rounded, on ``device``: the
    constant XLA multiplies by where the JAX source divides by the constant
    ``x`` (its algebraic simplifier turns ``a / c`` into ``a * (1 / c)``)."""
    return (1.0 / torch.tensor(x, dtype=torch.float32)).to(device)


def _int_product(hq: torch.Tensor, Wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 codes: ``torch._int_mm`` (any shape on
    the CPU; on CUDA it wants more than 16 rows, so short inputs are
    padded)."""
    m = hq.shape[0]
    if hq.is_cuda and m <= 16:
        hq = torch.cat([hq, hq.new_zeros(17 - m, hq.shape[1])])
    return torch._int_mm(hq, Wq)[:m]


def _codes(x: torch.Tensor, lo: int) -> torch.Tensor:
    """``clip(round(x), lo, 127)`` as int8 (round half to even)."""
    return torch.clamp(torch.round(x), lo, 127).to(torch.int8)


def _row_scales(h: torch.Tensor) -> torch.Tensor:
    """Dynamic per-row scales of bf16 activations (R, H) -> (R, 1) float32:
    ``max(max |h[:, ::stride]| * margin, 1e-12) * float32(1 / 127)`` with
    stride 8 and margin 1.3 when H >= 1024, else stride 1 and no margin."""
    stride = 8 if h.shape[1] >= 1024 else 1
    m = h[:, ::stride].float().abs().amax(dim=1, keepdim=True)
    if stride > 1:
        m = m * _f32(1.3, h.device)
    return torch.clamp(m, min=1e-12) * _inv(127.0, h.device)


def _int8_hidden_reference(q: Int8FoldedOutputMLP, h: torch.Tensor,
                           carry_of: Optional[int] = None) -> torch.Tensor:
    """The hidden layers of one tile: ``h`` (R, H) float32 ``relu(a + c)``
    rows in, the last layer's bf16 activations out; with ``carry_of = i``,
    what layer ``i`` (0-based, not the last) carries to the next instead
    (int8 codes with static scales, bf16 activations with dynamic ones).

    Static (the int8 carry chain): ``hq = clip(round(bf16(h) * (1 / s0)),
    -127, 127)``; per layer ``y = int32 product``, ``alpha = s_i * s_w``,
    then ``clip(round(bf16(relu(y * alpha + b)) * (1 / s_{i+1})), 0, 127)``,
    or for the last layer ``bf16(relu(y * alpha + b))``.  Dynamic: per layer
    the row scales of the bf16 input, ``hq = clip(round(h / s_act), -127,
    127)`` (a true division: ``s_act`` is data), ``bf16(relu(y * (s_act *
    s_w) + b))``."""
    dev = h.device
    static = q.act_scales
    n = len(q.hidden_q)
    if static is not None and n:
        hq = _codes(h.to(torch.bfloat16).float() * _inv(static[0], dev), -127)
        for i, (Wq, s_w, b) in enumerate(q.hidden_q):
            y = _int_product(hq, Wq).float()
            out = torch.relu(y * (_f32(static[i], dev) * s_w)[None, :] + b)
            if i + 1 == n:
                return out.to(torch.bfloat16)
            hq = _codes(out.to(torch.bfloat16).float() * _inv(static[i + 1], dev), 0)
            if carry_of == i:
                return hq
    h = h.to(torch.bfloat16)
    for i, (Wq, s_w, b) in enumerate(q.hidden_q):
        s_act = _row_scales(h)
        y = _int_product(_codes(h.float() / s_act, -127), Wq)
        h = torch.relu(y.float() * (s_act * s_w[None, :]) + b).to(torch.bfloat16)
        if carry_of == i:
            return h
    return h


def pair_logits_tiled_int8_reference(
    q: Int8FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the JAX ``pair_logits_tiled_int8``: (B, L)
    float32 logits.  The int32 GEMMs are exact (``torch._int_mm``); every
    other step rounds where the compiled JAX chain does.

    The JAX source divides by the static scales and by 127, but runs inside
    ``lax.map``, where they are compile-time constants, and XLA compiles a
    division by a constant into a multiply by its float32 reciprocal; the
    port does what XLA runs (:func:`_inv`).  Divisions by data (the dynamic
    ``h / s_act``, the weight scales) stay divisions."""
    B = P_e.shape[0]
    a, c = _side_partials(q, P_e, L_e, compute_dtype)
    logits = torch.empty(B, L_e.shape[0], dtype=torch.float32, device=P_e.device)
    for l0 in range(0, L_e.shape[0], label_tile):
        c_t = c[l0 : l0 + label_tile]
        nl = c_t.shape[0]
        h = torch.relu(a[:, None, :] + c_t[None, :, :]).reshape(B * nl, -1)
        h = _int8_hidden_reference(q, h)
        out = _f32_product(h, q.w_out[:, None], compute_dtype)[:, 0]
        logits[:, l0 : l0 + nl] = (out + q.b_out).reshape(B, nl)
    return logits


def int8_carry_reference(q: Int8FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                         l0: int, nl: int, compute_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """What the first hidden layer carries to the second for the label chunk
    ``[l0, l0 + nl)``: (B * nl, H) int8 codes (static) or bf16 (dynamic)."""
    a, c = _side_partials(q, P_e, L_e, compute_dtype)
    h = torch.relu(a[:, None, :] + c[None, l0 : l0 + nl, :]).reshape(P_e.shape[0] * nl, -1)
    return _int8_hidden_reference(q, h, carry_of=0)


# Launches of K2's two entry points since the process started (or since a
# caller last set them to 0): pair_int8_layer once per hidden layer per
# label chunk; pair_int8_row_scale once before each of those with dynamic
# scales.
INT8_LAUNCHES = {"pair_int8_layer": 0, "pair_int8_row_scale": 0}

# pair_int8_layer's mode: where its A operand comes from, where its
# epilogue goes, and whether the scales are per row (csrc/pair_scorer_int8.cu)
_A_FIRST, _A_CODES, _A_BF16 = 0, 1, 2
_E_CODES, _E_BF16, _E_DOT = 0, 1, 2


def check_int8_kernel_inputs(q: Int8FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                             compute_dtype: torch.dtype) -> None:
    """Raise on what the int8 CUDA kernel does not take (no fallback)."""
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the int8 CUDA pair scorer computes its side products in "
                         f"bfloat16, not {compute_dtype} (MIXED_PRECISION: True)")
    if not q.hidden_q:
        raise ValueError("the int8 CUDA pair scorer needs at least one hidden layer "
                         "(OUTPUT_MLP_NUM_LAYERS >= 2)")
    H = q.w1_p.shape[1]
    if H % _BLOCK_N:
        raise ValueError(f"hidden width {H} is not a multiple of {_BLOCK_N}")
    for Wq, s_w, b in q.hidden_q:
        if tuple(Wq.shape) != (H, H) or Wq.dtype != torch.int8 or \
                tuple(s_w.shape) != (H,) or tuple(b.shape) != (H,):
            raise ValueError(f"int8 hidden layer {tuple(Wq.shape)} {Wq.dtype} does not "
                             f"match width {H}")
    if P_e.dim() != 2 or L_e.dim() != 2 or P_e.shape[1] != L_e.shape[1]:
        raise ValueError(f"P_e {tuple(P_e.shape)} and L_e {tuple(L_e.shape)} "
                         "must be (B, d) and (L, d)")


class _Int8Kernel:
    """The wrapper's per-call state: the per-side products, the weights laid
    out for the kernel, the chunk workspaces and the C entry points."""

    def __init__(self, q: Int8FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                 tile: int, compute_dtype: torch.dtype):
        from protnote_tpu_torch.ops.kernels import load_kernel_library

        check_int8_kernel_inputs(q, P_e, L_e, compute_dtype)
        device = P_e.device
        tensors = [P_e, L_e, q.w1_p, q.w1_l, q.b1, q.w_out, q.b_out] + \
            [t for layer in q.hidden_q for t in layer]
        if any(t.device != device for t in tensors) or device.type != "cuda":
            raise ValueError("the int8 CUDA pair scorer needs every tensor on one CUDA device")
        self.device = device
        self.B, self.L = P_e.shape[0], L_e.shape[0]
        self.H = q.w1_p.shape[1]
        a, c = _side_partials(q, P_e, L_e, compute_dtype)
        self.a, self.c = a.contiguous(), c.contiguous()
        # B operand column-major, (N, K): the layout the s8 tensor-core
        # products take, laid out once per call
        self.wt = [Wq.t().contiguous() for Wq, _, _ in q.hidden_q]
        self.s_w = [s_w.float().contiguous() for _, s_w, _ in q.hidden_q]
        self.bias = [b.float().contiguous() for _, _, b in q.hidden_q]
        self.w_out = q.w_out.to(torch.bfloat16).contiguous()
        self.b_out = q.b_out
        self.static = q.act_scales
        self.tile = tile
        n = len(q.hidden_q)
        carry = torch.int8 if self.static is not None else torch.bfloat16
        self.work = [torch.empty(self.B * tile, self.H, dtype=carry, device=device)
                     for _ in range(min(n - 1, 2))]
        self.row_scale = (torch.empty(self.B * tile, dtype=torch.float32, device=device)
                          if self.static is None else None)
        lib = load_kernel_library("pair_scorer_int8").lib
        self.layer_fn = lib.pair_int8_layer
        self.layer_fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_float] * 3 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        self.layer_fn.restype = ctypes.c_int
        self.scale_fn = lib.pair_int8_row_scale
        self.scale_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        self.scale_fn.restype = ctypes.c_int
        self.stream = torch.cuda.current_stream(device).cuda_stream

    def chunk(self, l0: int, nl: int, logits: Optional[torch.Tensor],
              stop_after: Optional[int] = None) -> Optional[torch.Tensor]:
        """Launch every hidden layer of the label chunk ``[l0, l0 + nl)``
        (adding its logits into ``logits``); with ``stop_after = i``, stop
        after layer ``i`` and return the rows it carries."""
        n, M, H = len(self.wt), self.B * nl, self.H
        dyn = self.static is None
        stride = 8 if H >= 1024 else 1
        x_in = None
        for i in range(n):
            last = i == n - 1
            x_out = None if last else self.work[i % 2]
            if dyn:
                err = self.scale_fn(_ptr(self.a), _ptr(self.c), _ptr(x_in),
                                    _ptr(self.row_scale), nl, l0, M, H, stride,
                                    1.3 if stride > 1 else 1.0, int(i == 0), self.stream)
                if err != 0:
                    raise RuntimeError(f"pair_int8_row_scale launch failed: CUDA error {err}")
                with _launch_lock:
                    INT8_LAUNCHES["pair_int8_row_scale"] += 1
            a_mode = _A_FIRST if i == 0 else (_A_BF16 if dyn else _A_CODES)
            e_mode = _E_DOT if last else (_E_BF16 if dyn else _E_CODES)
            # static: the layer's scale, and the reciprocals of the scales
            # its input and output codes are quantized with (as XLA runs)
            s_in = inv_in = inv_next = 0.0
            if not dyn:
                s_in, inv_in = self.static[i], float(_inv(self.static[i], "cpu"))
                if not last:
                    inv_next = float(_inv(self.static[i + 1], "cpu"))
            err = self.layer_fn(_ptr(self.a), _ptr(self.c), _ptr(x_in), _ptr(self.wt[i]),
                                _ptr(self.s_w[i]), _ptr(self.bias[i]), _ptr(self.row_scale),
                                _ptr(x_out), _ptr(self.w_out), _ptr(logits), s_in, inv_in,
                                inv_next, nl, l0, self.L, M, H, H,
                                a_mode | (e_mode << 2) | (int(dyn) << 4), self.stream)
            if err != 0:
                raise RuntimeError(f"pair_int8_layer launch failed: CUDA error {err}")
            with _launch_lock:
                INT8_LAUNCHES["pair_int8_layer"] += 1
            if stop_after == i:
                return x_out[:M]
            x_in = x_out
        return None


def pair_logits_tiled_int8_cuda(
    q: Int8FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K2's wrapper: (B, L) float32 logits for CUDA tensors.

    Per chunk of ``label_tile`` labels, one ``pair_int8_layer`` launch per
    hidden layer (with dynamic scales each preceded by a
    ``pair_int8_row_scale`` launch): the first forms its int8 codes from
    ``a``, ``c`` in shared memory, the last reduces against ``w_out`` into
    the logits (pre-filled with ``b_out``), and a layer between writes its
    int8 codes (static) or bf16 activations (dynamic) to a chunk
    workspace."""
    k = _Int8Kernel(q, P_e, L_e, min(int(label_tile), L_e.shape[0]), compute_dtype)
    logits = torch.empty(k.B, k.L, dtype=torch.float32, device=k.device)
    logits.copy_(q.b_out.float().expand(k.B, k.L))  # the kernel adds into it
    with torch.cuda.device(k.device):  # the C launch goes to the thread's device
        for l0 in range(0, k.L, k.tile):
            k.chunk(l0, min(k.tile, k.L - l0), logits)
    return logits


def int8_carry_cuda(q: Int8FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                    l0: int, nl: int, compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """:func:`int8_carry_reference` through the kernel: layer 1 of one
    label chunk, launched alone (its launches count)."""
    if len(q.hidden_q) < 2:
        raise ValueError("a carry needs at least two hidden layers")
    k = _Int8Kernel(q, P_e, L_e, nl, compute_dtype)
    with torch.cuda.device(k.device):
        return k.chunk(l0, nl, None, stop_after=0).clone()


def pair_logits_tiled_int8(
    q: Int8FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Inference pair scoring with int8 hidden GEMMs: (B, L) float32
    logits.  CPU tensors take :func:`pair_logits_tiled_int8_reference`;
    CUDA tensors take the kernel (:func:`pair_logits_tiled_int8_cuda`)."""
    if P_e.device.type == "cpu":
        return pair_logits_tiled_int8_reference(q, P_e, L_e, label_tile, compute_dtype)
    if P_e.device.type == "cuda":
        return pair_logits_tiled_int8_cuda(q, P_e, L_e, label_tile, compute_dtype)
    raise ValueError(f"no int8 pair scorer for device {P_e.device}")


# ----------------------------------------------------------------------
# Similarity fusion (reference ProtNote.py:281-284)


def similarity_logits(P_e: torch.Tensor, L_e: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    gemm_precision(P_e.dtype)
    pn = P_e / torch.linalg.vector_norm(P_e, dim=-1, keepdim=True).clamp(min=1e-12)
    ln = L_e / torch.linalg.vector_norm(L_e, dim=-1, keepdim=True).clamp(min=1e-12)
    return (pn @ ln.T) / temperature
