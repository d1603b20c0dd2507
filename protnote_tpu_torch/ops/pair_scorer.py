"""Pairwise (sequence x label) fusion-MLP scoring, eval path.

Port of ``protnote_tpu/ops/pair_scorer.py``.  The first MLP layer is
decomposed per side (``W1 @ concat(p, l) = W1p@p + W1l@l``), eval BatchNorm is
folded into the weights (:func:`fold_output_mlp`), and each (sequence, label)
pair then runs ``relu(a[b] + c[l])`` through the hidden H x H GEMM + bias +
ReLU layers and a dot with ``w_out``.

:func:`pair_logits_tiled` is the entry point.  For tensors on the CPU it runs
the plain PyTorch version, :func:`pair_logits_tiled_reference`; for CUDA
tensors it launches the hand-written kernel ``csrc/pair_scorer.cu`` (bf16) or
``csrc/pair_scorer_f32.cu`` (float32, ``MIXED_PRECISION: False``: every
product at float32's precision through a split into three bf16 pieces, see
:func:`split_bf16x3`) and never falls back to the plain version: input the
kernel does not take raises.

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


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` (float32) as three bf16 tensors whose sum is ``x`` exactly:
    each the previous remainder rounded to nearest (the remainders are exact
    in float32, the last has at most 8 significant bits).  The float32
    kernel splits its A operand so in registers and takes W's pieces from
    here, once a call."""
    x = x.float()
    x0 = x.to(torch.bfloat16)
    r1 = x - x0.float()
    x1 = r1.to(torch.bfloat16)
    return x0, x1, (r1 - x1.float()).to(torch.bfloat16)


def stacked_pieces(w: torch.Tensor, transpose: bool) -> torch.Tensor:
    """W (K, N) float32 as its three bf16 pieces (:func:`split_bf16x3`),
    stacked: (3N, K), each piece transposed to K-major (the B operand of K1's
    and K4's float32 forms), or (3K, N), W's own rows (K4-bwd's float32 dX)."""
    return torch.cat([p.t() if transpose else p for p in split_bf16x3(w)]).contiguous()


# the six products of the split that keep float32's precision, (A piece, W
# piece), in the order the kernel issues them: a stage's five small cross
# products for each k-step, then its x0 w0 products
BF16X3_TERMS = ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
K_STAGE = 64  # the kernel's reduction depth a stage
K_STEP = 16  # wgmma's depth


def bf16x3_product_emulation(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (float32) as ``pair_mlp_layer_f32`` computes it, emulated on
    the CPU: both operands split by :func:`split_bf16x3`; per stage of
    ``K_STAGE`` a fresh float32 partial sum takes, k-step by k-step, the five
    small products of :data:`BF16X3_TERMS`, then the stage's ``x0 w0``
    products (each a float32 product of bf16 values, exact, summed in
    float32), and is added into the result.  The tensor cores' own
    summation, whose adds are not float32's rounded ones, is not modelled:
    the kernel keeps it to a stage."""
    xs = [t.float() for t in split_bf16x3(x)]
    ws = [t.float() for t in split_bf16x3(w)]
    out = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, x.shape[1], K_STAGE):
        steps = range(k0, min(k0 + K_STAGE, x.shape[1]), K_STEP)
        part = torch.zeros_like(out)
        for k in steps:
            for i, j in BF16X3_TERMS:
                part += xs[i][:, k : k + K_STEP] @ ws[j][k : k + K_STEP]
        for k in steps:
            part += xs[0][:, k : k + K_STEP] @ ws[0][k : k + K_STEP]
        out += part
    return out


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
# caller last set it to 0): one per hidden layer per label chunk; and of its
# zero-hidden-layer head (``pair_mlp_head``): one a call, or with
# ``concatenation_prod`` one per label chunk.
LAUNCHES = 0
HEAD_LAUNCHES = 0
# The float32 forms' launches, counted alike: K1's float32 layers
# (``pair_mlp_layer_f32``), its prod layer (the same entry point, once per
# label chunk), its head (``pair_mlp_head_f32``), and K2's layers in a
# float32 call (``pair_int8_layer`` with a float32 ``w_out``) with static and
# with dynamic scales.
F32_LAUNCHES = {"pair_mlp_layer_f32": 0, "pair_mlp_layer_f32_prod": 0, "pair_mlp_head_f32": 0,
                "pair_int8_layer_f32": 0, "pair_int8_layer_f32_dynamic": 0}
_launch_lock = threading.Lock()
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _count(name: str) -> None:
    with _launch_lock:
        F32_LAUNCHES[name] += 1

_BLOCK_N = 128  # the width every hidden layer must be a multiple of (K1, K2, K4)
BLOCK_M = 128  # K1's, K2's and K4's pair rows a tile (BM in the kernels)
# K1's pair rows a launch: a chunk holds this many rows over its B sequences
# (256 labels at B 32), rounded down to whole row tiles.  At 8,192 rows the
# bf16 activations between two layers (50 MB at H 3072) mostly stay in L2;
# on an H100 the serving batch ran ~4% faster than at 16,384 or 32,768 rows
# (chip_smoke.py, "ms_by_target_rows").
TARGET_ROWS = 8192
_H100_SMS = 132


@dataclass(frozen=True)
class ChunkLaunch:
    """One label chunk of K1 or K2: labels ``[l0, l0 + nl)``, padded to ``nl_pad``
    rows a sequence, so its pair rows are ``r = b * nl_pad + l`` and every
    128-row tile lies within one sequence."""

    l0: int
    nl: int
    nl_pad: int
    tiles_m: int  # row tiles: B * nl_pad / BLOCK_M
    tiles_n: int  # column tiles: H / block_n
    grid: int  # persistent blocks: min(SMs, tiles)


@dataclass(frozen=True)
class LaunchPlan:
    """K1's launch geometry for one call: the column tile, the chunks, and
    the order of launches (each chunk's hidden layers in turn)."""

    batch: int
    n_hidden: int
    block_n: int
    chunk: int  # labels a chunk (a multiple of BLOCK_M)
    chunks: Tuple[ChunkLaunch, ...]

    @property
    def workspace_rows(self) -> int:
        """Rows of each bf16 activation workspace (the largest chunk's)."""
        return self.batch * max(ch.nl_pad for ch in self.chunks)

    def launches(self) -> List[Tuple[ChunkLaunch, int, int]]:
        """(chunk, hidden layer, mode) in launch order; mode bit 0: A formed
        from ``a`` and ``c`` (the first layer), bit 1: the dot with ``w_out``
        into the logits (the last layer)."""
        n = self.n_hidden
        return [(ch, i, (1 if i == 0 else 0) | (2 if i == n - 1 else 0))
                for ch in self.chunks for i in range(n)]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_plan(B: int, L: int, H: int, n_hidden: int, num_sms: int = _H100_SMS,
                target_rows: Optional[int] = None) -> LaunchPlan:
    """K1's chunks and tiles for B sequences against L label rows at hidden
    width H.  Pair rows are independent, so the chunk (``target_rows`` pair
    rows, whole row tiles a sequence) need not be the caller's
    ``label_tile``: the logits are the same.  The column tile is 256 where H
    allows it, else 128."""
    if B <= 0 or L <= 0 or n_hidden <= 0:
        raise ValueError(f"no launch plan for B {B}, L {L}, {n_hidden} hidden layers")
    if H % _BLOCK_N:
        raise ValueError(f"hidden width {H} is not a multiple of {_BLOCK_N}")
    block_n = _block_n(H)
    target_rows = TARGET_ROWS if target_rows is None else target_rows
    chunk = max(BLOCK_M, target_rows // B // BLOCK_M * BLOCK_M)
    chunk = min(chunk, _round_up(L, BLOCK_M))
    chunks = tuple(_chunk_launch(B, l0, min(chunk, L - l0), H, num_sms)
                   for l0 in range(0, L, chunk))
    return LaunchPlan(B, n_hidden, block_n, chunk, chunks)


def single_chunk_plan(B: int, H: int, n_hidden: int, l0: int, nl: int,
                      num_sms: int = _H100_SMS) -> LaunchPlan:
    """A plan of the one chunk ``[l0, l0 + nl)``, padded to whole row tiles
    a sequence: K2's carried rows of any chunk."""
    if B <= 0 or nl <= 0 or l0 < 0 or n_hidden <= 0:
        raise ValueError(f"no chunk for B {B}, labels [{l0}, {l0 + nl}), {n_hidden} layers")
    if H % _BLOCK_N:
        raise ValueError(f"hidden width {H} is not a multiple of {_BLOCK_N}")
    ch = _chunk_launch(B, l0, nl, H, num_sms)
    return LaunchPlan(B, n_hidden, _block_n(H), ch.nl_pad, (ch,))


def _block_n(H: int) -> int:
    """The column tile: 256 where H allows it, else 128."""
    return 256 if H % 256 == 0 else 128


def _chunk_launch(B: int, l0: int, nl: int, H: int, num_sms: int) -> ChunkLaunch:
    nl_pad = _round_up(nl, BLOCK_M)
    tiles_m, tiles_n = B * nl_pad // BLOCK_M, H // _block_n(H)
    return ChunkLaunch(l0, nl, nl_pad, tiles_m, tiles_n, min(num_sms, tiles_m * tiles_n))


def pair_logits_plan_reference(folded: FoldedOutputMLP, P_e: torch.Tensor,
                               L_e: torch.Tensor, plan: LaunchPlan,
                               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain chain over K1's padded chunk layout: per chunk, rows
    ``b * nl_pad + l`` with ``c`` rows past ``L`` zero (as TMA fills them),
    and for ``w1_prod`` the label rows past ``L`` zero too, the hidden layers
    over all padded rows, and only rows ``l < nl`` taken into the (B, L)
    float32 logits."""
    B, L = P_e.shape[0], L_e.shape[0]
    a, c = _side_partials(folded, P_e, L_e, compute_dtype)
    logits = torch.empty(B, L, dtype=torch.float32, device=P_e.device)

    def padded(t, ch):
        t = t[ch.l0 : ch.l0 + ch.nl_pad]
        return torch.cat([t, t.new_zeros(ch.nl_pad - t.shape[0], t.shape[1])])

    for ch in plan.chunks:
        pre1 = a[:, None, :] + padded(c, ch)[None]
        if folded.w1_prod is not None:
            prod = (P_e[:, None, :] * padded(L_e, ch)[None]).reshape(B * ch.nl_pad, -1)
            pre1 = pre1 + _f32_product(prod, folded.w1_prod, compute_dtype).view(pre1.shape)
        h = torch.relu(pre1).reshape(B * ch.nl_pad, -1).to(compute_dtype)
        for W, b in folded.hidden:
            h = torch.relu(_f32_product(h, W, compute_dtype) + b.float()).to(compute_dtype)
        out = _f32_product(h, folded.w_out[:, None], compute_dtype)[:, 0]
        logits[:, ch.l0 : ch.l0 + ch.nl] = (out.reshape(B, ch.nl_pad)[:, : ch.nl]
                                            + folded.b_out)
    return logits


def check_kernel_inputs(folded: FoldedOutputMLP, P_e: torch.Tensor,
                        L_e: torch.Tensor, compute_dtype: torch.dtype) -> None:
    """Raise on what the CUDA kernel does not take (there is no fallback)."""
    if compute_dtype not in KERNEL_DTYPES:
        raise ValueError(f"the CUDA pair scorer computes in bfloat16 or float32, not "
                         f"{compute_dtype}")
    H = folded.w1_p.shape[1]
    if H % _BLOCK_N:
        raise ValueError(f"hidden width {H} is not a multiple of {_BLOCK_N}")
    if folded.w1_prod is not None and (tuple(folded.w1_prod.shape) != tuple(folded.w1_p.shape)
                                       or folded.w1_p.shape[0] % _BLOCK_N):
        raise ValueError(f"w1_prod {tuple(folded.w1_prod.shape)} must be (d, {H}) with d a "
                         f"multiple of {_BLOCK_N}")
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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _f32_layer_fn():
    """``pair_mlp_layer_f32`` (``csrc/pair_scorer_f32.cu``) with its ctypes
    signature."""
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_scorer_f32", "pair_mlp_layer_f32",
                           [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


# pair_mlp_layer_f32's modes: where A comes from, and the dot bit
F32_A_X, F32_A_PAIR, F32_A_PROD, F32_DOT = 0, 1, 2, 4


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def k1_workspaces(i: int, mode: int, prod: bool) -> Tuple[Optional[int], Optional[int]]:
    """The workspaces (indices, or None) hidden layer ``i`` of a K1 chunk
    reads and writes: without prod, layer 0 forms its A (mode bit 0) and
    layer i reads layer i - 1's output from workspace (i - 1) % 2; with
    prod, ``pair_train_prod`` writes x1 to workspace 0 and layer i reads
    workspace i % 2.  The last layer (mode bit 1) writes none."""
    if prod:
        x_in, x_out = i % 2, (i + 1) % 2
    else:
        x_in, x_out = (None if mode & 1 else (i - 1) % 2), i % 2
    return x_in, None if mode & 2 else x_out


def k1_workspace_count(n_hidden: int, prod: bool) -> int:
    """The workspaces a call needs: prod keeps x1 in one even without a
    hidden layer."""
    return max(1, min(n_hidden, 2)) if prod else min(n_hidden - 1, 2)


class _K1Kernel:
    """The wrapper's per-call state: the per-side products, the weights
    transposed to K-major (the layout the kernel's TMA loads take, laid out
    once per call), the launch plan, the workspaces and the C entry point.

    ``concatenation_prod`` adds a first launch a chunk, ``pair_train_prod``
    (K4's mainloop, ``csrc/pair_train.cu``): ``relu(a + c + bf16(p * l) @
    w1_prod)`` into the first workspace, which the first hidden layer then
    reads.  With no hidden layer, ``pair_mlp_head`` takes the dot of the
    first ReLU with ``w_out``: formed from ``a`` and ``c`` for every label in
    one launch, or read from that workspace a chunk at a time.

    In float32 (``compute_dtype`` float32) every launch is
    ``csrc/pair_scorer_f32.cu``'s: ``pair_mlp_layer_f32`` for each layer (the
    prod layer too, from float32 ``P_e`` and ``L_e``), with each weight laid
    out as its three bf16 pieces (:func:`split_bf16x3`, stacked K-major),
    float32 workspaces, a float32 ``w_out``, and ``pair_mlp_head_f32`` with
    no hidden layer.  Nothing is rounded to bf16 but the split's exact
    pieces."""

    def __init__(self, folded: FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                 compute_dtype: torch.dtype):
        check_kernel_inputs(folded, P_e, L_e, compute_dtype)
        device = P_e.device
        tensors = [P_e, L_e, folded.w1_p, folded.w1_l, folded.b1, folded.w_out,
                   folded.b_out] + [t for pair in folded.hidden for t in pair]
        if folded.w1_prod is not None:
            tensors.append(folded.w1_prod)
        if any(t.device != device for t in tensors) or device.type != "cuda":
            raise ValueError("the CUDA pair scorer needs every tensor on one CUDA device")
        self.device = device
        self.f32 = compute_dtype == torch.float32
        self.B, self.L = P_e.shape[0], L_e.shape[0]
        self.H = folded.w1_p.shape[1]
        a, c = _side_partials(folded, P_e, L_e, compute_dtype)
        self.a, self.c = a.contiguous(), c.contiguous()
        self.prod = folded.w1_prod is not None
        if self.f32:
            wdt = torch.float32
            self.wt = [self.pieces(W) for W, _ in folded.hidden]
        else:
            wdt = torch.bfloat16
            self.wt = [W.to(wdt).t().contiguous() for W, _ in folded.hidden]
        if self.prod:
            self.P_e = P_e.to(wdt).contiguous()
            self.L_e = L_e.to(wdt).contiguous()
            self.w_prod = folded.w1_prod.to(wdt)
            self.wt_prod = self.pieces(self.w_prod) if self.f32 else self.w_prod.t().contiguous()
        self.bias = [b.float().contiguous() for _, b in folded.hidden]
        self.w_out = folded.w_out.to(wdt).contiguous()
        self.b_out = folded.b_out
        n = len(self.wt)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.plan = launch_plan(self.B, self.L, self.H, max(n, 1), sms)
        self.work = [torch.empty(self.plan.workspace_rows, self.H, dtype=wdt, device=device)
                     for _ in range(k1_workspace_count(n, self.prod))]
        self.fn = _f32_layer_fn() if self.f32 else _kernel_fn()
        self.stream = torch.cuda.current_stream(device).cuda_stream

    @staticmethod
    def pieces(W: torch.Tensor) -> torch.Tensor:
        """W (K, N) as its three bf16 pieces, each transposed to K-major and
        stacked: (3N, K), the layout ``pair_mlp_layer_f32`` loads."""
        return stacked_pieces(W, transpose=True)

    def new_logits(self) -> torch.Tensor:
        """(B, L) float32 logits pre-filled with ``b_out``: the kernel adds
        into them."""
        logits = torch.empty(self.B, self.L, dtype=torch.float32, device=self.device)
        return logits.copy_(self.b_out.float().expand(self.B, self.L))

    def modes(self) -> List[Tuple[int, int]]:
        """Each hidden layer's (layer, mode) in a chunk: mode bit 0, A formed
        from ``a`` and ``c`` (layer 0 without prod); bit 1, the dot with
        ``w_out`` (the last layer)."""
        n = len(self.wt)
        return [(i, (1 if i == 0 and not self.prod else 0) | (2 if i == n - 1 else 0))
                for i in range(n)]

    def launch(self, ch: ChunkLaunch, i: int, mode: int, logits: torch.Tensor) -> None:
        """Hidden layer ``i`` of chunk ``ch``: A from ``a``/``c`` or a
        workspace, out to a workspace or into ``logits``
        (:func:`k1_workspaces`)."""
        global LAUNCHES
        x_in, x_out = (None if j is None else self.work[j]
                       for j in k1_workspaces(i, mode, self.prod))
        if self.f32:
            fmode = (F32_A_PAIR if mode & 1 else F32_A_X) | (F32_DOT if mode & 2 else 0)
            row, tile = (self.a, self.c) if mode & 1 else (None, x_in)
            self._f32_layer(row, tile, self.wt[i], self.bias[i], None, None, x_out, logits,
                            ch, self.H, fmode, "pair_mlp_layer_f32")
            return
        err = self.fn(_ptr(self.a), _ptr(self.c), _ptr(x_in), _ptr(self.wt[i]),
                      _ptr(self.bias[i]), _ptr(x_out), _ptr(self.w_out), _ptr(logits),
                      self.B, ch.nl, ch.nl_pad, ch.l0, self.L, self.H, self.H,
                      self.plan.block_n, mode, ch.grid, self.stream)
        if err != 0:
            raise RuntimeError(f"pair_mlp_layer launch failed: CUDA error {err}")
        with _launch_lock:
            LAUNCHES += 1

    def _f32_layer(self, row, tile, wt3, bias, ea, ec, x_out, logits, ch: ChunkLaunch, K: int,
                   mode: int, name: str) -> None:
        err = self.fn(_ptr(row), _ptr(tile), _ptr(wt3), _ptr(bias), _ptr(ea), _ptr(ec),
                      _ptr(x_out), _ptr(self.w_out), _ptr(logits), self.B, ch.nl, ch.nl_pad,
                      ch.l0, self.L, K, self.H, mode, ch.grid, self.stream)
        if err != 0:
            raise RuntimeError(f"pair_mlp_layer_f32 launch failed: CUDA error {err}")
        _count(name)

    def first_prod(self, ch: ChunkLaunch) -> None:
        """x1 of chunk ``ch`` into workspace 0 (rows ``b * nl_pad + l``)."""
        if self.f32:
            self._f32_layer(self.P_e, self.L_e, self.wt_prod, None, self.a, self.c, self.work[0],
                            None, ch, self.P_e.shape[1], F32_A_PROD, "pair_mlp_layer_f32_prod")
            return
        from protnote_tpu_torch.ops.dense_scorer import pair_prod_cuda

        sl = slice(ch.l0, ch.l0 + ch.nl)
        pair_prod_cuda(self.a, self.c[sl], self.P_e, self.L_e[sl], self.w_prod, relu=True,
                       out=self.work[0], rows_per_seq=ch.nl_pad, wt=self.wt_prod)

    def head(self, logits: torch.Tensor, ch: Optional[ChunkLaunch] = None) -> None:
        """The zero-hidden-layer chain into ``logits``: of chunk ``ch`` from
        workspace 0 (prod), or of every label from ``a`` and ``c`` in one
        launch."""
        global HEAD_LAUNCHES
        x = self.work[0] if ch is not None else None
        l0, nl, nl_pad = (0, self.L, self.L) if ch is None else (ch.l0, ch.nl, ch.nl_pad)
        err = _head_fn(self.f32)(_ptr(self.a), _ptr(self.c), _ptr(x), _ptr(self.w_out),
                                 _ptr(logits), self.B, nl, nl_pad, l0, self.L, self.H,
                                 self.stream)
        name = "pair_mlp_head_f32" if self.f32 else "pair_mlp_head"
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        if self.f32:
            _count(name)
            return
        with _launch_lock:
            HEAD_LAUNCHES += 1

    def run(self) -> torch.Tensor:
        logits = self.new_logits()
        with torch.cuda.device(self.device):  # the C launch goes to the thread's device
            if not self.wt and not self.prod:
                self.head(logits)
                return logits
            for ch in self.plan.chunks:
                if self.prod:
                    self.first_prod(ch)
                if not self.wt:
                    self.head(logits, ch)
                for i, mode in self.modes():
                    self.launch(ch, i, mode, logits)
        return logits


def _head_fn(f32: bool = False):
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("pair_scorer", "pair_mlp_head_f32" if f32 else "pair_mlp_head",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def pair_logits_tiled_cuda(
    folded: FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's wrapper: (B, L) float32 logits for CUDA tensors.

    Per label chunk of :func:`launch_plan` (``TARGET_ROWS`` pair rows, not
    ``label_tile``: pair rows are independent, so the logits are the same)
    it launches one kernel per hidden layer: the first forms ``relu(a[b] +
    c[l])`` in registers as its A operand, the last reduces its activations
    against ``w_out`` into the logits (pre-filled with ``b_out``), and any
    layer between reads and writes bf16 activations in a workspace.  With
    ``w1_prod`` a first launch (``pair_train_prod``) writes ``relu(a + c +
    bf16(p * l) @ w1_prod)`` for the first hidden layer to read; with no
    hidden layer ``pair_mlp_head`` takes the first ReLU's dot with
    ``w_out``.  In float32 the same launches go to ``pair_mlp_layer_f32``
    (the prod layer too) and ``pair_mlp_head_f32`` (:class:`_K1Kernel`)."""
    del label_tile
    return _K1Kernel(folded, P_e, L_e, compute_dtype).run()


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


def _chunk_inputs(a: torch.Tensor, c: torch.Tensor, ch: ChunkLaunch) -> torch.Tensor:
    """``relu(a[b] + c[l0 + l])`` in float32 for the rows ``b * nl_pad + l``
    of a chunk of :func:`launch_plan`; the padding rows ``l >= nl`` take
    ``c = 0`` (K2's code passes do the same; their logits are dropped)."""
    B, H = a.shape
    c_t = torch.cat([c[ch.l0 : ch.l0 + ch.nl], c.new_zeros(ch.nl_pad - ch.nl, H)])
    return torch.relu(a[:, None, :] + c_t[None]).reshape(B * ch.nl_pad, H)


def chunk_rows(x: torch.Tensor, B: int, ch: ChunkLaunch) -> torch.Tensor:
    """The rows ``l < nl`` of a chunk workspace laid out ``b * nl_pad + l``,
    as (B * nl, H) in (b, l) order: what a layer carries for the labels
    ``[l0, l0 + nl)``."""
    H = x.shape[1]
    return x[: B * ch.nl_pad].view(B, ch.nl_pad, H)[:, : ch.nl].reshape(B * ch.nl, H)


def pair_logits_int8_plan_reference(q: Int8FoldedOutputMLP, P_e: torch.Tensor,
                                    L_e: torch.Tensor, plan: LaunchPlan,
                                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain int8 chain over K2's padded chunk layout (the launch plan it
    shares with K1): per chunk, the hidden layers over all ``B * nl_pad``
    rows, and only rows ``l < nl`` taken into the (B, L) float32 logits.
    Pair rows are independent, so the logits are those of
    :func:`pair_logits_tiled_int8_reference`."""
    B = P_e.shape[0]
    a, c = _side_partials(q, P_e, L_e, compute_dtype)
    logits = torch.empty(B, L_e.shape[0], dtype=torch.float32, device=P_e.device)
    for ch in plan.chunks:
        h = _int8_hidden_reference(q, _chunk_inputs(a, c, ch))
        out = _f32_product(h, q.w_out[:, None], compute_dtype)[:, 0]
        logits[:, ch.l0 : ch.l0 + ch.nl] = out.reshape(B, ch.nl_pad)[:, : ch.nl] + q.b_out
    return logits


def int8_codes_reference(a: torch.Tensor, c: torch.Tensor, ch: ChunkLaunch,
                         s0: float) -> torch.Tensor:
    """``pair_int8_codes``' plain version: layer 1's static codes
    ``clip(rint(bf16(relu(a + c)) * (1 / s0)), -127, 127)`` of a chunk's rows."""
    h = _chunk_inputs(a, c, ch).to(torch.bfloat16).float()
    return _codes(h * _inv(s0, a.device), -127)


def int8_row_scale_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pair_int8_row_scale``'s plain version on bf16 rows ``x``: the
    dynamic scales (R,) and the codes ``clip(rint(x / s_act), -127, 127)``."""
    s_act = _row_scales(x)
    return s_act[:, 0], _codes(x.float() / s_act, -127)


# Launches of K2's entry points since the process started (or since a caller
# last set them to 0): pair_int8_layer once per hidden layer per label chunk;
# with static scales pair_int8_codes once per chunk (layer 1's codes), with
# dynamic ones pair_int8_row_scale before every pair_int8_layer (for layer 1
# two kernels a launch: the scales, then the codes).
INT8_LAUNCHES = {"pair_int8_layer": 0, "pair_int8_codes": 0, "pair_int8_row_scale": 0}

CODE_THREADS = 256  # threads a block of layer 1's codes kernel
CODE_UNIT = 16  # columns a thread codes at once: one 16-byte store
CODE_SLICE_UNITS = 4  # units a block's column slice: 64 columns
CODE_SEQ_TILE = 32  # sequences a tile at most
SCALE_ROWS = 64  # pair rows a block of layer 1's scale kernel at most
SCALE_ROUND = 384  # sampled columns it stages a round


@dataclass(frozen=True)
class CodePlan:
    """The tiling of layer 1's codes kernel over a chunk of ``B`` sequences
    x ``nl_pad`` label rows x ``K`` columns (``csrc/pair_scorer_int8.cu``,
    ``CodePlan``): block ``i = (t * label_groups + g) * slices + s`` codes
    sequence tile ``t`` (``seq_tile`` sequences, the last may be short),
    label group ``g`` (``labels`` rows) and column slice ``s`` (``units``
    16-column units); its thread ``(u, li, sg) = (tid % units, tid // units %
    labels, tid // (units * labels))`` holds the ``c`` slice of label ``g *
    labels + li``, unit ``u`` in registers and codes it against the tile's
    sequences ``sg, sg + seq_groups, ...`` (``a``'s slice for the tile in
    shared memory)."""

    units: int
    labels: int
    seq_groups: int
    seq_tile: int
    label_groups: int
    seq_tiles: int
    slices: int

    @property
    def grid(self) -> int:
        return self.seq_tiles * self.label_groups * self.slices

    @property
    def args(self) -> Tuple[int, int, int, int]:
        """What the C entry points take: the rest follows from them."""
        return self.units, self.labels, self.seq_groups, self.seq_tile


def scale_labels(seq_tile: int) -> int:
    """Labels a block of layer 1's scale kernel takes: its rows are
    ``code_plan``'s sequence tile x these labels, at most ``SCALE_ROWS``,
    and each row is split over ``256 // rows`` threads."""
    return SCALE_ROWS // seq_tile if seq_tile < SCALE_ROWS else 1


def code_plan(B: int, nl_pad: int, K: int) -> CodePlan:
    """Layer 1's code tiling of a chunk: sequence tiles of at most 32, as
    even as they come; each thread reuses its ``c`` slice for half of the
    tile's sequences (all of a tile of 1), so a block holds 32 labels (64
    for a tile of 1); 64-column slices (a block writes 64 bytes of a row;
    32 and 16 were slower on an H100), so a chunk of 8,192 rows at K 3072 is
    384 blocks, one wave of 2-3 blocks an SM.  ``a`` then leaves L2 once a
    label group and ``c`` once a sequence tile."""
    if B <= 0 or nl_pad <= 0 or nl_pad % BLOCK_M or K % _BLOCK_N:
        raise ValueError(f"no code plan for B {B}, {nl_pad} padded labels, width {K}")
    seq_tiles = -(-B // CODE_SEQ_TILE)
    seq_tile = -(-B // seq_tiles)
    seq_groups = 2 if seq_tile >= 2 else 1
    units = CODE_SLICE_UNITS
    labels = CODE_THREADS // (units * seq_groups)
    return CodePlan(units, labels, seq_groups, seq_tile, nl_pad // labels, seq_tiles,
                    K // (CODE_UNIT * units))

# pair_int8_layer's epilogue (csrc/pair_scorer_int8.cu), and its mode bit for
# dynamic scales
_E_CODES, _E_BF16, _E_DOT = 0, 1, 2
_DYNAMIC = 4
_W32 = 8  # the last layer's w_out is float32 (compute_dtype float32)


def check_int8_kernel_inputs(q: Int8FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                             compute_dtype: torch.dtype) -> None:
    """Raise on what the int8 CUDA kernel does not take (no fallback)."""
    if compute_dtype not in KERNEL_DTYPES:
        raise ValueError(f"the int8 CUDA pair scorer computes its side products in "
                         f"bfloat16 or float32, not {compute_dtype}")
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
    out for the kernel (K-major, as its TMA loads take them), the launch
    plan, the chunk workspaces and the C entry points.

    In float32 (``compute_dtype`` float32) the side products are float32
    products of float32 operands and the last layer's epilogue dots its bf16
    activations with a float32 ``w_out`` (mode bit ``_W32``), as the JAX
    ``_tiled_scaffold`` does; the int8 chain between is the bf16 one, as JAX
    runs it whatever the compute dtype."""

    def __init__(self, q: Int8FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                 compute_dtype: torch.dtype, plan: Optional[LaunchPlan] = None):
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
        self.wt = [Wq.t().contiguous() for Wq, _, _ in q.hidden_q]
        self.s_w = [s_w.float().contiguous() for _, s_w, _ in q.hidden_q]
        self.bias = [b.float().contiguous() for _, _, b in q.hidden_q]
        self.f32 = compute_dtype == torch.float32
        self.w_out = q.w_out.to(compute_dtype).contiguous()
        self.b_out = q.b_out
        self.static = q.act_scales
        # the dynamic scales' sampled columns and margin (_row_scales' rule)
        self.stride = 8 if self.H >= 1024 else 1
        self.margin = 1.3 if self.stride > 1 else 1.0
        n = len(q.hidden_q)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        # K1's chunks: a chunk's int8 codes (8,192 rows x 3072 = 25 MB) stay
        # in L2 between the code pass and the GEMM
        self.plan = plan or launch_plan(self.B, self.L, self.H, n, sms)
        rows, H = self.plan.workspace_rows, self.H
        # static: each layer's input codes and its output codes alternate;
        # dynamic: one code workspace and one bf16 workspace
        n_codes = 2 if self.static is not None and n > 1 else 1
        self.codes = [torch.empty(rows, H, dtype=torch.int8, device=device)
                      for _ in range(n_codes)]
        dyn = self.static is None
        self.h = (torch.empty(rows, H, dtype=torch.bfloat16, device=device)
                  if dyn and n > 1 else None)
        self.row_scale = torch.empty(rows, dtype=torch.float32, device=device) if dyn else None
        # layer 1's dynamic scales: a's sampled columns, contiguous, and the
        # scales of every chunk's rows (one launch writes them all; chunk k's
        # rows start at B * (l0_k - l0_0))
        self.a_sub = self.a[:, ::self.stride].contiguous() if dyn else None
        first = self.plan.chunks[0]
        self.scales1 = torch.empty(self.B * sum(ch.nl_pad for ch in self.plan.chunks),
                                   dtype=torch.float32, device=device) if dyn else None
        # the reciprocals the static codes are quantized with (as XLA runs
        # the division by a constant), one a layer
        self.inv = None if dyn else [float(_inv(s, "cpu")) for s in self.static]
        lib = load_kernel_library("pair_scorer_int8").lib
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.layer_fn = lib.pair_int8_layer
        self.layer_fn.argtypes = [p] * 8 + [f] * 2 + [i] * 10 + [p]
        self.codes_fn = lib.pair_int8_codes
        self.codes_fn.argtypes = [p] * 3 + [i] * 5 + [f] + [i] * 4 + [p]
        self.scale_fn = lib.pair_int8_row_scale
        self.scale_fn.argtypes = [p] * 6 + [i] * 6 + [f] + [i] * 7 + [p]
        for fn in (self.layer_fn, self.codes_fn, self.scale_fn):
            fn.restype = ctypes.c_int
        self.stream = torch.cuda.current_stream(device).cuda_stream
        # the addresses of the dynamic scales each chunk's layer 1 and later
        # layers read, and every launch's arguments of the code passes (entry
        # point, count name, arguments) by (chunk, first layer): made once
        self.scale_ptrs = {ch: (_ptr(self.scales_of(ch, 0)), _ptr(self.scales_of(ch, 1)))
                           for ch in self.plan.chunks}
        self._quantize = {}
        ptrs, plans = (_ptr(self.a), _ptr(self.c)), {}
        last = self.plan.chunks[-1]
        n_labels = last.l0 + last.nl - first.l0
        for ch in self.plan.chunks:
            if ch.nl_pad not in plans:
                plans[ch.nl_pad] = code_plan(self.B, ch.nl_pad, H).args
            plan = plans[ch.nl_pad]
            if not dyn:
                self._quantize[ch, True] = (self.codes_fn, "pair_int8_codes", (
                    *ptrs, _ptr(self.codes[0]), self.B, ch.nl, ch.nl_pad, ch.l0, H,
                    self.inv[0], *plan, self.stream))
                continue
            # layer 1: the first chunk's launch also makes every chunk's scales
            mode = 2 if ch is first else 1
            for layer1 in (True, False):
                self._quantize[ch, layer1] = (self.scale_fn, "pair_int8_row_scale", (
                    ptrs[0], _ptr(self.a_sub), ptrs[1], None if layer1 else _ptr(self.h),
                    self.scale_ptrs[ch][not layer1], _ptr(self.codes[0]), self.B,
                    ch.nl, ch.nl_pad, ch.l0, H, self.stride, self.margin,
                    mode if layer1 else 0, *plan, n_labels, self.plan.chunk, self.stream))

    def scales_of(self, ch: ChunkLaunch, i: int) -> Optional[torch.Tensor]:
        """The dynamic row scales hidden layer ``i`` of chunk ``ch`` reads
        (``B * nl_pad`` rows; None with static scales)."""
        if self.static is not None:
            return None
        if i > 0:
            return self.row_scale[: self.B * ch.nl_pad]
        start = self.B * (ch.l0 - self.plan.chunks[0].l0)
        return self.scales1[start : start + self.B * ch.nl_pad]

    def _counted(self, name: str, err: int) -> None:
        """Raise on a failed launch, else count it: a float32 call's layers
        in ``F32_LAUNCHES`` (its code passes are the bf16 call's)."""
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        if self.f32 and name == "pair_int8_layer":
            _count("pair_int8_layer_f32" if self.static is not None
                   else "pair_int8_layer_f32_dynamic")
            return
        with _launch_lock:
            INT8_LAUNCHES[name] += 1

    def new_logits(self) -> torch.Tensor:
        """(B, L) float32 logits pre-filled with ``b_out``: the kernel adds
        into them."""
        logits = torch.empty(self.B, self.L, dtype=torch.float32, device=self.device)
        return logits.copy_(self.b_out.float().expand(self.B, self.L))

    def quantize(self, ch: ChunkLaunch, i: int) -> None:
        """Hidden layer ``i``'s input codes for chunk ``ch`` into
        ``codes[0]``: layer 1's static codes (``pair_int8_codes``), or the
        dynamic row scales and codes of ``relu(a + c)`` (layer 1) or of the
        previous layer's bf16 activations (``pair_int8_row_scale``).  With
        dynamic scales, the plan's first chunk's layer 1 comes first: its
        launch makes every chunk's layer-1 scales."""
        fn, name, args = self._quantize[ch, i == 0 or self.static is not None]
        self._counted(name, fn(*args))

    def layer(self, ch: ChunkLaunch, i: int, logits: Optional[torch.Tensor]
              ) -> Optional[torch.Tensor]:
        """The GEMM of hidden layer ``i`` for chunk ``ch``: its input codes
        in, the next layer's codes (static) or bf16 activations (dynamic)
        out, or for the last layer the dot with ``w_out`` into ``logits``.
        Returns the workspace it wrote (None for the last layer)."""
        last = i == len(self.wt) - 1
        if self.static is None:
            x_in, x_out = self.codes[0], None if last else self.h
            mode = (_E_DOT if last else _E_BF16) | _DYNAMIC
            s_in = inv_next = 0.0
        else:
            x_in, x_out = self.codes[i % 2], None if last else self.codes[(i + 1) % 2]
            mode = _E_DOT if last else _E_CODES
            # the layer's scale, and the reciprocal its output codes are
            # quantized with (as XLA runs the division by a constant)
            s_in = self.static[i]
            inv_next = 0.0 if last else self.inv[i + 1]
        if last and self.f32:
            mode |= _W32
        err = self.layer_fn(_ptr(x_in), _ptr(self.wt[i]), _ptr(self.s_w[i]), _ptr(self.bias[i]),
                            self.scale_ptrs[ch][i > 0], _ptr(x_out), _ptr(self.w_out), _ptr(logits),
                            s_in, inv_next, self.B, ch.nl, ch.nl_pad, ch.l0, self.L, self.H,
                            self.H, self.plan.block_n, mode, ch.grid, self.stream)
        self._counted("pair_int8_layer", err)
        return x_out

    def chunk(self, ch: ChunkLaunch, logits: Optional[torch.Tensor],
              stop_after: Optional[int] = None) -> Optional[torch.Tensor]:
        """Every hidden layer of chunk ``ch`` (adding its logits into
        ``logits``); with ``stop_after = i``, stop after layer ``i`` and
        return the (B * nl, H) rows it carries."""
        for i in range(len(self.wt)):
            if self.static is None or i == 0:
                self.quantize(ch, i)
            x_out = self.layer(ch, i, logits)
            if stop_after == i:
                return chunk_rows(x_out, self.B, ch)
        return None

    def run(self) -> torch.Tensor:
        logits = self.new_logits()
        with torch.cuda.device(self.device):  # the C launch goes to the thread's device
            for ch in self.plan.chunks:
                self.chunk(ch, logits)
        return logits


def pair_logits_tiled_int8_cuda(
    q: Int8FoldedOutputMLP,
    P_e: torch.Tensor,
    L_e: torch.Tensor,
    label_tile: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K2's wrapper: (B, L) float32 logits for CUDA tensors.

    Per label chunk of :func:`launch_plan` (``TARGET_ROWS`` pair rows,
    not ``label_tile``: pair rows are independent, so the logits are the
    same): with static scales one ``pair_int8_codes`` launch for layer 1's
    codes, with dynamic ones a ``pair_int8_row_scale`` launch before every
    layer; then one ``pair_int8_layer`` launch per hidden layer, whose
    epilogue writes the next layer's codes (static) or bf16 activations
    (dynamic) to a chunk workspace, or for the last layer reduces against
    ``w_out`` into the logits (pre-filled with ``b_out``).  With no hidden
    layer there is no int8 product: the chain is K1's zero-hidden form
    (``relu(a + c)`` rounded and dotted with ``w_out``), so it runs there."""
    if not q.hidden_q:
        return pair_logits_tiled_cuda(
            FoldedOutputMLP(w1_p=q.w1_p, w1_l=q.w1_l, b1=q.b1, w1_prod=None, hidden=[],
                            w_out=q.w_out, b_out=q.b_out), P_e, L_e, label_tile, compute_dtype)
    del label_tile
    return _Int8Kernel(q, P_e, L_e, compute_dtype).run()


def int8_carry_cuda(q: Int8FoldedOutputMLP, P_e: torch.Tensor, L_e: torch.Tensor,
                    l0: int, nl: int, compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """:func:`int8_carry_reference` through the kernels: layer 1 of the one
    label chunk ``[l0, l0 + nl)`` (padded to whole row tiles), launched alone
    (its launches count)."""
    if len(q.hidden_q) < 2:
        raise ValueError("a carry needs at least two hidden layers")
    if P_e.device.type != "cuda":
        raise ValueError("the int8 CUDA pair scorer needs every tensor on one CUDA device")
    B, H = P_e.shape[0], q.w1_p.shape[1]
    sms = torch.cuda.get_device_properties(P_e.device).multi_processor_count
    plan = single_chunk_plan(B, H, len(q.hidden_q), l0, nl, sms)
    k = _Int8Kernel(q, P_e, L_e, compute_dtype, plan)
    with torch.cuda.device(k.device):
        return k.chunk(plan.chunks[0], None, stop_after=0).clone()


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
