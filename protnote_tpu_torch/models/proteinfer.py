"""ProteInfer dilated-CNN protein encoder, eval mode.

Port of ``protnote_tpu/models/proteinfer.py``: a masked conv stem, N ResNet-v2
bottleneck blocks with exponentially dilated masked convs (dilation base^i),
padding re-zeroed around every conv, and masked mean pooling over the true
sequence length into an ``output_channels``-dim embedding.

The public functions keep the JAX layouts (one-hot ``(B, T, C)``, mask
``(B, T, 1)``) so the tests compare like with like; the conv stack runs in
torch's ``(B, C, T)`` layout, and conv kernels are stored as torch's
``(cout, cin, k)`` (:func:`protnote_tpu_torch.models.convert.from_jax_tree`
transposes the JAX ``(k, cin, cout)``).  Train-mode BatchNorm belongs to the
training slice of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from protnote_tpu_torch.models.layers import (
    Params,
    batchnorm_apply,
    gemm_precision,
    init_batchnorm,
    init_linear,
    uniform,
)

BN_EPS = 1e-3  # reference: BatchNorm1d(eps=0.001, momentum=0.01)


@dataclass(frozen=True)
class ProteInferConfig:
    input_channels: int = 20
    output_channels: int = 1100
    kernel_size: int = 9
    dilation_base: int = 3
    num_resnet_blocks: int = 5
    bottleneck_factor: float = 0.5
    num_labels: int = 32102
    dtype: torch.dtype = torch.float32
    # activation/compute dtype of the forward pass; None falls back to
    # ``dtype``.  MIXED_PRECISION sets bfloat16 (master weights and BN state
    # stay float32), as the JAX package does.
    compute_dtype: Optional[torch.dtype] = None

    @property
    def bottleneck_channels(self) -> int:
        return int(math.floor(self.output_channels * self.bottleneck_factor))

    @property
    def runtime_dtype(self) -> torch.dtype:
        return self.dtype if self.compute_dtype is None else self.compute_dtype


def _init_conv(generator: torch.Generator, k: int, cin: int, cout: int) -> Params:
    """Torch Conv1d default init (kaiming uniform, fan_in = cin*k), kernel
    in torch's ``(cout, cin, k)`` layout."""
    bound = 1.0 / math.sqrt(cin * k)
    return {"kernel": uniform((cout, cin, k), bound, generator),
            "bias": uniform((cout,), bound, generator)}


def init_proteinfer(generator: torch.Generator, cfg: ProteInferConfig
                    ) -> Tuple[Params, Params]:
    """Random (params, bn_state) on the CPU, from ``generator``."""
    cb = cfg.bottleneck_channels
    params: Params = {"conv1": _init_conv(generator, cfg.kernel_size,
                                          cfg.input_channels, cfg.output_channels)}
    blocks, blocks_state = [], []
    for _ in range(cfg.num_resnet_blocks):
        bn1_p, bn1_s = init_batchnorm(cfg.output_channels)
        bn2_p, bn2_s = init_batchnorm(cb)
        blocks.append({
            "bn1": bn1_p,
            "conv_dilated": _init_conv(generator, cfg.kernel_size,
                                       cfg.output_channels, cb),
            "bn2": bn2_p,
            "conv_1x1": _init_conv(generator, 1, cb, cfg.output_channels),
        })
        blocks_state.append({"bn1": bn1_s, "bn2": bn2_s})
    params["blocks"] = blocks
    params["output"] = init_linear(generator, cfg.output_channels, cfg.num_labels)
    return params, {"blocks": blocks_state}


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, T, 1) float mask of valid positions."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()[..., None]


def one_hot_sequences(aa_ids: torch.Tensor, num_aa: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T) int ids -> (B, T, num_aa); any id outside [0, num_aa) (the pad
    id, = num_aa) gives an all-zero row, as ``jax.nn.one_hot`` does.
    ``F.one_hot`` would raise on such ids, so the rows are compared with
    the class range explicitly."""
    classes = torch.arange(num_aa, device=aa_ids.device)
    return (aa_ids.long()[..., None] == classes).to(dtype)


def _masked_conv(p: Params, x: torch.Tensor, mask: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """'same'-padded dilated conv with padding zeroed before and after
    (reference MaskedConv1D).  ``x`` (B, C, T), ``mask`` (B, 1, T).

    The bias is added after the conv, in the compute dtype, as the JAX code
    does: ``conv1d(bias=...)`` would add it before the bf16 rounding."""
    gemm_precision(x.dtype)
    x = x * mask.to(x.dtype)
    k = p["kernel"].shape[-1]
    y = F.conv1d(x, p["kernel"].to(x.dtype), padding=dilation * (k - 1) // 2,
                 dilation=dilation)
    y = y + p["bias"].to(y.dtype)[None, :, None]
    return y * mask.to(y.dtype)


def proteinfer_embed(params: Params, state: Params, aa_onehot: torch.Tensor,
                     lengths: torch.Tensor, cfg: ProteInferConfig) -> torch.Tensor:
    """Masked dilated CNN -> (B, output_channels) float32 embedding, with
    eval-mode BatchNorm (running statistics).  ``aa_onehot`` is (B, T, C_in)."""
    x = aa_onehot.to(cfg.runtime_dtype).transpose(1, 2)  # (B, C, T)
    mask = length_mask(lengths, x.shape[2]).transpose(1, 2)  # (B, 1, T)
    feats = _masked_conv(params["conv1"], x, mask, dilation=1)
    for i, (bp, bs) in enumerate(zip(params["blocks"], state["blocks"])):
        out = torch.relu(batchnorm_apply(bp["bn1"], bs["bn1"], feats, BN_EPS,
                                         channel_dim=1))
        out = _masked_conv(bp["conv_dilated"], out, mask,
                           dilation=cfg.dilation_base ** i)
        out = torch.relu(batchnorm_apply(bp["bn2"], bs["bn2"], out, BN_EPS,
                                         channel_dim=1))
        out = _masked_conv(bp["conv_1x1"], out, mask, dilation=1)
        feats = feats + out  # residual in the compute dtype
    feats = feats * mask.to(feats.dtype)
    # clamp: a zero-length row would give 0/0 = NaN
    denom = torch.clamp(lengths[:, None].float(), min=1.0)
    return feats.float().sum(dim=2) / denom


def embed_from_ids(params: Params, state: Params, aa_ids: torch.Tensor,
                   lengths: torch.Tensor, cfg: ProteInferConfig) -> torch.Tensor:
    """Int residue ids (B, T) -> (B, output_channels) embedding (one-hot on
    the ids' device)."""
    onehot = one_hot_sequences(aa_ids, cfg.input_channels, dtype=cfg.runtime_dtype)
    return proteinfer_embed(params, state, onehot, lengths, cfg)
