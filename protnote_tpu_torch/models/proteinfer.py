"""ProteInfer dilated-CNN protein encoder.

Port of ``protnote_tpu/models/proteinfer.py``: a masked conv stem, N ResNet-v2
bottleneck blocks with exponentially dilated masked convs (dilation base^i),
padding re-zeroed around every conv, and masked mean pooling over the true
sequence length into an ``output_channels``-dim embedding, with eval-mode or
train-mode (batch statistics) BatchNorm.

The JAX layouts are kept throughout: channel-last activations ``(B, T, C)``
and conv kernels ``(k, cin, cout)``, the layout K7's kernels
(:mod:`protnote_tpu_torch.ops.masked_conv`) read.  :func:`proteinfer_embed`
keeps its activations in buffers whose rows lie a multiple of 8 channels
apart (1,100 -> 1,104, 550 -> 552, the one-hot's 20 -> 24: ``row_pitch``),
which the conv kernels read through TMA, as strided ``(B, T, C)`` tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from protnote_tpu_torch.models.layers import (
    Params,
    bn_affine,
    init_batchnorm,
    init_linear,
    linear,
    uniform,
)
from protnote_tpu_torch.ops.masked_conv import (
    masked_bn_relu_reference,
    masked_bn_relu_train,
    masked_conv,
    masked_conv_reference,
    masked_mean_pool,
    masked_mean_pool_reference,
    row_pitch,
)

BN_EPS = 1e-3  # reference: BatchNorm1d(eps=0.001, momentum=0.01)
BN_MOMENTUM = 0.01


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
    in the JAX ``(k, cin, cout)`` layout."""
    bound = 1.0 / math.sqrt(cin * k)
    return {"kernel": uniform((k, cin, cout), bound, generator),
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


def one_hot_sequences(aa_ids: torch.Tensor, num_aa: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T) int ids -> (B, T, num_aa); any id outside [0, num_aa) (the pad
    id, = num_aa) gives an all-zero row, as ``jax.nn.one_hot`` does.
    ``F.one_hot`` would raise on such ids, so the rows are compared with
    the class range explicitly.  The rows lie ``row_pitch(num_aa)`` apart
    (a view of a wider one-hot whose extra columns are 0)."""
    hot = aa_ids.long()[..., None] == torch.arange(row_pitch(num_aa), device=aa_ids.device)
    hot[..., num_aa:] = False
    return hot.to(dtype)[..., :num_aa]


def _chain(params: Params, state: Params, x: torch.Tensor, lengths: torch.Tensor,
           cfg: ProteInferConfig, train: bool, example_mask: Optional[torch.Tensor],
           conv: Callable, bn_relu_train: Callable, pool: Callable
           ) -> Tuple[torch.Tensor, Params]:
    """The encoder on the one-hot ``x`` with the given masked conv, train-mode
    BN + ReLU and pool."""
    feats = conv(x, params["conv1"], lengths, 1)
    new_blocks = []
    for i, (bp, bs) in enumerate(zip(params["blocks"], state["blocks"])):
        dilation = cfg.dilation_base ** i
        if train:
            out, bn1 = bn_relu_train(feats, bp["bn1"], bs["bn1"], lengths, example_mask,
                                     BN_EPS, BN_MOMENTUM)
            out = conv(out, bp["conv_dilated"], lengths, dilation)
            out, bn2 = bn_relu_train(out, bp["bn2"], bs["bn2"], lengths, example_mask, BN_EPS,
                                     BN_MOMENTUM)
            feats = conv(out, bp["conv_1x1"], lengths, 1, residual=feats)
            new_blocks.append({"bn1": bn1, "bn2": bn2})
        else:
            out = conv(feats, bp["conv_dilated"], lengths, dilation,
                       bn=bn_affine(bp["bn1"], bs["bn1"], BN_EPS))
            feats = conv(out, bp["conv_1x1"], lengths, 1,
                         bn=bn_affine(bp["bn2"], bs["bn2"], BN_EPS), residual=feats)
    return pool(feats, lengths), ({"blocks": new_blocks} if train else state)


def proteinfer_embed(params: Params, state: Params, aa_onehot: torch.Tensor,
                     lengths: torch.Tensor, cfg: ProteInferConfig, train: bool = False,
                     example_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
    """Masked dilated CNN -> ``((B, output_channels) float32 embedding,
    state)``.  ``aa_onehot`` is (B, T, C_in).

    Eval mode uses the running statistics (the state comes back as given).
    ``train=True`` runs each BatchNorm on batch statistics under the JAX count
    rule (valid positions of the rows ``example_mask`` keeps, divided by
    rows x the longest valid length; :func:`ops.masked_conv.bn_mask_and_count`)
    and returns the new ``{"blocks": [{"bn1", "bn2"}]}`` running statistics.
    CUDA tensors run K7's kernels (the BN + ReLU of eval mode fused into the
    next conv's input), CPU tensors their plain versions; on both every conv
    writes its output at a padded row pitch (:func:`masked_conv`).  The
    lengths go to the one-hot's device as int32 once, so that the convs
    share their read-back and plans."""
    x = aa_onehot.to(cfg.runtime_dtype)
    return _chain(params, state, x, lengths.to(device=x.device, dtype=torch.int32), cfg, train,
                  example_mask, masked_conv, masked_bn_relu_train, masked_mean_pool)


def _conv_reference(x, p, lengths, dilation, bn=None, residual=None):
    return masked_conv_reference(x, p["kernel"], p["bias"], lengths, dilation, bn, residual)


def proteinfer_embed_reference(params: Params, state: Params, aa_onehot: torch.Tensor,
                               lengths: torch.Tensor, cfg: ProteInferConfig, train: bool = False,
                               example_mask: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, Params]:
    """:func:`proteinfer_embed` through K7's plain versions on any device:
    the yardstick the kernels are held to on the card."""
    return _chain(params, state, aa_onehot.to(cfg.runtime_dtype), lengths, cfg, train,
                  example_mask, _conv_reference, masked_bn_relu_reference,
                  masked_mean_pool_reference)


def proteinfer_forward(params: Params, state: Params, aa_onehot: torch.Tensor,
                       lengths: torch.Tensor, cfg: ProteInferConfig, train: bool = False
                       ) -> Tuple[torch.Tensor, Params]:
    """Embedding + classifier head -> ``((B, num_labels) logits, state)``
    (the JAX ``proteinfer_forward``).  The head is a plain float32 product
    (``linear``: TF32 off) on the float32 embedding whatever the encoder's
    compute dtype, as JAX leaves it to XLA."""
    emb, new_state = proteinfer_embed(params, state, aa_onehot, lengths, cfg, train)
    return linear(params["output"], emb), new_state


def proteinfer_forward_reference(params: Params, state: Params, aa_onehot: torch.Tensor,
                                 lengths: torch.Tensor, cfg: ProteInferConfig,
                                 train: bool = False) -> Tuple[torch.Tensor, Params]:
    """:func:`proteinfer_forward` through K7's plain versions on any device."""
    emb, new_state = proteinfer_embed_reference(params, state, aa_onehot, lengths, cfg, train)
    return linear(params["output"], emb), new_state


def embed_from_ids(params: Params, state: Params, aa_ids: torch.Tensor, lengths: torch.Tensor,
                   cfg: ProteInferConfig, train: bool = False,
                   example_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
    """Int residue ids (B, T) -> ``(embedding (B, output_channels), state)``
    (one-hot on the ids' device); ``train``/``example_mask`` as
    :func:`proteinfer_embed`."""
    onehot = one_hot_sequences(aa_ids, cfg.input_channels, dtype=cfg.runtime_dtype)
    return proteinfer_embed(params, state, onehot, lengths, cfg, train, example_mask)
