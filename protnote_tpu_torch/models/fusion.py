"""ProtNote fusion model: projection heads + pairwise scorer.

Port of ``protnote_tpu/models/fusion.py``.  Protein and label embeddings are
projected by torchvision-style MLP heads (Linear-no-bias -> BN -> ReLU
[-> dropout] per hidden layer, plain Linear last) into a shared latent
space, then every (sequence, label) pair is scored: in evaluation by the
folded concat-MLP (:mod:`protnote_tpu_torch.ops.pair_scorer`, K1) or by
cosine similarity, with K descriptions per label ensembled (logit of the
mean sigmoid); in training by the decomposed scorer
(:mod:`protnote_tpu_torch.ops.streaming_train`, K4 + K5) with train-mode
BatchNorm, after label-embedding noising.

Random draws (noising, dropout) come from an explicit ``torch.Generator``
on the tensors' device.  Left out, each raising ``NotImplementedError``
that names its ROADMAP item: the materialised dense scorer
(``PAIR_BACKEND=dense``, ``OUTPUT_MLP_DROPOUT > 0`` in training, training
without output-MLP BatchNorm or with ``concatenation_prod``), the streamed
scorer (``TRAIN_STREAMING_LABEL_TILE > 0``) and ``GRADIENT_CHECKPOINTING``.
``PAIR_BACKEND=tiled_int8`` evaluates through the int8 scorer (K2) with the
config's static activation scales (:func:`calibrate_int8`) or dynamic
per-row ones, and trains through the decomposed scorer as ``auto`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from protnote_tpu_torch.models.layers import (
    Params,
    batchnorm_apply,
    batchnorm_train,
    dropout as dropout_fn,
    gemm_precision,
    init_batchnorm,
    init_linear,
    linear,
)
from protnote_tpu_torch.ops.pair_scorer import (
    BN_EPS,
    act_scale_maxes,
    fold_output_mlp,
    pair_logits_tiled,
    pair_logits_tiled_int8,
    quantize_folded,
    similarity_logits,
)
from protnote_tpu_torch.ops.streaming_train import (
    BN_MOMENTUM,
    STREAMING_LATER,
    pair_logits_dense_decomposed,
)

DENSE_LATER = ("the materialised dense pair scorer (PAIR_BACKEND=dense or tiled in "
               "training, training without output-MLP BatchNorm or with "
               "concatenation_prod) is not ported: the training slice trains through the "
               "decomposed scorer (ROADMAP.md queue 1, item 5f)")
DROPOUT_LATER = ("OUTPUT_MLP_DROPOUT > 0 in training needs the materialised dense "
                 "scorer, which the training slice does not port (ROADMAP.md queue 1, "
                 "item 5f)")


@dataclass(frozen=True)
class ProtNoteConfig:
    protein_embedding_dim: int = 1100
    label_embedding_dim: int = 1024
    latent_dim: int = 1024
    projection_head_num_layers: int = 4
    projection_head_hidden_dim_scale_factor: int = 3
    output_mlp_num_layers: int = 3
    output_mlp_hidden_dim_scale_factor: float = 3
    output_mlp_batchnorm: bool = True
    output_neuron_bias: Optional[float] = None
    feature_fusion: str = "concatenation"
    temperature: float = 0.07
    label_embedding_pooling_method: str = "mean"
    inference_descriptions_per_label: int = 1
    label_tile: int = 512
    compute_dtype: torch.dtype = torch.float32
    # static activation scales of the int8 scorer, one per hidden layer
    # (INT8_ACT_SCALES, calibrate_int8); None: dynamic per-row scales
    int8_act_scales: Optional[Tuple[float, ...]] = None
    # auto (eval: tiled, train: decomposed) | tiled | tiled_int8 (eval: K2,
    # train: decomposed); dense raises until ported
    pair_backend: str = "auto"
    # training (the JAX fields of the same names)
    label_embedding_noising_alpha: float = 0.0
    dropout: float = 0.0  # OUTPUT_MLP_DROPOUT: heads' hidden layers and the output MLP
    sequence_embedding_dropout: float = 0.0
    label_embedding_dropout: float = 0.0
    gradient_checkpointing: bool = False  # the decomposed scorer's remat: raises
    train_label_tile: int = 0  # > 0 (the streamed scorer K6) raises in training

    @property
    def output_mlp_hidden_dim(self) -> int:
        return int(round(self.output_mlp_hidden_dim_scale_factor * self.latent_dim))

    @property
    def joint_dim(self) -> int:
        return {
            "concatenation": 2 * self.latent_dim,
            "concatenation_diff": 3 * self.latent_dim,
            "concatenation_prod": 3 * self.latent_dim,
        }[self.feature_fusion]

    @classmethod
    def from_params(cls, params: Dict, **overrides) -> "ProtNoteConfig":
        """The keys of the JAX ``ProtNoteConfig.from_params`` that the port
        reads."""
        bias_prob = params.get("OUTPUT_NEURON_PROBABILITY_BIAS")
        kw = dict(
            protein_embedding_dim=params.get("PROTEIN_EMBEDDING_DIM", 1100),
            label_embedding_dim=params.get("LABEL_EMBEDDING_DIM", 1024),
            latent_dim=params.get("LATENT_EMBEDDING_DIM", 1024),
            projection_head_num_layers=params.get("PROJECTION_HEAD_NUM_LAYERS", 4),
            projection_head_hidden_dim_scale_factor=params.get(
                "PROJECTION_HEAD_HIDDEN_DIM_SCALE_FACTOR", 3
            ),
            output_mlp_num_layers=params.get("OUTPUT_MLP_NUM_LAYERS", 3),
            output_mlp_hidden_dim_scale_factor=params.get(
                "OUTPUT_MLP_HIDDEN_DIM_SCALE_FACTOR", 3
            ),
            output_mlp_batchnorm=params.get("OUTPUT_MLP_BATCHNORM", True),
            output_neuron_bias=(
                sigmoid_bias_from_prob(bias_prob) if bias_prob is not None else None
            ),
            feature_fusion=params.get("FEATURE_FUSION", "concatenation"),
            temperature=params.get("SUPCON_TEMP", 0.07),
            label_embedding_pooling_method=params.get(
                "LABEL_EMBEDDING_POOLING_METHOD", "mean"
            ),
            pair_backend=params.get("PAIR_BACKEND", None) or "auto",
            label_embedding_noising_alpha=params.get("LABEL_EMBEDDING_NOISING_ALPHA", 0.0),
            dropout=params.get("OUTPUT_MLP_DROPOUT", 0.0),
            sequence_embedding_dropout=params.get("SEQUENCE_EMBEDDING_DROPOUT", 0.0),
            label_embedding_dropout=params.get("LABEL_EMBEDDING_DROPOUT", 0.0),
            gradient_checkpointing=params.get("GRADIENT_CHECKPOINTING", False),
            train_label_tile=params.get("TRAIN_STREAMING_LABEL_TILE", 0) or 0,
            int8_act_scales=(
                tuple(float(s) for s in params["INT8_ACT_SCALES"])
                if params.get("INT8_ACT_SCALES") else None
            ),
        )
        kw.update(overrides)
        allowed = ("auto", "dense", "tiled", "tiled_int8")
        if kw["pair_backend"] not in allowed:
            raise ValueError(f"PAIR_BACKEND={kw['pair_backend']!r} not in {allowed}")
        return cls(**kw)


def sigmoid_bias_from_prob(prior_prob: float) -> float:
    return -math.log((1 - prior_prob) / prior_prob)


# ----------------------------------------------------------------------
# init (random weights from an explicit generator, on the CPU)


def _init_projection_head(generator: torch.Generator, in_dim: int,
                          cfg: ProtNoteConfig) -> Tuple[Params, Params]:
    n = cfg.projection_head_num_layers
    hidden = [cfg.latent_dim * cfg.projection_head_hidden_dim_scale_factor] * (n - 1)
    layers, bns_p, bns_s = [], [], []
    d = in_dim
    for i, h in enumerate(hidden + [cfg.latent_dim]):
        layers.append(init_linear(generator, d, h, use_bias=False))
        if i < n - 1:
            bp, bs = init_batchnorm(h)
            bns_p.append(bp)
            bns_s.append(bs)
        d = h
    return {"layers": layers, "bns": bns_p}, {"bns": bns_s}


def _init_output_mlp(generator: torch.Generator, cfg: ProtNoteConfig
                     ) -> Tuple[Params, Optional[Params]]:
    H = cfg.output_mlp_hidden_dim
    use_bias = not cfg.output_mlp_batchnorm
    layers, bns_p, bns_s = [], [], []
    d = cfg.joint_dim
    for _ in range(cfg.output_mlp_num_layers):
        layers.append(init_linear(generator, d, H, use_bias=use_bias))
        if cfg.output_mlp_batchnorm:
            bp, bs = init_batchnorm(H)
            bns_p.append(bp)
            bns_s.append(bs)
        d = H
    out = init_linear(generator, H, 1, use_bias=True)
    if cfg.output_neuron_bias is not None:
        out["bias"] = torch.full((1,), cfg.output_neuron_bias)
    params: Params = {"layers": layers, "out": out}
    if not cfg.output_mlp_batchnorm:
        return params, None
    params["bns"] = bns_p
    return params, {"bns": bns_s}


def init_protnote(generator: torch.Generator, cfg: ProtNoteConfig
                  ) -> Tuple[Params, Params]:
    """Random (params, state) on the CPU; state holds every BatchNorm's
    running statistics."""
    wp_p, wp_s = _init_projection_head(generator, cfg.protein_embedding_dim, cfg)
    wl_p, wl_s = _init_projection_head(generator, cfg.label_embedding_dim, cfg)
    params: Params = {"W_p": wp_p, "W_l": wl_p}
    state: Params = {"W_p": wp_s, "W_l": wl_s}
    if cfg.feature_fusion.startswith("concatenation"):
        om_p, om_s = _init_output_mlp(generator, cfg)
        params["output_mlp"] = om_p
        if om_s is not None:
            state["output_mlp"] = om_s
    if cfg.label_embedding_pooling_method == "all":
        params["attn"] = init_linear(generator, cfg.label_embedding_dim, 1)
    return params, state


# ----------------------------------------------------------------------
# forward pieces


def projection_head_apply(p: Params, s: Params, x: torch.Tensor,
                          cfg: Optional[ProtNoteConfig] = None, train: bool = False,
                          input_dropout: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          rows_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
    """[Linear, BN, ReLU (, dropout)] per hidden layer, plain Linear last,
    in ``x``'s dtype (BN in float32): ``(h, {"bns": new BN states})``.

    ``train``: BatchNorm on the batch statistics of the rows where
    ``rows_mask`` (N, 1) is set, input dropout at ``input_dropout`` and
    hidden dropout at ``cfg.dropout`` with bits from ``generator`` (none
    without one, as the JAX function draws none without an rng)."""
    rate = cfg.dropout if cfg is not None else 0.0
    draw = train and generator is not None
    if draw and input_dropout > 0:
        x = dropout_fn(x, input_dropout, generator, train)
    h = x
    n = len(p["layers"])
    new_bns: List[Params] = []
    for i, lin in enumerate(p["layers"]):
        h = linear(lin, h)
        if i < n - 1:
            if train:
                h, bs = batchnorm_train(p["bns"][i], s["bns"][i], h, eps=BN_EPS,
                                        momentum=BN_MOMENTUM, mask=rows_mask)
            else:
                h, bs = batchnorm_apply(p["bns"][i], s["bns"][i], h, BN_EPS), s["bns"][i]
            new_bns.append(bs)
            h = torch.relu(h)
            if draw and rate > 0:
                h = dropout_fn(h, rate, generator, train)
    if draw and rate > 0:  # the torchvision MLP's trailing dropout
        h = dropout_fn(h, rate, generator, train)
    return h, {"bns": new_bns}


def additive_attention(p: Params, hidden_states: torch.Tensor,
                       attention_mask: torch.Tensor) -> torch.Tensor:
    """Pool (L, T, D) token states with a learned additive-attention head
    (reference ProtNote.additive_attention)."""
    scores = linear(p, hidden_states)[..., 0]
    scores = scores.masked_fill(attention_mask <= 0, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    gemm_precision(hidden_states.dtype)
    return torch.einsum("lt,ltd->ld", w, hidden_states)


def noise_label_embeddings(L_f: torch.Tensor, alpha: float,
                           generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniform(-1, 1) noise scaled by alpha / sqrt(d) (reference
    ProtNote.py:219-240, NEFTune-style), drawn from ``generator``."""
    scale = alpha / math.sqrt(L_f.shape[-1])
    noise = torch.rand(L_f.shape, generator=generator, device=L_f.device,
                       dtype=L_f.dtype) * 2.0 - 1.0
    return L_f + noise * scale


def ensemble_logits(logits: torch.Tensor, k: int, eps: float = 1e-7) -> torch.Tensor:
    """(B, L*k) -> (B, L): logit of the mean sigmoid over each label's k
    description variants (reference ProtNote.py:308-322)."""
    B, Lk = logits.shape
    probs = torch.sigmoid(logits).reshape(B, Lk // k, k).mean(dim=-1)
    probs = probs.clamp(eps, 1.0 - eps)
    return torch.log(probs) - torch.log1p(-probs)


def compute_label_latents(params: Params, state: Params,
                          label_embeddings: torch.Tensor, cfg: ProtNoteConfig,
                          label_attention_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Eval-mode W_l projection of label-description rows -> latents for
    ``protnote_forward(label_latents=...)``; computed once per evaluation
    when the label layout is batch-invariant."""
    L_f = label_embeddings
    if cfg.label_embedding_pooling_method == "all":
        if label_attention_mask is None:
            raise ValueError("pooling 'all' requires label_attention_mask")
        L_f = additive_attention(params["attn"], L_f, label_attention_mask)
    return projection_head_apply(params["W_l"], state["W_l"],
                                 L_f.to(cfg.compute_dtype), cfg)[0]


def calibrate_int8_maxes(params: Params, state: Params, sequence_embeddings: torch.Tensor,
                         cfg: ProtNoteConfig, label_embeddings: Optional[torch.Tensor] = None,
                         label_latents: Optional[torch.Tensor] = None,
                         label_attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per hidden layer, the max |GEMM input| over one batch (the sequences
    through W_p, the labels through W_l unless ``label_latents`` are
    given): a (num_hidden,) float32 tensor on the device."""
    P_e, _ = projection_head_apply(params["W_p"], state["W_p"],
                                   sequence_embeddings.to(cfg.compute_dtype), cfg)
    if label_latents is None:
        if label_embeddings is None:
            raise ValueError("need label_embeddings or label_latents")
        label_latents = compute_label_latents(params, state, label_embeddings, cfg,
                                              label_attention_mask)
    folded = fold_output_mlp(params["output_mlp"], state.get("output_mlp"), cfg.feature_fusion,
                             cfg.latent_dim, dtype=cfg.compute_dtype)
    return act_scale_maxes(folded, P_e, label_latents.to(cfg.compute_dtype),
                           label_tile=cfg.label_tile)


def calibrate_int8(params: Params, state: Params, sequence_embeddings: torch.Tensor,
                   cfg: ProtNoteConfig, label_embeddings: Optional[torch.Tensor] = None,
                   label_latents: Optional[torch.Tensor] = None,
                   label_attention_mask: Optional[torch.Tensor] = None,
                   margin: float = 1.05) -> Tuple[float, ...]:
    """Static activation scales for ``pair_backend='tiled_int8'`` from one
    batch: ``max * margin / 127`` per hidden layer, for
    ``ProtNoteConfig(int8_act_scales=...)`` (config key INT8_ACT_SCALES)."""
    maxes = calibrate_int8_maxes(params, state, sequence_embeddings, cfg,
                                 label_embeddings=label_embeddings, label_latents=label_latents,
                                 label_attention_mask=label_attention_mask)
    return tuple(float(m) * margin / 127.0 for m in maxes.cpu().tolist())


def protnote_forward(
    params: Params,
    state: Params,
    sequence_embeddings: torch.Tensor,
    label_embeddings: Optional[torch.Tensor],
    cfg: ProtNoteConfig,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    label_attention_mask: Optional[torch.Tensor] = None,
    example_mask: Optional[torch.Tensor] = None,
    label_mask: Optional[torch.Tensor] = None,
    label_latents: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """Score every sequence against every label row: ``((B, L) logits,
    new_state)``, as the JAX ``protnote_forward``.

    Eval: with ``cfg.inference_descriptions_per_label`` = K > 1 label rows
    come in consecutive blocks of K per label and are ensembled;
    ``label_latents`` (precomputed W_l projections) skips the label tower;
    the state comes back unchanged.  Train: BatchNorm on the masked batch
    (``example_mask`` (B,), ``label_mask`` (L,)), label noising and dropout
    from ``generator``, the decomposed scorer (K4 + K5), and the new running
    statistics in the returned state."""
    if cfg.pair_backend == "dense":
        raise NotImplementedError(DENSE_LATER)
    new_state = dict(state)
    P_e, new_state["W_p"] = projection_head_apply(
        params["W_p"], state["W_p"], sequence_embeddings.to(cfg.compute_dtype), cfg, train,
        input_dropout=cfg.sequence_embedding_dropout, generator=generator,
        rows_mask=None if example_mask is None else example_mask[:, None])
    if label_latents is not None:
        if train:
            raise ValueError("label_latents is an eval-only fast path")
        L_e = label_latents.to(cfg.compute_dtype)
    else:
        L_f = label_embeddings
        if cfg.label_embedding_pooling_method == "all":
            if label_attention_mask is None:
                raise ValueError("pooling 'all' requires label_attention_mask")
            L_f = additive_attention(params["attn"], L_f, label_attention_mask)
        if train and cfg.label_embedding_noising_alpha > 0 and generator is not None:
            L_f = noise_label_embeddings(L_f, cfg.label_embedding_noising_alpha, generator)
        L_e, new_state["W_l"] = projection_head_apply(
            params["W_l"], state["W_l"], L_f.to(cfg.compute_dtype), cfg, train,
            input_dropout=cfg.label_embedding_dropout, generator=generator,
            rows_mask=None if label_mask is None else label_mask[:, None])

    if cfg.feature_fusion == "similarity":
        logits = similarity_logits(P_e, L_e, cfg.temperature)
    elif cfg.feature_fusion.startswith("concatenation"):
        om_state = state.get("output_mlp")
        if train:
            if cfg.train_label_tile > 0:
                raise NotImplementedError(STREAMING_LATER)
            if cfg.dropout > 0:
                raise NotImplementedError(DROPOUT_LATER)
            if (cfg.pair_backend == "tiled" or om_state is None
                    or cfg.feature_fusion == "concatenation_prod"):
                raise NotImplementedError(DENSE_LATER)
            logits, new_state["output_mlp"] = pair_logits_dense_decomposed(
                params["output_mlp"], om_state, P_e, L_e, cfg.feature_fusion,
                example_mask=example_mask, label_mask=label_mask,
                compute_dtype=cfg.compute_dtype, remat=cfg.gradient_checkpointing)
        else:
            folded = fold_output_mlp(params["output_mlp"], om_state, cfg.feature_fusion,
                                     cfg.latent_dim, dtype=cfg.compute_dtype)
            if cfg.pair_backend == "tiled_int8":
                # the weights are quantized on every call, as in JAX
                logits = pair_logits_tiled_int8(
                    quantize_folded(folded, act_scales=cfg.int8_act_scales), P_e, L_e,
                    label_tile=cfg.label_tile, compute_dtype=cfg.compute_dtype)
            else:
                logits = pair_logits_tiled(folded, P_e, L_e, label_tile=cfg.label_tile,
                                           compute_dtype=cfg.compute_dtype)
    else:
        raise ValueError(f"feature fusion {cfg.feature_fusion} not implemented")

    k = cfg.inference_descriptions_per_label
    if not train and k > 1:
        logits = ensemble_logits(logits, k)
    return logits, new_state
