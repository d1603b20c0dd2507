"""ProtNote fusion model, eval half: projection heads + pairwise scorer.

Port of ``protnote_tpu/models/fusion.py``.  Protein and label embeddings are
projected by torchvision-style MLP heads (Linear-no-bias -> BN -> ReLU per
hidden layer, plain Linear last) into a shared latent space, then every
(sequence, label) pair is scored by the folded concat-MLP
(:mod:`protnote_tpu_torch.ops.pair_scorer`) or by cosine similarity, and K
descriptions per label are ensembled (logit of the mean sigmoid).

Training (train-mode BatchNorm, dropout, label noising, the dense and
decomposed training scorers) and the int8 scorer belong to later slices of
the port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from protnote_tpu_torch.models.layers import (
    Params,
    batchnorm_apply,
    gemm_precision,
    init_batchnorm,
    init_linear,
    linear,
)
from protnote_tpu_torch.ops.pair_scorer import (
    BN_EPS,
    fold_output_mlp,
    pair_logits_tiled,
    similarity_logits,
)

_LATER = {
    "train": "training is ported with the training slice (ROADMAP.md queue 1, item 5)",
    "dense": "PAIR_BACKEND=dense is the training scorer, ported with the training slice",
    "tiled_int8": "PAIR_BACKEND=tiled_int8 is ported with the int8 scorer (K2)",
}


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
    # auto (eval: tiled) | tiled; dense and tiled_int8 raise until ported
    pair_backend: str = "auto"

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
        """The eval keys of the JAX ``ProtNoteConfig.from_params``."""
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


def projection_head_apply(p: Params, s: Params, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode projection head: [Linear, BN, ReLU] per hidden layer, plain
    Linear last, in ``x``'s dtype (BN in float32)."""
    h = x
    n = len(p["layers"])
    for i, lin in enumerate(p["layers"]):
        h = linear(lin, h)
        if i < n - 1:
            h = torch.relu(batchnorm_apply(p["bns"][i], s["bns"][i], h, BN_EPS))
    return h


def additive_attention(p: Params, hidden_states: torch.Tensor,
                       attention_mask: torch.Tensor) -> torch.Tensor:
    """Pool (L, T, D) token states with a learned additive-attention head
    (reference ProtNote.additive_attention)."""
    scores = linear(p, hidden_states)[..., 0]
    scores = scores.masked_fill(attention_mask <= 0, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    gemm_precision(hidden_states.dtype)
    return torch.einsum("lt,ltd->ld", w, hidden_states)


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
                                 L_f.to(cfg.compute_dtype))


def protnote_forward(
    params: Params,
    state: Params,
    sequence_embeddings: torch.Tensor,
    label_embeddings: Optional[torch.Tensor],
    cfg: ProtNoteConfig,
    train: bool = False,
    label_attention_mask: Optional[torch.Tensor] = None,
    label_latents: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Score every sequence against every label row: (B, L) logits.

    The eval branch of the JAX ``protnote_forward``: with
    ``cfg.inference_descriptions_per_label`` = K > 1, label rows come in
    consecutive blocks of K per label and are ensembled.  ``label_latents``
    (precomputed W_l projections) skips the label tower."""
    if train:
        raise NotImplementedError(_LATER["train"])
    if cfg.pair_backend in ("dense", "tiled_int8"):
        raise NotImplementedError(_LATER[cfg.pair_backend])
    P_e = projection_head_apply(params["W_p"], state["W_p"],
                                sequence_embeddings.to(cfg.compute_dtype))
    if label_latents is not None:
        L_e = label_latents.to(cfg.compute_dtype)
    else:
        L_e = compute_label_latents(params, state, label_embeddings, cfg,
                                    label_attention_mask)

    if cfg.feature_fusion == "similarity":
        logits = similarity_logits(P_e, L_e, cfg.temperature)
    elif cfg.feature_fusion.startswith("concatenation"):
        folded = fold_output_mlp(params["output_mlp"], state.get("output_mlp"),
                                 cfg.feature_fusion, cfg.latent_dim,
                                 dtype=cfg.compute_dtype)
        logits = pair_logits_tiled(folded, P_e, L_e, label_tile=cfg.label_tile,
                                   compute_dtype=cfg.compute_dtype)
    else:
        raise ValueError(f"feature fusion {cfg.feature_fusion} not implemented")

    k = cfg.inference_descriptions_per_label
    if k > 1:
        logits = ensemble_logits(logits, k)
    return logits
