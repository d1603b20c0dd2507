"""Text encoders of the label tower: E5 (XLM-RoBERTa) and BioGPT.

Port of ``protnote_tpu/models/text_transformer.py``, for inference and
training.  Parameters are plain nested dicts with the JAX
tree's names and layouts: ``word_embeddings``, ``position_embeddings`` (+2
rows for gpt), ``token_type_embeddings`` and ``embeddings_ln`` (bert) or
``final_ln`` (gpt), and ``layers[i]`` with ``q``, ``k``, ``v``, ``o``,
``attn_ln``, ``fc1``, ``fc2``, ``ffn_ln``; Linear kernels are ``(in, out)``.

* ``arch="bert"``: post-LayerNorm bidirectional encoder; position ids
  ``cumsum(mask) * mask + pad_token_id`` (fairseq) or ``arange`` (plain
  BERT, ``position_style="absolute"``).
* ``arch="gpt"``: pre-LayerNorm causal decoder, positions
  ``cumsum(mask) * mask - 1 + 2``, ``sqrt(H)`` embedding scale, final LN.

The forward keeps the JAX rounding points: embedding rows are cast to the
compute dtype before they are summed, ``x + a`` is rounded before the
LayerNorm, GELU is the exact (erf) one, and the Linear products go through
:func:`~protnote_tpu_torch.models.layers.linear`.  The attention core runs
in :mod:`protnote_tpu_torch.ops.text_attention` (K8a) and every LayerNorm,
with its residual add where there is one, in
:mod:`protnote_tpu_torch.ops.layer_norm` (K8b): their CUDA kernels on the
card, in bf16 or float32 (``cfg.dtype``; the ops pick the kernel by dtype),
their plain versions on the CPU.  :func:`text_encoder_forward_reference`
runs the plain versions on any device.

Training: when a parameter of the tree or of the LoRA adapters requires a
gradient, K8a and K8b run as ``autograd.Function``s whose backward is K8a-bwd
and K8b-bwd (their plain versions on the CPU).  The training tree stays
float32 (the master weights); the forward casts each weight to the compute
dtype at use, as the JAX forward does (:func:`cast_for_inference` is for
inference only).  :func:`trainable_mask` is the JAX last-n-layer policy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from protnote_tpu_torch.models.layers import Params, linear
from protnote_tpu_torch.ops import layer_norm as k8b
from protnote_tpu_torch.ops import text_attention as k8a

LN_EPS_DEFAULT = 1e-5


@dataclass(frozen=True)
class TextEncoderConfig:
    arch: str = "bert"  # bert | gpt
    vocab_size: int = 250002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    scale_embedding: bool = False  # BioGPT: sqrt(hidden)
    # "fairseq": RoBERTa/XLM-R position ids (pad offset + mask cumsum);
    # "absolute": plain BERT (arange from 0, mask-independent)
    position_style: str = "fairseq"
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def e5_large(cls, **kw) -> "TextEncoderConfig":
        return cls(**kw)  # the defaults above are XLM-R large

    @classmethod
    def biogpt(cls, **kw) -> "TextEncoderConfig":
        return cls(**{**dict(arch="gpt", vocab_size=42384, hidden_size=1024, num_layers=24,
                             num_heads=16, intermediate_size=4096,
                             max_position_embeddings=1024, pad_token_id=1,
                             scale_embedding=True), **kw})


# ----------------------------------------------------------------------
# init: on the generator's device (a CUDA generator builds E5-large's 560M
# parameters on the card in a moment), then moved to ``device``


def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * std


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) * (2.0 * bound) - bound


def _init_linear(g: torch.Generator, d_in: int, d_out: int) -> Params:
    bound = 1.0 / d_in ** 0.5  # torch's Linear default, as the JAX init_linear
    return {"kernel": _uniform(g, (d_in, d_out), bound), "bias": _uniform(g, (d_out,), bound)}


def _init_ln(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def init_text_encoder(generator: torch.Generator, cfg: TextEncoderConfig,
                      device="cpu") -> Params:
    """Random float32 weights in the JAX init's distributions: embeddings
    N(0, 0.02), Linear kernels and biases U(+-1/sqrt(in)), LayerNorms 1/0."""
    H, I, g = cfg.hidden_size, cfg.intermediate_size, generator
    params: Params = {
        "word_embeddings": _normal(g, (cfg.vocab_size, H), 0.02),
        "position_embeddings": _normal(
            g, (cfg.max_position_embeddings + (2 if cfg.arch == "gpt" else 0), H), 0.02),
    }
    if cfg.arch == "bert":
        params["token_type_embeddings"] = _normal(g, (cfg.type_vocab_size, H), 0.02)
        params["embeddings_ln"] = _init_ln(H, g.device)
    else:
        params["final_ln"] = _init_ln(H, g.device)
    params["layers"] = [
        {"q": _init_linear(g, H, H), "k": _init_linear(g, H, H), "v": _init_linear(g, H, H),
         "o": _init_linear(g, H, H), "attn_ln": _init_ln(H, g.device),
         "fc1": _init_linear(g, H, I), "fc2": _init_linear(g, I, H),
         "ffn_ln": _init_ln(H, g.device)}
        for _ in range(cfg.num_layers)]
    return _tree_map(lambda t: t.to(device), params)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def cast_for_inference(params: Params, dtype: torch.dtype) -> Params:
    """The tree with every embedding and Linear weight cast to ``dtype`` and
    the LayerNorm parameters kept in float32.  The forward casts each of
    those weights to the compute dtype at use (as the JAX forward does), so
    casting them once gives the same numbers with less memory traffic."""

    def cast(node: Any, in_ln: bool = False) -> Any:
        if isinstance(node, dict):
            return {k: cast(v, in_ln or k.endswith("_ln")) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v, in_ln) for v in node]
        return node.float() if in_ln else node.to(dtype)

    return cast(params)


# ----------------------------------------------------------------------
# LoRA (loralib semantics: y += x @ A^T @ B^T * alpha / r); A and B train
# through autograd like any parameter of the tree

LORA_TARGETS = ("q", "k", "v", "o", "fc1", "fc2")


def init_lora(generator: torch.Generator, cfg: TextEncoderConfig, rank: int,
              last_n_layers: int, targets: Tuple[str, ...] = LORA_TARGETS,
              device="cpu") -> Params:
    """Adapters for the last ``last_n_layers`` layers: A U(+-1/sqrt(rank)),
    B zero (so a fresh adapter is the identity), keyed by layer index."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    dims = {"q": (H, H), "k": (H, H), "v": (H, H), "o": (H, H), "fc1": (H, I), "fc2": (I, H)}
    lora: Dict[str, Params] = {}
    for li in range(max(cfg.num_layers - last_n_layers, 0), cfg.num_layers):
        entry = {}
        for t in targets:
            d_in, d_out = dims[t]
            entry[t] = {"A": _uniform(generator, (rank, d_in), 1.0 / math.sqrt(rank)).to(device),
                        "B": torch.zeros(d_out, rank, device=device)}
        lora[str(li)] = entry
    return lora


def _lora_delta(lp: Params, x: torch.Tensor, scaling: float) -> torch.Tensor:
    # the JAX scalar is weakly typed: it multiplies in x's dtype
    s = torch.tensor(scaling, dtype=x.dtype, device=x.device)
    return (x @ lp["A"].T.to(x.dtype)) @ lp["B"].T.to(x.dtype) * s


def _project(lp: Params, name: str, x: torch.Tensor, lora_entry: Optional[Params],
             scaling: float) -> torch.Tensor:
    y = linear(lp[name], x)
    if lora_entry is not None and name in lora_entry:  # per-target guard
        y = y + _lora_delta(lora_entry[name], x, scaling)
    return y


# ----------------------------------------------------------------------
# forward

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, bool],
                       torch.Tensor]
NormFn = Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor, float],
                  torch.Tensor]


def _attention(lp: Params, x: torch.Tensor, key_mask: torch.Tensor, cfg: TextEncoderConfig,
               lora_entry: Optional[Params], scaling: float,
               attention: AttentionFn) -> torch.Tensor:
    B, T, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim

    def heads(name: str) -> torch.Tensor:
        y = _project(lp, name, x, lora_entry, scaling)
        return y.reshape(B, T, nh, hd).transpose(1, 2).contiguous()

    ctx = attention(heads("q"), heads("k"), heads("v"), key_mask, cfg.arch == "gpt")
    ctx = ctx.transpose(1, 2).reshape(B, T, H)
    return _project(lp, "o", ctx, lora_entry, scaling)


def _ffn(lp: Params, x: torch.Tensor, lora_entry: Optional[Params],
         scaling: float) -> torch.Tensor:
    h1 = F.gelu(_project(lp, "fc1", x, lora_entry, scaling), approximate="none")
    return _project(lp, "fc2", h1, lora_entry, scaling)


def _ln(p: Params, x: torch.Tensor, residual: Optional[torch.Tensor], eps: float,
        norm: NormFn) -> torch.Tensor:
    return norm(x, residual, p["scale"], p["bias"], eps)


def _forward(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             cfg: TextEncoderConfig, lora: Optional[Params], lora_alpha: float,
             lora_rank: int, attention: AttentionFn, norm: NormFn) -> torch.Tensor:
    mask = attention_mask.to(torch.int32)
    ids = input_ids.long()
    H, eps = cfg.hidden_size, cfg.layer_norm_eps
    scaling = lora_alpha / max(lora_rank, 1)
    x = params["word_embeddings"][ids].to(cfg.dtype)
    if cfg.arch == "bert":
        if cfg.position_style == "fairseq":
            # RoBERTa/XLM-R: padding positions keep pad_token_id
            pos_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        else:
            # plain BERT: absolute positions from 0, mask-independent
            pos_ids = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
        x = x + params["position_embeddings"][pos_ids.long()].to(cfg.dtype)
        x = x + params["token_type_embeddings"][0].to(cfg.dtype)
        x = _ln(params["embeddings_ln"], x, None, eps, norm)
    elif cfg.arch == "gpt":
        if cfg.scale_embedding:
            # the JAX scalar is weakly typed: it multiplies in the compute dtype
            x = x * torch.tensor(math.sqrt(H), dtype=x.dtype, device=x.device)
        pos_ids = torch.cumsum(mask, dim=1) * mask - 1
        x = x + params["position_embeddings"][(pos_ids + 2).long()].to(cfg.dtype)
    else:
        raise ValueError(cfg.arch)
    mask = mask.contiguous()

    for li, lp in enumerate(params["layers"]):
        lora_entry = lora.get(str(li)) if lora else None
        if cfg.arch == "bert":  # post-LN
            a = _attention(lp, x, mask, cfg, lora_entry, scaling, attention)
            x = _ln(lp["attn_ln"], x, a, eps, norm)
            x = _ln(lp["ffn_ln"], x, _ffn(lp, x, lora_entry, scaling), eps, norm)
        else:  # pre-LN
            h = _ln(lp["attn_ln"], x, None, eps, norm)
            x = x + _attention(lp, h, mask, cfg, lora_entry, scaling, attention)
            x = x + _ffn(lp, _ln(lp["ffn_ln"], x, None, eps, norm), lora_entry, scaling)
    if cfg.arch == "gpt":
        x = _ln(params["final_ln"], x, None, eps, norm)
    return x


def text_encoder_forward(params: Params, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor, cfg: TextEncoderConfig,
                         lora: Optional[Params] = None, lora_alpha: float = 8.0,
                         lora_rank: int = 4) -> torch.Tensor:
    """``last_hidden_state`` (B, T, H) in ``cfg.dtype``: K8a and K8b on the
    card, their plain versions on the CPU."""
    return _forward(params, input_ids, attention_mask, cfg, lora, lora_alpha, lora_rank,
                    k8a.masked_attention, k8b.add_layer_norm)


def text_encoder_forward_reference(params: Params, input_ids: torch.Tensor,
                                   attention_mask: torch.Tensor, cfg: TextEncoderConfig,
                                   lora: Optional[Params] = None, lora_alpha: float = 8.0,
                                   lora_rank: int = 4) -> torch.Tensor:
    """:func:`text_encoder_forward` through the plain versions of K8a and
    K8b, on any device (what the card's kernels are held against)."""
    return _forward(params, input_ids, attention_mask, cfg, lora, lora_alpha, lora_rank,
                    k8a.masked_attention_reference, k8b.add_layer_norm_reference)


def pool_hidden_states(last_hidden: torch.Tensor, attention_mask: torch.Tensor,
                       method: str, account_for_sos: bool = True) -> torch.Tensor:
    """The torch twin of ``pool_hidden_states_jnp`` (reference
    models.py:148-179): ``mean`` over the attended tokens (without the SOS
    token when ``account_for_sos``; a row with nothing left pools to zeros),
    ``last_token`` the last attended position, ``all`` the token states."""
    mask = attention_mask.float()
    raw_len = mask.sum(dim=1, keepdim=True)
    if method == "mean":
        adj = mask.clone()
        if account_for_sos:
            adj[:, 0] = 0.0
        summed = (last_hidden.float() * adj[..., None]).sum(dim=1)
        denom = raw_len - (1.0 if account_for_sos else 0.0)
        return summed / torch.clamp(denom, min=1.0)
    if method == "last_token":
        idx = torch.clamp(raw_len[:, 0] - 1, min=0).long()
        return last_hidden[torch.arange(last_hidden.shape[0], device=idx.device), idx].float()
    if method == "all":
        return last_hidden
    raise ValueError(method)


# ----------------------------------------------------------------------
# trainable partition (the JAX trainable_mask, reference
# biogpt_train_last_n_layers, models.py:32-50)


def trainable_mask(params: Params, cfg: TextEncoderConfig, last_n_layers: int) -> Params:
    """A bool tree like ``params``: True on every leaf of the last
    ``last_n_layers`` layers, False on the embeddings, their LayerNorm, the
    final LN and the earlier layers."""
    start = max(cfg.num_layers - last_n_layers, 0)

    def layer(li: int, lp: Params) -> Params:
        on = li >= start
        return _tree_map(lambda _: on, lp)

    out = _tree_map(lambda _: False, {k: v for k, v in params.items() if k != "layers"})
    out["layers"] = [layer(li, lp) for li, lp in enumerate(params["layers"])]
    return out


# ----------------------------------------------------------------------
# HF torch state dicts and configs (duck-typed: no transformers import)


def _t(v: Any) -> torch.Tensor:
    """A CPU float32 copy that owns its memory."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v), dtype=torch.float32)


def _lin(d: Dict[str, Any], prefix: str) -> Params:
    return {"kernel": _t(d[prefix + ".weight"]).T.contiguous(), "bias": _t(d[prefix + ".bias"])}


def _ln_params(d: Dict[str, Any], prefix: str) -> Params:
    return {"scale": _t(d[prefix + ".weight"]), "bias": _t(d[prefix + ".bias"])}


def from_hf_state_dict(sd: Dict[str, Any], cfg: TextEncoderConfig) -> Params:
    """An HF state dict (XLMRobertaModel / BertModel / BioGptModel layouts,
    with or without the ``roberta.``/``biogpt.``/``model.`` prefix) ->
    the parameter tree, float32 on the CPU, Linear weights transposed to
    ``(in, out)``."""

    def strip(prefixes: List[str]) -> Dict[str, Any]:
        for p in prefixes:
            if any(k.startswith(p) for k in sd):
                return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
        return dict(sd)

    if cfg.arch == "bert":
        d = strip(["roberta.", "model."])
        params: Params = {
            "word_embeddings": _t(d["embeddings.word_embeddings.weight"]),
            "position_embeddings": _t(d["embeddings.position_embeddings.weight"]),
            "token_type_embeddings": _t(d["embeddings.token_type_embeddings.weight"]),
            "embeddings_ln": _ln_params(d, "embeddings.LayerNorm"),
        }
        params["layers"] = [{
            "q": _lin(d, f"encoder.layer.{i}.attention.self.query"),
            "k": _lin(d, f"encoder.layer.{i}.attention.self.key"),
            "v": _lin(d, f"encoder.layer.{i}.attention.self.value"),
            "o": _lin(d, f"encoder.layer.{i}.attention.output.dense"),
            "attn_ln": _ln_params(d, f"encoder.layer.{i}.attention.output.LayerNorm"),
            "fc1": _lin(d, f"encoder.layer.{i}.intermediate.dense"),
            "fc2": _lin(d, f"encoder.layer.{i}.output.dense"),
            "ffn_ln": _ln_params(d, f"encoder.layer.{i}.output.LayerNorm"),
        } for i in range(cfg.num_layers)]
        return params

    d = strip(["biogpt.", "model."])
    params = {
        "word_embeddings": _t(d["embed_tokens.weight"]),
        "position_embeddings": _t(d["embed_positions.weight"]),
        "final_ln": _ln_params(d, "layer_norm"),
    }
    params["layers"] = [{
        "q": _lin(d, f"layers.{i}.self_attn.q_proj"),
        "k": _lin(d, f"layers.{i}.self_attn.k_proj"),
        "v": _lin(d, f"layers.{i}.self_attn.v_proj"),
        "o": _lin(d, f"layers.{i}.self_attn.out_proj"),
        "attn_ln": _ln_params(d, f"layers.{i}.self_attn_layer_norm"),
        "fc1": _lin(d, f"layers.{i}.fc1"),
        "fc2": _lin(d, f"layers.{i}.fc2"),
        "ffn_ln": _ln_params(d, f"layers.{i}.final_layer_norm"),
    } for i in range(cfg.num_layers)]
    return params


def config_from_hf(hf_config, dtype: torch.dtype = torch.float32) -> TextEncoderConfig:
    """A TextEncoderConfig from a transformers config object."""
    mt = getattr(hf_config, "model_type", "")
    if mt in ("xlm-roberta", "roberta", "bert"):
        return TextEncoderConfig(
            arch="bert",
            # plain BERT uses absolute arange positions; the RoBERTa family
            # fairseq pad-offset ids
            position_style="absolute" if mt == "bert" else "fairseq",
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position_embeddings=hf_config.max_position_embeddings,
            type_vocab_size=getattr(hf_config, "type_vocab_size", 1),
            pad_token_id=hf_config.pad_token_id or 0,
            layer_norm_eps=getattr(hf_config, "layer_norm_eps", 1e-5),
            dtype=dtype,
        )
    if mt == "biogpt":
        return TextEncoderConfig(
            arch="gpt",
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position_embeddings=hf_config.max_position_embeddings,
            pad_token_id=hf_config.pad_token_id or 1,
            layer_norm_eps=getattr(hf_config, "layer_norm_eps", 1e-5),
            scale_embedding=getattr(hf_config, "scale_embedding", True),
            dtype=dtype,
        )
    raise ValueError(f"unsupported HF model_type {mt}")
