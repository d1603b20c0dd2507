"""Train and eval steps: ProteInfer embedding -> ProtNote scoring -> loss.

Port of ``protnote_tpu/train/step.py``.  PyTorch runs eagerly, so each step
is a plain function; the train step updates the parameters in place and
returns the new train state (model state, optimizer state, step) with its
metrics.  :func:`batch_to_device_dict` moves a host batch of the data
pipeline to the device.

The train step runs the ProteInfer encoder (K7), gathers the label matrix
rows, runs ``protnote_forward(train=True)`` (heads, the decomposed scorer
K4 + K5, or the streamed or dense one as the config dispatches; the step's
``generator`` draws the label noise, the heads' dropout and the dense
scorer's dropout seed), the loss, autograd and the optimizer, and reports ``loss``,
per-label ``tp``/``fp``/``fn`` at ``probs > threshold`` (strict, as the JAX
train step; the eval accumulator uses ``>=``), the gradients' global norm
and the example count.  The encoder is frozen under ``torch.no_grad`` in
eval-mode BatchNorm by default; ``encoder_bn_train_mode``
(``ENCODER_BN_TRAIN_MODE``) keeps it frozen but runs its BatchNorm on batch
statistics, as the reference's ``model.train()`` does, and
``train_sequence_encoder`` (``TRAIN_SEQUENCE_ENCODER``) trains
``trainable["encoder"]`` through K7's backward kernels; with either, the
new running statistics come back in ``enc_state``.  With ``text_cfg`` and
tokenized labels in the batch
(``label_input_ids``, ``label_attention_mask``), both steps embed the label
text through the tower on the fly (JAX ``step.py:128-146, 240-255``): the
train step backpropagates into ``trainable["text"]`` (the last-n-layer
unfreezing, with the optimizer's trainable mask) and ``trainable["lora"]``
(the adapters) through K8a-bwd and K8b-bwd, and detaches the pooled
embeddings when nothing of the tower trains.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

import torch

from protnote_tpu_torch.models.fusion import ProtNoteConfig, protnote_forward
from protnote_tpu_torch.models.proteinfer import ProteInferConfig, embed_from_ids
from protnote_tpu_torch.models.text_transformer import pool_hidden_states, text_encoder_forward
from protnote_tpu_torch.train.optim import Optimizer, global_norm, tree_leaves

def init_train_state(pn_params, pn_state, enc_params, enc_state, optimizer: Optimizer,
                     train_sequence_encoder: bool = False, text_params=None,
                     train_label_encoder: bool = False, lora_params=None) -> Dict[str, Any]:
    """The JAX ``init_train_state`` layout: ``trainable`` (the ProtNote
    parameters; the encoder with ``train_sequence_encoder``; the label
    tower's ``text`` with ``train_label_encoder``, its ``lora`` adapters when
    given), ``model_state``, the frozen encoder (None when it trains),
    ``enc_state``, ``text_params`` (the frozen tower, or None), ``opt_state``
    and ``step``."""
    trainable = {"protnote": pn_params}
    if train_sequence_encoder:
        trainable["encoder"] = enc_params
    if text_params is not None and train_label_encoder:
        trainable["text"] = text_params
    if lora_params is not None:
        trainable["lora"] = lora_params
    return {"trainable": trainable, "model_state": pn_state,
            "enc_params": None if train_sequence_encoder else enc_params, "enc_state": enc_state,
            "text_params": None if (text_params is None or train_label_encoder) else text_params,
            "opt_state": optimizer.init(trainable), "step": 0}


def _resolve_label_embeddings(batch: Dict[str, Any]) -> torch.Tensor:
    """The step's label embeddings: shipped with the batch, or gathered on
    the device from the resident view matrix by ``label_rows``."""
    if "label_rows" in batch and "label_matrix" in batch:
        return batch["label_matrix"].index_select(0, batch["label_rows"].long())
    return batch["label_embeddings"]


def _pair_mask(example_mask: torch.Tensor, num_labels: int,
               label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    m = example_mask[:, None].expand(example_mask.shape[0], num_labels)
    if label_mask is not None:
        m = m * label_mask[None, :].to(m.dtype)
    return m


def _encoder_embeddings(ts: Dict[str, Any], batch: Dict[str, torch.Tensor],
                        pi_cfg: ProteInferConfig, train: bool):
    """``(P_f, enc_state)`` of the batch: the encoder of ``trainable`` (or
    the frozen one), with train-mode BatchNorm when ``train``."""
    return embed_from_ids(ts["trainable"].get("encoder", ts["enc_params"]), ts["enc_state"],
                          batch["aa_ids"], batch["lengths"], pi_cfg, train=train,
                          example_mask=batch["example_mask"])


def _tower_embeddings(ts: Dict[str, Any], batch: Dict[str, torch.Tensor], text_cfg,
                      pooling_method: str, lora_alpha: float, lora_rank: int) -> torch.Tensor:
    """The batch's label embeddings from its tokenized label text: the
    trainable tower (or the frozen ``text_params``) with the adapters of
    ``trainable["lora"]``, pooled by ``pooling_method``."""
    text_params = ts["trainable"].get("text", ts.get("text_params"))
    hidden = text_encoder_forward(text_params, batch["label_input_ids"],
                                  batch["label_attention_mask"], text_cfg,
                                  lora=ts["trainable"].get("lora"), lora_alpha=lora_alpha,
                                  lora_rank=lora_rank)
    return pool_hidden_states(hidden, batch["label_attention_mask"], pooling_method)


def make_train_step(pi_cfg: ProteInferConfig, pn_cfg: ProtNoteConfig, loss_fn: Callable,
                    optimizer: Optimizer, decision_threshold: float = 0.5, text_cfg=None,
                    pooling_method: str = "mean", lora_alpha: float = 8.0,
                    lora_rank: int = 4, train_sequence_encoder: bool = False,
                    encoder_bn_train_mode: bool = False):
    """Returns ``(train_state, batch, generator) -> (train_state, metrics)``.

    ``batch`` has ``aa_ids`` (B, T), ``lengths`` (B,), ``example_mask`` (B,),
    ``label_multihots`` (B, L), the label rows (``label_embeddings`` (L, D),
    or ``label_rows`` with the resident ``label_matrix``) and optionally
    ``label_mask`` (L,), all on one device; ``generator`` (on that device)
    draws the label noise and dropout.  With ``text_cfg`` and
    ``label_input_ids``/``label_attention_mask`` (L, Tk) in the batch, the
    label embeddings come from the text tower instead, and gradients reach
    ``trainable["text"]`` and ``trainable["lora"]``.  With
    ``train_sequence_encoder`` or ``encoder_bn_train_mode`` the encoder's
    BatchNorm runs on batch statistics (the JAX count rule over the rows
    ``example_mask`` keeps) and the new ``enc_state`` is returned; only
    ``train_sequence_encoder`` lets gradients reach ``trainable["encoder"]``
    (with ``encoder_bn_train_mode`` alone the encoder runs under
    ``no_grad``, as JAX's ``stop_gradient``)."""
    enc_train = train_sequence_encoder or encoder_bn_train_mode

    def step(ts: Dict[str, Any], batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]):
        labels = batch["label_multihots"]
        mask = _pair_mask(batch["example_mask"], labels.shape[1], batch.get("label_mask"))
        if not train_sequence_encoder:
            with torch.no_grad():
                P_f, enc_state = _encoder_embeddings(ts, batch, pi_cfg, enc_train)
        trainable = ts["trainable"]
        tower = text_cfg is not None and "label_input_ids" in batch
        leaves = tree_leaves(trainable)
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                if train_sequence_encoder:
                    P_f, enc_state = _encoder_embeddings(ts, batch, pi_cfg, True)
                if tower:
                    label_embeddings = _tower_embeddings(ts, batch, text_cfg, pooling_method,
                                                         lora_alpha, lora_rank)
                    if "text" not in trainable and "lora" not in trainable:
                        label_embeddings = label_embeddings.detach()
                else:
                    label_embeddings = _resolve_label_embeddings(batch)
                logits, model_state = protnote_forward(
                    trainable["protnote"], ts["model_state"], P_f, label_embeddings, pn_cfg,
                    train=True, generator=generator, example_mask=batch["example_mask"],
                    label_mask=batch.get("label_mask"),
                    label_attention_mask=batch.get("label_attention_mask"))
                loss = loss_fn(logits, labels, mask=mask)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        with torch.no_grad():
            grad_norm = global_norm(grads)
            opt_state = optimizer.update(grads, trainable, ts["opt_state"])
            probs = torch.sigmoid(logits.detach().float())
            valid = mask > 0
            pred = (probs > decision_threshold) & valid
            tgt = (labels > 0) & valid
            metrics = {
                "loss": loss.detach(),
                "tp": (pred & tgt).sum(0, dtype=torch.int32),
                "fp": (pred & ~tgt).sum(0, dtype=torch.int32),
                "fn": (~pred & tgt).sum(0, dtype=torch.int32),
                "grad_norm": grad_norm,
                "examples": batch["example_mask"].sum(),
            }
        new_ts = dict(ts, model_state=model_state, opt_state=opt_state, step=ts["step"] + 1,
                      enc_state=enc_state if enc_train else ts["enc_state"])
        return new_ts, metrics

    return step


def make_eval_step(pi_cfg: ProteInferConfig, pn_cfg: ProtNoteConfig,
                   loss_fn: Optional[Callable] = None, text_cfg=None,
                   pooling_method: str = "mean", lora_alpha: float = 8.0,
                   lora_rank: int = 4
                   ) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """Returns ``(params_bundle, batch) -> {"logits": (B, L) float32[,
    "loss"]}``.

    ``params_bundle`` has trainable/model_state/enc_params/enc_state (the
    JAX train-state layout); ``batch`` has ``aa_ids``, ``lengths`` and the
    label side: precomputed ``label_latents`` (L', latent_dim), or label
    rows (``label_embeddings``, or ``label_rows`` with ``label_matrix``).
    With ``text_cfg`` set and tokenized labels in the batch
    (``label_input_ids``, ``label_attention_mask``), the label embeddings
    come from the text tower on the fly: ``trainable["text"]`` or the
    bundle's ``text_params``, with the adapters of ``trainable["lora"]``,
    pooled by ``pooling_method`` (zero-shot scoring of new label text).
    With ``loss_fn`` and ``label_multihots`` in the batch, ``loss`` is the
    masked loss of the (ensembled) logits."""

    @torch.inference_mode()
    def step(ts: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        enc_params = ts["trainable"].get("encoder", ts["enc_params"])
        P_f, _ = embed_from_ids(enc_params, ts["enc_state"], batch["aa_ids"],
                                batch["lengths"], pi_cfg)
        pn, state = ts["trainable"]["protnote"], ts["model_state"]
        if "label_latents" in batch:
            logits, _ = protnote_forward(pn, state, P_f, None, pn_cfg,
                                         label_latents=batch["label_latents"])
        else:
            if text_cfg is not None and "label_input_ids" in batch:
                label_embeddings = _tower_embeddings(ts, batch, text_cfg, pooling_method,
                                                     lora_alpha, lora_rank)
            else:
                label_embeddings = _resolve_label_embeddings(batch)
            logits, _ = protnote_forward(pn, state, P_f, label_embeddings, pn_cfg,
                                         label_attention_mask=batch.get("label_attention_mask"))
        out = {"logits": logits.float()}
        if loss_fn is not None and batch.get("label_multihots") is not None:
            mask = _pair_mask(batch["example_mask"], batch["label_multihots"].shape[1],
                              batch.get("label_mask"))
            out["loss"] = loss_fn(logits, batch["label_multihots"], mask=mask)
        return out

    return step


def batch_to_device_dict(batch, device) -> Dict[str, torch.Tensor]:
    """``protnote_tpu.data.batching.Batch`` -> a dict of tensors on
    ``device`` for the steps: ``example_mask`` and ``label_mask`` as float32,
    ``label_rows`` as int32, the other arrays in their own dtypes."""

    def put(a, dtype=None) -> torch.Tensor:
        a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
        return torch.from_numpy(a).to(device)

    out = {
        "aa_ids": put(batch.aa_ids),
        "lengths": put(batch.lengths),
        "example_mask": put(batch.example_mask, np.float32),
    }
    if batch.label_embeddings is not None:
        out["label_embeddings"] = put(batch.label_embeddings)
    if batch.label_rows is not None:
        out["label_rows"] = put(batch.label_rows, np.int32)
    if batch.label_multihots is not None:
        out["label_multihots"] = put(batch.label_multihots)
    if batch.label_mask is not None:
        out["label_mask"] = put(batch.label_mask, np.float32)
    return out
