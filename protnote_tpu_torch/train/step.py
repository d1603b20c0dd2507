"""Eval step: ProteInfer embedding -> ProtNote scoring against label latents.

Port of the ``label_latents`` fast path of the JAX ``make_eval_step``
(``protnote_tpu/train/step.py``).  PyTorch runs eagerly, so the step is a
plain function; the train step, the loss and the other label sources come
with the training slice of the port.  :func:`batch_to_device_dict` moves a
host batch of the data pipeline to the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

import torch

from protnote_tpu_torch.models.fusion import ProtNoteConfig, protnote_forward
from protnote_tpu_torch.models.proteinfer import ProteInferConfig, embed_from_ids


def make_eval_step(pi_cfg: ProteInferConfig, pn_cfg: ProtNoteConfig
                   ) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """Returns ``(params_bundle, batch) -> {"logits": (B, L) float32}``.

    ``params_bundle`` has trainable/model_state/enc_params/enc_state (the
    JAX train-state layout, :func:`~protnote_tpu_torch.models.convert.from_jax_tree`);
    ``batch`` has ``aa_ids`` (B, T), ``lengths`` (B,) and ``label_latents``
    (L', latent_dim), all on one device."""

    @torch.inference_mode()
    def step(ts: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if "label_latents" not in batch:
            raise NotImplementedError(
                "the port's eval step takes precomputed label_latents; label "
                "embeddings per batch come with the training slice"
            )
        enc_params = ts["trainable"].get("encoder", ts["enc_params"])
        P_f = embed_from_ids(enc_params, ts["enc_state"], batch["aa_ids"],
                             batch["lengths"], pi_cfg)
        logits = protnote_forward(
            ts["trainable"]["protnote"], ts["model_state"], P_f, None, pn_cfg,
            label_latents=batch["label_latents"],
        )
        return {"logits": logits.float()}

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
