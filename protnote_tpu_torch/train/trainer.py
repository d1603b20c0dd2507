"""Evaluation engine of the port: the all-on-device metric path.

Port of the evaluation half of ``protnote_tpu/train/trainer.py``: the eval
fields of ``TrainerConfig``, ``ThroughputMeter``, and a ``Trainer`` whose
``evaluate`` runs the ``ESTIMATE_MAP`` device-accumulator branch.  Per
evaluation the label-embedding view matrix is uploaded once and projected
through W_l once (the label latents); per batch the eval step (ProteInfer,
heads, the pair scorer K1, the ensemble) is followed by a K3 update on the
same device, and the logits never leave it.  ``finalize_into`` then computes
AP on the device and reads back only per-label results and counters.

Branches of the JAX ``evaluate`` that need host logits (prediction and
embedding export, GO-DAG normalisation, represented-label slicing, the exact
AUPRC), the threshold sweep and label-subsampled batchers raise
``NotImplementedError`` naming the ROADMAP item that brings them.  Training,
the text tower and meshes come with later slices.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from protnote_tpu_torch.evaln.metrics import (
    EXACT_AUPRC_LATER,
    DeviceEvalAccumulator,
    EvalMetrics,
)
from protnote_tpu_torch.models.fusion import compute_label_latents
from protnote_tpu_torch.models.layers import tree_to
from protnote_tpu_torch.train.step import batch_to_device_dict, make_eval_step

logger = logging.getLogger(__name__)

HOST_LOGITS_LATER = ("{} reads logits back to the host; the port evaluates on the "
                     "device only so far (ROADMAP.md queue 1, item 2: prediction/embedding "
                     "export and the host metric path)")
SWEEP_LATER = ("the decision-threshold sweep (DECISION_TH null with a validation "
               "set) is not ported yet (ROADMAP.md queue 1, item 2)")
SUBSET_LATER = ("label-subsampled or per-batch label layouts (label sampling, "
                "shuffled/in-batch labels, grid tiles) are not ported yet "
                "(ROADMAP.md queue 1, item 2)")


def _is_grid(batcher) -> bool:
    """Grid-batcher detection by its signature attribute (a PrefetchBatcher
    delegates attribute probes to the batcher it wraps)."""
    return getattr(batcher, "labels_batch_size", None) is not None


@dataclass
class TrainerConfig:
    """The evaluation fields of the JAX ``TrainerConfig``."""

    decision_threshold: Optional[float] = 0.5
    estimate_map: bool = False

    @classmethod
    def from_params(cls, params: Dict) -> "TrainerConfig":
        return cls(decision_threshold=params.get("DECISION_TH", 0.5),
                   estimate_map=params.get("ESTIMATE_MAP", False))


class ThroughputMeter:
    """seqs/sec and pair-scores/sec over a sliding window (host clock)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.seqs = 0
        self.pairs = 0

    def add(self, num_seqs: int, num_labels: int):
        self.seqs += num_seqs
        self.pairs += num_seqs * num_labels

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {"seqs_per_sec": self.seqs / dt, "pairs_per_sec": self.pairs / dt}


class Trainer:
    """``train_state``: the port's parameter bundle (CPU or device tensors,
    the JAX train-state layout without the optimizer state); it is moved to
    ``device`` once."""

    def __init__(self, train_state: Dict[str, Any], pi_cfg, pn_cfg,
                 config: TrainerConfig, device="cuda"):
        self.device = torch.device(device)
        self.pi_cfg = pi_cfg
        self.pn_cfg = pn_cfg
        self.cfg = config
        self.ts = tree_to(train_state, self.device)
        self._eval_step = make_eval_step(pi_cfg, pn_cfg)
        self.meter = ThroughputMeter()
        self._label_matrices: Dict[int, Any] = {}

    # ---------------- device-resident label matrix ----------------

    def _label_matrix_for(self, ds) -> Optional[torch.Tensor]:
        """The label-embedding view matrix of ``ds`` on the device, uploaded
        once; batches then carry only (L*k,) int32 row indices."""
        view = getattr(ds, "label_view", None)
        if view is None:
            return None
        # the entry pins the view: keyed by id() alone, a collected view's
        # recycled address could serve another dataset's matrix
        key = id(view)
        if key not in self._label_matrices:
            m = torch.as_tensor(view.embeddings, dtype=torch.float32).to(self.device)
            self._label_matrices[key] = (view, m)
        else:
            self._label_matrices[key] = self._label_matrices.pop(key)  # LRU touch
        while len(self._label_matrices) > 2:  # train + current eval set
            self._label_matrices.pop(next(iter(self._label_matrices)))
        return self._label_matrices[key][1]

    def _place(self, arrays: Dict[str, Any],
               label_matrix: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Attach the resident label matrix to a batch that carries
        ``label_rows`` (the JAX ``_place`` without a mesh)."""
        if "label_rows" in arrays:
            if label_matrix is None:
                raise ValueError("batch carries label_rows (device_label_gather) but "
                                 "no resident label matrix was provided")
            arrays["label_matrix"] = label_matrix
        return arrays

    # ---------------- eval label-latent precompute ----------------

    def _latents_eligible(self, batcher) -> bool:
        """The label layout is batch-invariant iff no per-batch label
        re-selection happens: then W_l projects the matrix once per
        evaluation."""
        ds = batcher.ds
        return (
            self.pn_cfg.label_embedding_pooling_method != "all"
            and not _is_grid(batcher)
            and not getattr(batcher, "shuffle_labels", False)
            and not getattr(batcher, "in_batch_sampling", False)
            and not (ds.cfg.is_train and ds.cfg.label_augmentation_descriptions)
        )

    @torch.inference_mode()
    def _label_latents(self, arrays: Dict[str, Any]) -> torch.Tensor:
        """Gather the batch's label rows and project them through W_l."""
        L_f = arrays["label_matrix"].index_select(0, arrays["label_rows"].long())
        return compute_label_latents(self.ts["trainable"]["protnote"],
                                     self.ts["model_state"], L_f, self.pn_cfg)

    @staticmethod
    def _swap_in_latents(arrays: Dict[str, Any], latents: torch.Tensor) -> Dict[str, Any]:
        out = {k: v for k, v in arrays.items() if k not in ("label_rows", "label_matrix")}
        out["label_latents"] = latents
        return out

    def _fused_eval_step(self, device_acc: DeviceEvalAccumulator):
        """``(ts, arrays, mstate, cols) -> (out, mstate)``: the eval step,
        then the K3 update of ``mstate`` on the same device (in place)."""
        step, upd = self._eval_step, device_acc.update_fn

        def fused(ts, arrays, mstate, cols):
            out = step(ts, arrays)
            lm = arrays.get("label_mask")
            if lm is None:
                lm = torch.ones(out["logits"].shape[1], dtype=torch.float32,
                                device=out["logits"].device)
            mstate = upd(mstate, out["logits"], arrays["label_multihots"],
                         arrays["example_mask"], lm, cols)
            return out, mstate

        return fused

    # ---------------- checkpoints ----------------

    def load(self, path: str) -> None:
        """Restore weights from ``path`` (a ``PNTPU1`` ``.ckpt`` or a
        reference ``.pt``) and commit them to the device."""
        from protnote_tpu_torch.cli._model_setup import load_model_file

        ts, _ = load_model_file(self.ts, path, self.pi_cfg, self.pn_cfg)
        self.ts = tree_to(ts, self.device)

    # ---------------- evaluation ----------------

    @staticmethod
    def _batch_valid(batch) -> int:
        if batch.global_valid_count is not None:
            return int(batch.global_valid_count)
        return int(batch.example_mask.sum())

    @staticmethod
    def _batch_label_width(batch, num_labels: int) -> int:
        if batch.label_indices is not None:
            return int(len(batch.label_indices))
        return num_labels

    def evaluate(
        self,
        batcher,
        dataset=None,
        save_results: bool = False,
        output_dir: Optional[str] = None,
        data_split_name: str = "test",
        only_represented_labels: bool = False,
        normalize_probabilities: bool = False,
        parenthood: Optional[Dict] = None,
        save_embeddings: bool = False,
        threshold_sweep=None,
        compute_metrics: bool = True,
    ) -> Dict[str, Any]:
        """``{"metrics": {...}}`` over every batch of ``batcher``: the
        ``EvalMetrics.compute()`` dict (binned AUPRC) plus seqs/s and
        pairs/s.  The signature is the JAX one; the arguments this slice
        does not port raise."""
        for flag, name in ((save_results, "save_results"),
                           (save_embeddings, "save_embeddings"),
                           (normalize_probabilities, "normalize_probabilities"),
                           (only_represented_labels, "only_represented_labels"),
                           (not compute_metrics, "compute_metrics=False")):
            if flag:
                raise NotImplementedError(HOST_LOGITS_LATER.format(name))
        if threshold_sweep is not None:
            raise NotImplementedError(SWEEP_LATER)
        if not self.cfg.estimate_map:
            raise NotImplementedError(EXACT_AUPRC_LATER)
        ds = dataset if dataset is not None else batcher.ds
        num_labels = ds.num_labels
        sample_size = getattr(batcher, "label_sample_size", None)
        if (sample_size is not None and sample_size < num_labels) or \
                not self._latents_eligible(batcher):
            raise NotImplementedError(SUBSET_LATER)
        if not getattr(batcher, "device_label_gather", False):
            raise NotImplementedError(
                "label embeddings shipped with every batch "
                "(DEVICE_RESIDENT_LABEL_EMBEDDINGS False) are not ported (ROADMAP.md "
                "queue 1, item 2); the port gathers from the resident label matrix")

        metrics = EvalMetrics(num_labels, threshold=self.cfg.decision_threshold,
                              map_estimate=True)
        device_acc = DeviceEvalAccumulator(num_labels, self.cfg.decision_threshold,
                                           device=self.device)
        fused = self._fused_eval_step(device_acc)
        label_matrix = self._label_matrix_for(batcher.ds)
        latents = None
        self.meter.reset()
        for batch in batcher:
            arrays = self._place(batch_to_device_dict(batch, self.device), label_matrix)
            if "label_multihots" not in arrays:
                raise ValueError("device evaluation needs label_multihots (build the "
                                 "batcher with return_label_multihots=True)")
            if latents is None:  # the label layout is batch-invariant here
                latents = self._label_latents(arrays)
            arrays = self._swap_in_latents(arrays, latents)
            cols = device_acc.cols_for(batch.label_indices,
                                       arrays["label_multihots"].shape[1])
            _, device_acc.state = fused(self.ts, arrays, device_acc.state, cols)
            self.meter.add(self._batch_valid(batch),
                           self._batch_label_width(batch, num_labels))
        device_acc.finalize_into(metrics)
        m = metrics.compute()
        m.update(self.meter.rates())
        logger.info("%s: %d sequences evaluated on %s", data_split_name,
                    self.meter.seqs, self.device)
        return {"metrics": m}
