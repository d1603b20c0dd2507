"""Training and evaluation engine of the port.

Port of ``protnote_tpu/train/trainer.py`` for one device:

* ``train``/``train_one_epoch``: the epoch loop over the bucketed batcher,
  one train step per batch (frozen encoder, heads, the decomposed scorer
  K4 + K5, the loss, autograd, the optimizer), full-vocabulary tp/fp/fn
  summed on the device (:class:`TrainConfusionAccumulator`), validation
  every ``epochs_per_validation`` epochs, and the checkpoint policy of the
  reference (best validation metric, best validation loss, every 10 epochs,
  the last epoch), then the best checkpoint reloaded.
* ``evaluate``: the ``ESTIMATE_MAP`` device-accumulator branch.  Per
  evaluation the label-embedding view matrix is uploaded once and projected
  through W_l once (the label latents); per batch the eval step (ProteInfer,
  heads, the pair scorer K1 or, with ``PAIR_BACKEND=tiled_int8``, K2, the
  ensemble, the masked loss) is followed by a K3 update on the same device.
  ``finalize_into`` then computes AP on the device and reads back only
  per-label results and counters; ``loss`` is the mean of the per-batch
  losses.
* int8: without supplied ``INT8_ACT_SCALES``, ``evaluate`` first calibrates
  static activation scales on the batcher's first batch
  (``ensure_int8_calibrated``; ``INT8_CALIBRATE False`` keeps the dynamic
  per-row scales).  Auto scales are a function of the weights, so a
  training epoch and ``load`` drop them; supplied ones are kept.

Checkpoints are ``PNTPU1`` files that the JAX ``restore_checkpoint`` reads,
written synchronously.  Branches of the JAX trainer that need host logits
(prediction and embedding export, GO-DAG normalisation, represented-label
slicing, the exact AUPRC), the threshold sweep, label-subsampled batchers,
profiler traces, wandb, the text tower and meshes raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from protnote_tpu_torch.evaln.metrics import (
    EXACT_AUPRC_LATER,
    DeviceEvalAccumulator,
    EvalMetrics,
    confusion_metrics,
)
from protnote_tpu_torch.models.fusion import calibrate_int8_maxes, compute_label_latents
from protnote_tpu_torch.models.layers import tree_to
from protnote_tpu_torch.models.proteinfer import embed_from_ids
from protnote_tpu_torch.train.step import (
    batch_to_device_dict,
    make_eval_step,
    make_train_step,
)

logger = logging.getLogger(__name__)

HOST_LOGITS_LATER = ("{} reads logits back to the host; the port evaluates on the "
                     "device only so far (ROADMAP.md queue 1, item 3: prediction/embedding "
                     "export and the host metric path)")
SWEEP_LATER = ("the decision-threshold sweep (DECISION_TH null with a validation "
               "set) is not ported yet (ROADMAP.md queue 1, item 3)")
SUBSET_LATER = ("label-subsampled or per-batch label layouts (label sampling, "
                "shuffled/in-batch labels, grid tiles) are not ported yet "
                "(ROADMAP.md queue 1, item 3)")
TRAIN_SUBSET_LATER = ("label-subset training batches (TRAIN_LABEL_SAMPLE_SIZE, "
                      "SHUFFLE_LABELS, IN_BATCH_SAMPLING, GRID_SAMPLER) are not ported "
                      "(ROADMAP.md queue 1, item 5c)")


def _is_grid(batcher) -> bool:
    """Grid-batcher detection by its signature attribute (a PrefetchBatcher
    delegates attribute probes to the batcher it wraps)."""
    return getattr(batcher, "labels_batch_size", None) is not None


@dataclass
class TrainerConfig:
    """The fields of the JAX ``TrainerConfig`` that the port reads."""

    num_epochs: int = 1
    epochs_per_validation: int = 1
    decision_threshold: Optional[float] = 0.5
    optimization_metric_name: str = "f1_macro"
    estimate_map: bool = False
    seed: int = 42
    checkpoint_dir: Optional[str] = None
    run_name: str = "run"
    log_every_fraction: float = 0.1
    # per-step non-finite loss/grad check (a host sync every step)
    debug_nan: bool = False
    # auto-calibrate static int8 activation scales on the first batch of an
    # evaluation when PAIR_BACKEND=tiled_int8 and no INT8_ACT_SCALES are set
    # (False keeps the dynamic per-row scales)
    int8_calibrate: bool = True

    @classmethod
    def from_params(cls, params: Dict, **overrides) -> "TrainerConfig":
        kw = dict(
            num_epochs=params.get("NUM_EPOCHS", 1),
            epochs_per_validation=params.get("EPOCHS_PER_VALIDATION", 1),
            decision_threshold=params.get("DECISION_TH", 0.5),
            optimization_metric_name=params.get("OPTIMIZATION_METRIC_NAME", "f1_macro"),
            estimate_map=params.get("ESTIMATE_MAP", False),
            seed=params.get("SEED", 42),
            debug_nan=params.get("DEBUG_NAN", False),
            int8_calibrate=params.get("INT8_CALIBRATE", True),
        )
        kw.update(overrides)
        return cls(**kw)


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


class TrainConfusionAccumulator:
    """Sums the train step's per-label tp/fp/fn over an epoch on the device
    (the full-vocabulary path of the JAX accumulator; label-subset batches
    raise)."""

    def __init__(self, num_labels: int):
        self.num_labels = num_labels
        self.tp = self.fp = self.fn = None

    def update(self, metrics: Dict[str, Any], label_indices=None) -> None:
        if label_indices is not None and len(label_indices) != self.num_labels:
            raise NotImplementedError(TRAIN_SUBSET_LATER)
        if self.tp is None:
            self.tp, self.fp, self.fn = (metrics[k].clone() for k in ("tp", "fp", "fn"))
            return
        self.tp += metrics["tp"]
        self.fp += metrics["fp"]
        self.fn += metrics["fn"]

    def compute(self) -> Dict[str, float]:
        if self.tp is None:
            return {}
        return confusion_metrics(*(x.cpu().numpy()[: self.num_labels]
                                   for x in (self.tp, self.fp, self.fn)))


class Trainer:
    """``train_state``: the port's bundle in the JAX train-state layout
    (CPU or device tensors); it is moved to ``device`` once.  Training needs
    ``loss_fn`` and ``optimizer`` (the :class:`~protnote_tpu_torch.train.optim.Optimizer`
    that made ``train_state["opt_state"]``); evaluation reports ``loss``
    when ``loss_fn`` is given."""

    def __init__(self, train_state: Dict[str, Any], pi_cfg, pn_cfg,
                 config: TrainerConfig, device="cuda", loss_fn: Optional[Callable] = None,
                 optimizer=None):
        self.device = torch.device(device)
        self.pi_cfg = pi_cfg
        self.pn_cfg = pn_cfg
        self.cfg = config
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.ts = tree_to(train_state, self.device)
        self._eval_step = make_eval_step(pi_cfg, pn_cfg, loss_fn)
        self._train_step = None
        if loss_fn is not None and optimizer is not None:
            self._train_step = make_train_step(
                pi_cfg, pn_cfg, loss_fn, optimizer,
                decision_threshold=config.decision_threshold or 0.5)
        self.meter = ThroughputMeter()
        self._label_matrices: Dict[int, Any] = {}
        self.starting_epoch = 0
        self.epoch = 0
        self.best_val_metric = -float("inf")
        self.best_val_loss = float("inf")
        self._int8_scales_auto = False

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

    # ---------------- int8 activation scales ----------------

    def ensure_int8_calibrated(self, batcher) -> None:
        """Calibrate static int8 activation scales once (first batch) when
        the int8 backend is active, no scales were supplied and
        ``int8_calibrate`` is set; no-op otherwise."""
        if (self.cfg.int8_calibrate and self.pn_cfg.pair_backend == "tiled_int8"
                and self.pn_cfg.int8_act_scales is None):
            self.calibrate_int8(batcher)

    @torch.inference_mode()
    def calibrate_int8(self, batcher, margin: float = 1.05) -> tuple:
        """Static int8 activation scales from the batcher's first batch (max
        |GEMM input| of each hidden layer x ``margin`` / 127): recorded in
        ``self.pn_cfg.int8_act_scales``, the eval step rebuilt with them,
        and returned."""
        if self.pn_cfg.pair_backend != "tiled_int8":
            raise ValueError("calibrate_int8 requires PAIR_BACKEND=tiled_int8")
        label_matrix = (self._label_matrix_for(batcher.ds)
                        if getattr(batcher, "device_label_gather", False) else None)
        batch = next(iter(batcher))
        arrays = self._place(batch_to_device_dict(batch, self.device), label_matrix)
        ts = self.ts
        P_f = embed_from_ids(ts["trainable"].get("encoder", ts["enc_params"]), ts["enc_state"],
                             arrays["aa_ids"], arrays["lengths"], self.pi_cfg)
        pn = ts["trainable"]["protnote"]
        if "label_rows" in arrays:
            maxes = calibrate_int8_maxes(pn, ts["model_state"], P_f, self.pn_cfg,
                                         label_latents=self._label_latents(arrays))
        else:
            maxes = calibrate_int8_maxes(pn, ts["model_state"], P_f, self.pn_cfg,
                                         label_embeddings=arrays["label_embeddings"])
        scales = tuple(float(m) * margin / 127.0 for m in maxes.cpu().tolist())
        self.pn_cfg = dataclasses.replace(self.pn_cfg, int8_act_scales=scales)
        self._eval_step = make_eval_step(self.pi_cfg, self.pn_cfg, self.loss_fn)
        self._int8_scales_auto = True
        logger.info("int8 static activation scales: %s", [round(s, 6) for s in scales])
        return scales

    def _invalidate_auto_int8(self) -> None:
        """Drop auto-calibrated int8 scales (they are a function of the
        weights) and rebuild the eval step without them; the next
        ``evaluate`` recalibrates.  Supplied scales are never touched."""
        if not (self._int8_scales_auto and self.pn_cfg.int8_act_scales is not None):
            return
        self.pn_cfg = dataclasses.replace(self.pn_cfg, int8_act_scales=None)
        self._eval_step = make_eval_step(self.pi_cfg, self.pn_cfg, self.loss_fn)
        self._int8_scales_auto = False

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

    def _ckpt_path(self, kind: str) -> str:
        return os.path.join(self.cfg.checkpoint_dir or ".", f"{self.cfg.run_name}_{kind}.ckpt")

    def save(self, kind: str) -> None:
        """Write ``{run_name}_{kind}.ckpt`` (no-op without a checkpoint
        directory): the train state in the JAX layout, the epoch and the
        best validation metric."""
        if self.cfg.checkpoint_dir is None:
            return
        from protnote_tpu_torch.core.checkpoint import save_checkpoint
        from protnote_tpu_torch.models.convert import to_jax_tree

        save_checkpoint(self._ckpt_path(kind), to_jax_tree(self.ts, self.optimizer),
                        epoch=self.epoch, best_val_metric=self.best_val_metric)

    def load(self, path: str, from_checkpoint: bool = False) -> None:
        """Restore ``path`` (a ``PNTPU1`` ``.ckpt`` or a reference ``.pt``)
        and commit it to the device.  A ``.ckpt`` also restores ``step`` and
        the optimizer state when this trainer holds one; ``from_checkpoint``
        resumes at the epoch after the saved one, with its best metric."""
        from protnote_tpu_torch.cli._model_setup import load_model_file

        ts, meta = load_model_file(self.ts, path, self.pi_cfg, self.pn_cfg, self.optimizer)
        self.ts = tree_to(ts, self.device)
        # restored weights differ from the ones auto scales were calibrated on
        self._invalidate_auto_int8()
        if from_checkpoint:
            self.starting_epoch = self.epoch = int(meta.get("epoch") or 0) + 1
            if meta.get("best_val_metric") is not None:
                self.best_val_metric = meta["best_val_metric"]

    # ---------------- training ----------------

    def _generator(self, epoch: int) -> torch.Generator:
        """The epoch's generator for label noise and dropout, on the device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.cfg.seed) * 100003 + epoch)
        return gen

    def train_one_epoch(self, batcher, generator: torch.Generator) -> Dict[str, float]:
        if self._train_step is None:
            raise ValueError("training needs a loss_fn and an optimizer")
        self._invalidate_auto_int8()  # training changes the weights the scales came from
        num_batches = max(len(batcher), 1)
        log_every = max(int(num_batches * self.cfg.log_every_fraction), 1)
        losses: List[torch.Tensor] = []
        self.meter.reset()
        num_labels = batcher.ds.num_labels
        confusion = TrainConfusionAccumulator(num_labels)
        label_matrix = (self._label_matrix_for(batcher.ds)
                        if getattr(batcher, "device_label_gather", False) else None)
        for i, batch in enumerate(batcher):
            arrays = self._place(batch_to_device_dict(batch, self.device), label_matrix)
            self.ts, metrics = self._train_step(self.ts, arrays, generator)
            if i == 0 and self.epoch == self.starting_epoch and self.device.type == "cuda":
                logger.info("device memory after the first step: %.2f GB allocated, "
                            "%.2f GB peak", torch.cuda.memory_allocated(self.device) / 2**30,
                            torch.cuda.max_memory_allocated(self.device) / 2**30)
            if self.cfg.debug_nan:
                loss_v, gnorm_v = float(metrics["loss"]), float(metrics["grad_norm"])
                if not (np.isfinite(loss_v) and np.isfinite(gnorm_v)):
                    raise FloatingPointError(
                        f"non-finite training signal at epoch {self.epoch} step {i}: "
                        f"loss={loss_v}, grad_norm={gnorm_v}")
            losses.append(metrics["loss"])
            confusion.update(metrics, batch.label_indices)
            self.meter.add(self._batch_valid(batch), self._batch_label_width(batch, num_labels))
            if (i + 1) % log_every == 0:
                rates = self.meter.rates()
                logger.info("epoch %d [%d/%d] loss=%.4f %.1f seqs/s %.3g pairs/s", self.epoch,
                            i + 1, num_batches, float(metrics["loss"]),
                            rates["seqs_per_sec"], rates["pairs_per_sec"])
        out = {"loss": float(torch.stack(losses).mean()) if losses else float("nan")}
        if losses and not np.isfinite(out["loss"]):
            raise FloatingPointError(f"non-finite training loss at epoch {self.epoch}: "
                                     f"{out['loss']}")
        out.update(confusion.compute())
        out.update(self.meter.rates())
        return out

    def train(self, train_batcher, val_batcher=None, val_dataset=None) -> Dict[str, Any]:
        """Train ``cfg.num_epochs`` epochs from ``starting_epoch``: ``{"history":
        [per-epoch metrics], "best_val_metric"}``; the best-metric checkpoint
        is loaded afterwards when one was written."""
        history: List[Dict[str, float]] = []
        for epoch in range(self.starting_epoch, self.cfg.num_epochs):
            self.epoch = epoch
            train_batcher.set_epoch(epoch)
            m = self.train_one_epoch(train_batcher, self._generator(epoch))
            m["epoch"] = epoch
            logger.info("epoch %d train: %s", epoch, _fmt(m))
            if val_batcher is not None and (epoch + 1) % self.cfg.epochs_per_validation == 0:
                vm = self.validate(val_batcher, val_dataset)
                m.update({f"val_{k}": v for k, v in vm.items()})
                logger.info("epoch %d val: %s", epoch, _fmt(vm))
                metric = vm.get(self.cfg.optimization_metric_name)
                if metric is not None and metric > self.best_val_metric:
                    self.best_val_metric = metric
                    self.save("best_val_metric")
                if vm.get("loss", float("inf")) < self.best_val_loss:
                    self.best_val_loss = vm["loss"]
                    self.save("best_val_loss")
            if (epoch + 1) % 10 == 0:
                self.save(f"epoch_{epoch + 1}")
            history.append(m)
        self.save("last_epoch")
        best = self._ckpt_path("best_val_metric")
        if self.cfg.checkpoint_dir is not None and os.path.exists(best):
            self.load(best)
        return {"history": history, "best_val_metric": self.best_val_metric}

    def validate(self, batcher, dataset=None) -> Dict[str, float]:
        return self.evaluate(batcher, dataset)["metrics"]

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
        ``EvalMetrics.compute()`` dict (binned AUPRC), ``loss`` (the mean of
        the per-batch masked losses, with a ``loss_fn``) and seqs/s and
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
                "queue 1, item 3); the port gathers from the resident label matrix")

        self.ensure_int8_calibrated(batcher)
        metrics = EvalMetrics(num_labels, threshold=self.cfg.decision_threshold,
                              map_estimate=True)
        device_acc = DeviceEvalAccumulator(num_labels, self.cfg.decision_threshold,
                                           device=self.device)
        fused = self._fused_eval_step(device_acc)
        label_matrix = self._label_matrix_for(batcher.ds)
        latents = None
        losses: List[torch.Tensor] = []
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
            out, device_acc.state = fused(self.ts, arrays, device_acc.state, cols)
            if "loss" in out:
                losses.append(out["loss"])
            self.meter.add(self._batch_valid(batch),
                           self._batch_label_width(batch, num_labels))
        device_acc.finalize_into(metrics)
        m = metrics.compute()
        if losses:
            m["loss"] = float(np.mean([float(x) for x in losses]))
            if not np.isfinite(m["loss"]):
                logger.error("non-finite eval loss on %s", data_split_name)
        m.update(self.meter.rates())
        logger.info("%s: %d sequences evaluated on %s", data_split_name,
                    self.meter.seqs, self.device)
        return {"metrics": m}


def _fmt(m: Dict[str, float]) -> str:
    return " ".join(f"{k}={v:.4g}" for k, v in m.items() if isinstance(v, (int, float)))
