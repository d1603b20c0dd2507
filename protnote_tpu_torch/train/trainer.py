"""Training and evaluation engine of the port.

Port of ``protnote_tpu/train/trainer.py`` for one device:

* ``train``/``train_one_epoch``: the epoch loop over the bucketed batcher,
  one train step per batch (the encoder K7, frozen unless
  ``train_sequence_encoder``, with batch-statistics BatchNorm under either
  that or ``encoder_bn_train_mode``; heads, the decomposed scorer K4 + K5
  and K4-bwd, the loss, autograd, the optimizer), tp/fp/fn summed
  into full-vocabulary totals on the device (:class:`TrainConfusionAccumulator`), validation
  every ``epochs_per_validation`` epochs, and the checkpoint policy of the
  reference (best validation metric, best validation loss, every 10 epochs,
  the last epoch), then the best checkpoint reloaded.
* ``evaluate``: per evaluation the label-embedding view matrix is uploaded
  once and projected through W_l once (the label latents); per batch the
  eval step runs (ProteInfer, heads, the pair scorer K1 or, with
  ``PAIR_BACKEND=tiled_int8``, K2, the ensemble, the masked loss).  With
  ``ESTIMATE_MAP`` and no host branch, a K3 update follows on the same
  device and ``finalize_into`` computes AP there, reading back only
  per-label results and counters.  Otherwise the logits are read back once
  a batch into the host ``EvalMetrics`` (exact AUPRC without
  ``ESTIMATE_MAP``), after GO-DAG normalisation (``normalize_probabilities``)
  and represented-label slicing, and predictions (``save_results``) and
  sequence embeddings (``save_embeddings``, every 100 batches) are written.
  ``threshold_sweep`` adds each batch's device logits to the K9 counters of
  every candidate threshold on either path, and the best threshold by
  ``decision_th_metric_name`` comes back in ``result["threshold"]``.
  ``loss`` is the mean of the per-batch losses.
* int8: without supplied ``INT8_ACT_SCALES``, ``evaluate`` first calibrates
  static activation scales on the batcher's first batch
  (``ensure_int8_calibrated``; ``INT8_CALIBRATE False`` keeps the dynamic
  per-row scales).  Auto scales are a function of the weights, so a
  training epoch and ``load`` drop them; supplied ones are kept.

Label layouts: training batches may carry a label subset (fixed, shuffled,
in-batch or grid sampling): the train step runs K4 and K4-bwd at the batch's
label count and the epoch's tp/fp/fn are scatter-added at its
``label_indices``.  Evaluation takes a fixed subset (metrics over the sampled
prefix) or, with ``ESTIMATE_MAP``, a varying one (K3 scatters through its
``cols`` path), and label embeddings shipped with every batch
(``DEVICE_RESIDENT_LABEL_EMBEDDINGS False``), which the eval step projects
batch by batch, as the JAX trainer does.

The label text tower (``text_cfg`` with ``label_tokens``, the tokenized
descriptions of the label cache): each batch's description rows
(``label_description_indices``) pick their token rows, and both steps embed
them through the tower (training it where ``trainable`` holds ``text`` or
``lora``); evaluation then projects every batch's labels itself.

Checkpoints are ``PNTPU1`` files that the JAX ``restore_checkpoint`` reads,
written synchronously.  Profiler traces, wandb and meshes are not ported;
the CLI refuses them.
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
    DeviceEvalAccumulator,
    EvalMetrics,
    confusion_metrics,
)
from protnote_tpu_torch.evaln.go_dag import DagNormalizer
from protnote_tpu_torch.evaln.results_io import save_evaluation_results
from protnote_tpu_torch.models.fusion import calibrate_int8_maxes, compute_label_latents
from protnote_tpu_torch.models.layers import tree_to
from protnote_tpu_torch.models.proteinfer import embed_from_ids
from protnote_tpu_torch.ops.threshold_sweep import SweepCounter
from protnote_tpu_torch.train.step import (
    batch_to_device_dict,
    make_eval_step,
    make_train_step,
)

logger = logging.getLogger(__name__)

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
    decision_th_metric_name: str = "f1_macro"
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
    # exact-mAP host accumulator: spill score shards to the disk spool past
    # this many buffered bytes (None = ExactAUPRC's 1 GB default)
    eval_spill_threshold_bytes: Optional[int] = None
    eval_spill_dir: Optional[str] = None
    eval_spill_tile_rows: Optional[int] = None

    @classmethod
    def from_params(cls, params: Dict, **overrides) -> "TrainerConfig":
        kw = dict(
            num_epochs=params.get("NUM_EPOCHS", 1),
            epochs_per_validation=params.get("EPOCHS_PER_VALIDATION", 1),
            decision_threshold=params.get("DECISION_TH", 0.5),
            optimization_metric_name=params.get("OPTIMIZATION_METRIC_NAME", "f1_macro"),
            decision_th_metric_name=params.get("DECISION_TH_METRIC_NAME", "f1_macro"),
            estimate_map=params.get("ESTIMATE_MAP", False),
            seed=params.get("SEED", 42),
            debug_nan=params.get("DEBUG_NAN", False),
            int8_calibrate=params.get("INT8_CALIBRATE", True),
            eval_spill_threshold_bytes=params.get("EVAL_SPILL_THRESHOLD_BYTES"),
            eval_spill_dir=params.get("EVAL_SPILL_DIR"),
            eval_spill_tile_rows=params.get("EVAL_SPILL_TILE_ROWS"),
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
    """Sums the train step's per-column tp/fp/fn into full-vocabulary totals
    on the device, as the JAX accumulator: full-vocabulary batches add
    column-wise; a label-subset batch (fixed, shuffled, in-batch or grid
    sampling) is scatter-added at its ``label_indices`` (``index_add_``),
    after the totals so far are promoted to full width."""

    def __init__(self, num_labels: int):
        self.num_labels = num_labels
        self.tp = self.fp = self.fn = None

    def update(self, metrics: Dict[str, Any], label_indices=None) -> None:
        counts = [metrics[k] for k in ("tp", "fp", "fn")]
        full = label_indices is None or len(label_indices) == self.num_labels
        if full and self.tp is None:
            self.tp, self.fp, self.fn = (c.clone() for c in counts)
            return
        if full and self.tp.shape == counts[0].shape:
            for acc, c in zip((self.tp, self.fp, self.fn), counts):
                acc += c
            return
        # subset or mixed widths: promote to full-vocabulary totals, folding
        # in the full-width counts summed so far
        if self.tp is None or self.tp.shape[0] != self.num_labels:
            dev = counts[0].device
            base = [torch.zeros(self.num_labels, dtype=torch.int32, device=dev)
                    for _ in range(3)]
            if self.tp is not None:
                w = min(self.tp.shape[0], self.num_labels)
                for b, acc in zip(base, (self.tp, self.fp, self.fn)):
                    b[:w] += acc[:w].to(torch.int32)
            self.tp, self.fp, self.fn = base
        cols = torch.as_tensor(
            np.asarray(label_indices if label_indices is not None
                       else np.arange(self.num_labels), np.int64), device=self.tp.device)
        n = cols.shape[0]
        for acc, c in zip((self.tp, self.fp, self.fn), counts):
            acc.index_add_(0, cols, c[:n].to(torch.int32))

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
                 optimizer=None, text_cfg=None, label_tokens: Optional[tuple] = None,
                 pooling_method: str = "mean", lora_alpha: float = 8.0, lora_rank: int = 4,
                 train_sequence_encoder: bool = False, encoder_bn_train_mode: bool = False):
        self.device = torch.device(device)
        self.pi_cfg = pi_cfg
        self.pn_cfg = pn_cfg
        self.cfg = config
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.text_cfg = text_cfg
        self.label_tokens = label_tokens  # (ids (M, Tk), attention (M, Tk)) int32
        self._tower_kwargs = dict(text_cfg=text_cfg, pooling_method=pooling_method,
                                  lora_alpha=lora_alpha, lora_rank=lora_rank)
        self.ts = tree_to(train_state, self.device)
        self._eval_step = self._make_eval_step()
        self._train_step = None
        if loss_fn is not None and optimizer is not None:
            self._train_step = make_train_step(
                pi_cfg, pn_cfg, loss_fn, optimizer,
                decision_threshold=config.decision_threshold or 0.5,
                train_sequence_encoder=train_sequence_encoder,
                encoder_bn_train_mode=encoder_bn_train_mode, **self._tower_kwargs)
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

    def _make_eval_step(self):
        return make_eval_step(self.pi_cfg, self.pn_cfg, self.loss_fn, **self._tower_kwargs)

    def _place(self, arrays: Dict[str, Any], label_matrix: Optional[torch.Tensor] = None,
               batch=None) -> Dict[str, Any]:
        """Attach the resident label matrix to a batch that carries
        ``label_rows``, and with the text tower the token rows of its
        descriptions (the JAX ``_place`` without a mesh)."""
        if (self.text_cfg is not None and self.label_tokens is not None and batch is not None
                and batch.label_description_indices is not None):
            ids, attn = self.label_tokens
            idx = batch.label_description_indices
            arrays["label_input_ids"] = torch.from_numpy(ids[idx]).to(self.device)
            arrays["label_attention_mask"] = torch.from_numpy(attn[idx]).to(self.device)
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
        arrays = self._place(batch_to_device_dict(batch, self.device), label_matrix, batch)
        ts = self.ts
        P_f, _ = embed_from_ids(ts["trainable"].get("encoder", ts["enc_params"]),
                                ts["enc_state"], arrays["aa_ids"], arrays["lengths"],
                                self.pi_cfg)
        pn = ts["trainable"]["protnote"]
        if "label_rows" in arrays:
            maxes = calibrate_int8_maxes(pn, ts["model_state"], P_f, self.pn_cfg,
                                         label_latents=self._label_latents(arrays))
        else:
            maxes = calibrate_int8_maxes(pn, ts["model_state"], P_f, self.pn_cfg,
                                         label_embeddings=arrays["label_embeddings"])
        scales = tuple(float(m) * margin / 127.0 for m in maxes.cpu().tolist())
        self.pn_cfg = dataclasses.replace(self.pn_cfg, int8_act_scales=scales)
        self._eval_step = self._make_eval_step()
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
        self._eval_step = self._make_eval_step()
        self._int8_scales_auto = False

    # ---------------- eval label-latent precompute ----------------

    def _latents_eligible(self, batcher) -> bool:
        """The label layout is batch-invariant iff no per-batch label
        re-selection happens and no text tower embeds the labels: then W_l
        projects the matrix once per evaluation."""
        ds = batcher.ds
        return (
            self.text_cfg is None
            and self.pn_cfg.label_embedding_pooling_method != "all"
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
            arrays = self._place(batch_to_device_dict(batch, self.device), label_matrix, batch)
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
        ``EvalMetrics.compute()`` dict, ``loss`` (the mean of the per-batch
        masked losses, with a ``loss_fn``) and seqs/s and pairs/s; with
        ``threshold_sweep`` (candidate thresholds) also ``"threshold"``:
        (the best threshold by ``decision_th_metric_name``, its score);
        ``"paths"`` and ``"embeddings_path"`` for what ``save_results`` and
        ``save_embeddings`` wrote.  ``compute_metrics=False`` accumulates
        no metrics and reads no logits back (the sweep-only pass of
        :meth:`find_optimal_threshold`).  The JAX signature and refusals."""
        ds = dataset if dataset is not None else batcher.ds
        num_labels = ds.num_labels
        represented = (np.asarray(ds.represented_vocabulary_mask)
                       if only_represented_labels else None)
        sample_size = getattr(batcher, "label_sample_size", None)
        fixed_subset = (sample_size is not None and sample_size < num_labels
                        and not getattr(batcher, "shuffle_labels", False))
        varying_subset = (_is_grid(batcher) or getattr(batcher, "in_batch_sampling", False)
                          or (sample_size is not None and sample_size < num_labels
                              and getattr(batcher, "shuffle_labels", False)))
        subset = fixed_subset or varying_subset
        if subset and represented is not None:
            raise ValueError("label-subsampled evaluation cannot be combined with "
                             "--only-represented-labels")
        if subset and save_results:
            raise ValueError("label-subsampled evaluation cannot export full-vocabulary "
                             "prediction results; disable label sampling or save_results")
        if subset and normalize_probabilities:
            raise ValueError("label-subsampled evaluation cannot apply GO-DAG probability "
                             "normalization (the child-index table spans the full "
                             "vocabulary); disable label sampling or normalization")
        if varying_subset and not self.cfg.estimate_map:
            raise ValueError("per-batch-varying label subsets (shuffled/in-batch/grid "
                             "sampling) require ESTIMATE_MAP=True: exact AUPRC cannot "
                             "accumulate columns that change every batch")
        if not compute_metrics and (save_results or save_embeddings
                                    or normalize_probabilities or represented is not None):
            raise ValueError("compute_metrics=False is the sweep-only fast path; it "
                             "cannot export results/embeddings or slice labels")
        if threshold_sweep is not None and subset:
            raise ValueError("threshold sweep requires full-vocabulary batches; "
                             "disable label sampling on the batcher")

        self.ensure_int8_calibrated(batcher)
        if fixed_subset:  # a constant column layout: metrics cover the sampled prefix
            eff_labels = int(sample_size)
        elif represented is not None:
            eff_labels = int(represented.sum())
        else:
            eff_labels = num_labels
        metrics = None
        if compute_metrics:
            metrics = EvalMetrics(
                eff_labels, threshold=self.cfg.decision_threshold,
                map_estimate=self.cfg.estimate_map,
                spill_threshold_bytes=self.cfg.eval_spill_threshold_bytes,
                spill_dir=self.cfg.eval_spill_dir,
                spill_tile_rows=self.cfg.eval_spill_tile_rows)
        # the device path: metrics accumulate on the device, no logits readback
        device_acc = None
        if (compute_metrics and self.cfg.estimate_map and not save_results
                and not save_embeddings and not normalize_probabilities
                and represented is None):
            device_acc = DeviceEvalAccumulator(eff_labels, self.cfg.decision_threshold,
                                               device=self.device)
        sweep = None
        if threshold_sweep is not None:
            threshold_sweep = np.asarray(threshold_sweep, np.float32)
            sweep = SweepCounter(threshold_sweep, num_labels, self.device)
        sweep_updates = 0
        dag_normalizer = None
        if normalize_probabilities and parenthood is not None:
            # one child-table build per evaluation, not per batch
            dag_normalizer = DagNormalizer(ds.label_vocabulary, parenthood)
        step = self._fused_eval_step(device_acc) if device_acc is not None else None
        all_logits, all_labels, all_ids = [], [], []
        emb_rows, emb_ids = [], []
        label_matrix = (self._label_matrix_for(batcher.ds)
                        if getattr(batcher, "device_label_gather", False) else None)
        # a batch-invariant label layout gathered from the resident matrix is
        # projected through W_l once; otherwise (per-batch subsets, label
        # embeddings shipped with every batch) the eval step projects each
        # batch's rows
        latents_ok = self._latents_eligible(batcher)
        latents = None
        losses: List[torch.Tensor] = []
        self.meter.reset()
        for batch_idx, batch in enumerate(batcher):
            arrays = self._place(batch_to_device_dict(batch, self.device), label_matrix, batch)
            if latents_ok and "label_rows" in arrays:
                if latents is None:
                    latents = self._label_latents(arrays)
                arrays = self._swap_in_latents(arrays, latents)
            if device_acc is not None and "label_multihots" in arrays:
                cols = device_acc.cols_for(batch.label_indices,
                                           arrays["label_multihots"].shape[1])
                out, device_acc.state = step(self.ts, arrays, device_acc.state, cols)
            else:
                out = self._eval_step(self.ts, arrays)
            if "loss" in out:
                losses.append(out["loss"])
            if sweep is not None and "label_multihots" in arrays:
                sweep.update(out["logits"], arrays["label_multihots"], arrays["example_mask"])
                sweep_updates += 1
            if (device_acc is not None and "label_multihots" in arrays) or not compute_metrics:
                self.meter.add(self._batch_valid(batch),
                               self._batch_label_width(batch, num_labels))
                continue
            # the host path: the batch's logits cross to the host once
            if save_embeddings and batch_idx % 100 == 0:
                with torch.inference_mode():
                    enc = self.ts["trainable"].get("encoder", self.ts["enc_params"])
                    emb, _ = embed_from_ids(enc, self.ts["enc_state"], arrays["aa_ids"],
                                            arrays["lengths"], self.pi_cfg)
                emb = emb.float().cpu().numpy()
                keep0 = batch.example_mask
                emb_rows.append(emb[keep0].astype(np.float16))
                emb_ids.extend([s for s, k in zip(batch.sequence_ids, keep0) if k])
            keep = batch.example_mask
            logits = out["logits"].float().cpu().numpy()[keep]
            if batch.label_mask is not None:
                logits = logits[:, batch.label_mask]
            labels = (batch.label_multihots[keep]
                      if batch.label_multihots is not None else None)
            if labels is not None and batch.label_mask is not None:
                labels = labels[:, batch.label_mask]
            ids = [s for s, k in zip(batch.sequence_ids, keep) if k]
            probs = _sigmoid(logits)
            if dag_normalizer is not None:
                probs = dag_normalizer(probs)
            full_labels = labels  # exported labels keep the full vocabulary
            if represented is not None:
                probs = probs[:, represented]
                labels = labels[:, represented] if labels is not None else None
            if labels is not None:
                metrics.update(probs, labels,
                               label_indices=batch.label_indices if varying_subset else None)
            self.meter.add(len(ids), self._batch_label_width(batch, num_labels))
            if save_results:
                all_logits.append(logits.astype(np.float16))
                if full_labels is not None:
                    all_labels.append(full_labels)
                all_ids.extend(ids)

        result: Dict[str, Any] = {}
        if sweep is not None:
            if sweep_updates == 0:
                raise ValueError("threshold sweep accumulated zero batches: the batcher "
                                 "is empty or carries no label_multihots (build it with "
                                 "return_label_multihots=True)")
            tp, fp, fn = (x.cpu().numpy().astype(np.int64) for x in sweep.counts())
            name = self.cfg.decision_th_metric_name
            scores = [confusion_metrics(tp[i], fp[i], fn[i])[name]
                      for i in range(len(threshold_sweep))]
            best = int(np.argmax(scores))
            logger.info("optimal threshold %.2f (%s=%.4f)", threshold_sweep[best], name,
                        scores[best])
            result["threshold"] = (float(threshold_sweep[best]), float(scores[best]))
        if device_acc is not None:
            device_acc.finalize_into(metrics)
        m = metrics.compute() if metrics is not None else {}
        if losses:
            m["loss"] = float(np.mean([float(x) for x in losses]))
            if not np.isfinite(m["loss"]):
                logger.error("non-finite eval loss on %s", data_split_name)
        m.update(self.meter.rates())
        logger.info("%s: %d sequences evaluated on %s", data_split_name,
                    self.meter.seqs, self.device)
        result["metrics"] = m

        if save_embeddings and emb_rows:
            os.makedirs(output_dir or ".", exist_ok=True)
            emb_path = os.path.join(
                output_dir or ".",
                f"{data_split_name}_sequence_embeddings_{self.cfg.run_name}.npz")
            np.savez_compressed(emb_path, embeddings=np.concatenate(emb_rows, axis=0),
                                sequence_ids=np.array(emb_ids))
            result["embeddings_path"] = emb_path
        if save_results and all_logits:
            results = {"logits": np.concatenate(all_logits, axis=0), "sequence_ids": all_ids}
            if all_labels:
                results["labels"] = np.concatenate(all_labels, axis=0)
            result["paths"] = save_evaluation_results(
                results, ds.label_vocabulary, self.cfg.run_name, output_dir or ".",
                data_split_name)
        return result

    def find_optimal_threshold(self, batcher, thresholds=None) -> tuple:
        """Sweep decision thresholds on validation, maximising
        ``decision_th_metric_name``: one evaluation pass that accumulates
        only the sweep counters (``evaluate(threshold_sweep=...,
        compute_metrics=False)``).  Callers that also want the validation
        metrics call ``evaluate`` with a sweep and read both from one pass."""
        if thresholds is None:
            thresholds = np.arange(0.01, 1.0, 0.01, dtype=np.float32)
        if getattr(batcher, "label_sample_size", None) or getattr(
                batcher, "in_batch_sampling", False):
            raise ValueError("find_optimal_threshold requires full-vocabulary batches; "
                             "disable label sampling on the validation batcher")
        return self.evaluate(batcher, threshold_sweep=thresholds,
                             compute_metrics=False)["threshold"]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x.astype(np.float32)))


def _fmt(m: Dict[str, float]) -> str:
    return " ".join(f"{k}={v:.4g}" for k, v in m.items() if isinstance(v, (int, float)))
