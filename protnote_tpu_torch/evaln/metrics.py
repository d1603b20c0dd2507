"""Streaming evaluation metrics: the ``ESTIMATE_MAP`` path of the port.

Port of the binned-AUPRC half of ``protnote_tpu/evaln/metrics.py``.  The
host classes below (:func:`confusion_metrics`, :class:`ConfusionAccumulator`,
:class:`SamplewiseAccumulator`, :class:`BinnedAUPRC`,
:class:`_PrecomputedAUPRC`, :class:`EvalMetrics`) are numpy and are copies
of the JAX package's, not imports: that module imports jax whenever jax is
installed, and the port never does.  The tests hold each copy against its
original.

:class:`DeviceEvalAccumulator` keeps the confusion counts, samplewise sums
and per-label histograms on the device of the logits; its update and
finalize are the K3 kernels (:mod:`protnote_tpu_torch.ops.eval_accumulator`).
The exact host AUPRC (``ESTIMATE_MAP: False``, ``ExactAUPRC``) is not ported
yet (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from protnote_tpu_torch.ops import eval_accumulator as k3

EXACT_AUPRC_LATER = ("ESTIMATE_MAP: False (the exact host AUPRC, ExactAUPRC) is not "
                     "ported yet (ROADMAP.md queue 1, item 3); set ESTIMATE_MAP True")


# ----------------------------------------------------------------------
# Threshold-based confusion counters


class ConfusionAccumulator:
    """Per-label tp/fp/fn at a fixed decision threshold."""

    def __init__(self, num_labels: int, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = np.zeros(num_labels, dtype=np.int64)
        self.fp = np.zeros(num_labels, dtype=np.int64)
        self.fn = np.zeros(num_labels, dtype=np.int64)

    def update(self, probs: np.ndarray, targets: np.ndarray,
               mask: Optional[np.ndarray] = None,
               label_indices: Optional[np.ndarray] = None) -> None:
        """``label_indices``: full-vocabulary column index of each supplied
        column, for batches scoring a label subset."""
        pred = probs >= self.threshold  # >= : reference semantics
        t = targets.astype(bool)
        if mask is not None:
            keep = mask.astype(bool)
            pred = pred[keep]
            t = t[keep]
        tp = np.sum(pred & t, axis=0)
        fp = np.sum(pred & ~t, axis=0)
        fn = np.sum(~pred & t, axis=0)
        if label_indices is None:
            self.tp += tp
            self.fp += fp
            self.fn += fn
        else:
            np.add.at(self.tp, label_indices, tp)
            np.add.at(self.fp, label_indices, fp)
            np.add.at(self.fn, label_indices, fn)

    def merge_counts(self, tp: np.ndarray, fp: np.ndarray, fn: np.ndarray) -> None:
        """Fold in counters accumulated on the device."""
        self.tp += tp.astype(np.int64)
        self.fp += fp.astype(np.int64)
        self.fn += fn.astype(np.int64)

    def compute(self) -> Dict[str, float]:
        return confusion_metrics(self.tp, self.fp, self.fn)


def confusion_metrics(tp: np.ndarray, fp: np.ndarray, fn: np.ndarray) -> Dict[str, float]:
    """micro/macro/weighted precision, recall, F1 from per-label counters.

    torchmetrics multilabel semantics: macro averages include all labels
    (labels with no positives and no predictions contribute 0)."""
    eps = 1e-12
    out: Dict[str, float] = {}
    TP, FP, FN = tp.sum(), fp.sum(), fn.sum()
    p_micro = TP / max(TP + FP, 1)
    r_micro = TP / max(TP + FN, 1)
    out["precision_micro"] = float(p_micro)
    out["recall_micro"] = float(r_micro)
    out["f1_micro"] = float(2 * p_micro * r_micro / max(p_micro + r_micro, eps))
    p = tp / np.maximum(tp + fp, 1)
    r = tp / np.maximum(tp + fn, 1)
    f1 = 2 * p * r / np.maximum(p + r, eps)
    out["precision_macro"] = float(p.mean())
    out["recall_macro"] = float(r.mean())
    out["f1_macro"] = float(f1.mean())
    support = tp + fn
    w = support / max(support.sum(), 1)
    out["precision_weighted"] = float((p * w).sum())
    out["recall_weighted"] = float((r * w).sum())
    out["f1_weighted"] = float((f1 * w).sum())
    return out


# ----------------------------------------------------------------------
# Samplewise metrics


class SamplewiseAccumulator:
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.precision_sum = 0.0
        self.precision_count = 0
        self.recall_sum = 0.0
        self.recall_count = 0
        self.covered = 0
        self.total = 0

    def update(self, probs: np.ndarray, targets: np.ndarray,
               mask: Optional[np.ndarray] = None) -> None:
        if mask is not None:
            keep = mask.astype(bool)
            probs, targets = probs[keep], targets[keep]
        pred = probs >= self.threshold  # >= : reference semantics
        t = targets.astype(bool)
        tp = (pred & t).sum(axis=1)
        # precision only over samples with >=1 positive prediction
        has_pred = pred.any(axis=1)
        if has_pred.any():
            p = tp[has_pred] / pred[has_pred].sum(axis=1)
            self.precision_sum += float(p.sum())
            self.precision_count += int(has_pred.sum())
        denom = np.maximum(t.sum(axis=1), 1)
        r = tp / denom
        self.recall_sum += float(r.sum())
        self.recall_count += probs.shape[0]
        self.covered += int(has_pred.sum())
        self.total += probs.shape[0]

    def compute(self) -> Dict[str, float]:
        precision = (
            self.precision_sum / self.precision_count if self.precision_count else 0.0
        )
        recall = self.recall_sum / max(self.recall_count, 1)
        f1 = 2 * precision * recall / (precision + recall + 1e-6)
        return {
            "precision_samplewise": precision,
            "recall_samplewise": recall,
            "f1_samplewise": f1,
            "coverage_samplewise": self.covered / max(self.total, 1),
        }


# ----------------------------------------------------------------------
# Binned AUPRC (host)


class BinnedAUPRC:
    """Histogram-based AP estimate: per-label histograms of positive and
    negative counts over ``num_bins`` equal-width probability bins."""

    def __init__(self, num_labels: int, num_bins: int = 512):
        self.num_labels = num_labels
        self.num_bins = num_bins
        self.pos = np.zeros((num_labels, num_bins), dtype=np.int64)
        self.neg = np.zeros((num_labels, num_bins), dtype=np.int64)

    def merge(self, pos: np.ndarray, neg: np.ndarray) -> None:
        self.pos += np.asarray(pos, dtype=np.int64)
        self.neg += np.asarray(neg, dtype=np.int64)

    def update(self, probs: np.ndarray, targets: np.ndarray,
               mask: Optional[np.ndarray] = None,
               label_indices: Optional[np.ndarray] = None) -> None:
        bins = np.clip((probs * self.num_bins).astype(np.int64), 0, self.num_bins - 1)
        t = targets.astype(bool)
        if mask is not None:
            keep = mask.astype(bool)
            bins, t = bins[keep], t[keep]
        cols = (
            np.arange(bins.shape[1], dtype=np.int64)
            if label_indices is None else np.asarray(label_indices, np.int64)
        )
        flat = (cols[None, :] * self.num_bins + bins).reshape(-1)
        ft = t.reshape(-1)
        size = self.num_labels * self.num_bins
        self.pos += np.bincount(flat[ft], minlength=size).reshape(self.pos.shape)
        self.neg += np.bincount(flat[~ft], minlength=size).reshape(self.neg.shape)

    @staticmethod
    def _ap_from_hist(pos: np.ndarray, neg: np.ndarray) -> np.ndarray:
        # descending threshold: cumulate from the top bin down
        tp = np.cumsum(pos[..., ::-1], axis=-1)
        fp = np.cumsum(neg[..., ::-1], axis=-1)
        n_pos = tp[..., -1:]
        precision = tp / np.maximum(tp + fp, 1)
        recall = tp / np.maximum(n_pos, 1)
        recall_prev = np.concatenate(
            [np.zeros_like(recall[..., :1]), recall[..., :-1]], axis=-1
        )
        ap = np.sum((recall - recall_prev) * precision, axis=-1)
        return np.where(n_pos[..., 0] > 0, ap, np.nan)

    def compute(self) -> Dict[str, float]:
        micro = self._ap_from_hist(self.pos.sum(0), self.neg.sum(0))
        per_label = self._ap_from_hist(self.pos, self.neg)
        macro = float(np.nanmean(per_label)) if np.any(~np.isnan(per_label)) else float("nan")
        return {"map_micro": float(micro), "map_macro": macro}


class _PrecomputedAUPRC:
    """AP already reduced on the device by ``finalize_into``; satisfies the
    ``EvalMetrics.auprc`` compute() contract without holding histograms."""

    def __init__(self, micro: float, macro: float):
        self._result = {"map_micro": micro, "map_macro": macro}

    def compute(self) -> Dict[str, float]:
        return dict(self._result)


# ----------------------------------------------------------------------
# All-on-device eval accumulation (ESTIMATE_MAP path, K3)


class DeviceEvalAccumulator:
    """Confusion counts, samplewise sums and binned-AUPRC histograms on the
    device of the logits: one K3 update per eval batch, the logits never
    leave the device, and :meth:`finalize_into` reads back only the per-label
    APs and the small counters.

    ``threshold=None`` mirrors ``EvalMetrics(threshold=None)``: the counters
    still accumulate at a 0.5 placeholder, and ``finalize_into`` drops them
    because such an ``EvalMetrics`` holds no confusion or samplewise
    accumulators."""

    def __init__(self, num_labels: int, threshold: Optional[float] = None,
                 num_bins: int = 512, device="cpu"):
        self.num_labels = num_labels
        self.threshold = None if threshold is None else float(threshold)
        self.num_bins = num_bins
        self.device = torch.device(device)
        self.state = k3.init_state(num_labels, num_bins, self.device)
        th = 0.5 if self.threshold is None else self.threshold
        nb = num_bins

        def update_fn(state, logits, targets, example_mask, label_mask, cols):
            """Add one batch into ``state`` in place (and return it)."""
            return k3.update(state, logits, targets, example_mask, label_mask,
                             cols, th, nb)

        self.update_fn = update_fn

    def cols_for(self, label_indices, L: int) -> Optional[torch.Tensor]:
        """State rows of a batch's columns, or None when the batch's L
        columns are state rows 0..L-1 (any full-vocabulary eval).  Padded
        subset slots point at row 0, where their masked elements add
        nothing."""
        if label_indices is None:
            if L == self.num_labels:
                return None
            return torch.arange(L, dtype=torch.int32, device=self.device)
        li = np.asarray(label_indices)
        if li.size == L and L == self.num_labels and np.array_equal(li, np.arange(li.size)):
            return None
        cols = li.astype(np.int32)
        if cols.size < L:
            cols = np.pad(cols, (0, L - cols.size))
        return torch.from_numpy(cols).to(self.device)

    def update(self, logits, targets, example_mask, label_mask=None,
               label_indices=None) -> None:
        L = logits.shape[1]
        if label_mask is None:
            label_mask = torch.ones(L, dtype=torch.float32, device=logits.device)
        cols = self.cols_for(label_indices, L)
        self.update_fn(self.state, logits, targets, example_mask, label_mask, cols)

    def _merge_counters(self, metrics: "EvalMetrics") -> None:
        s = {k: v.cpu().numpy() for k, v in self.state.items() if k != "hist"}
        if metrics.confusion is not None:
            metrics.confusion.merge_counts(s["tp"], s["fp"], s["fn"])
        if metrics.samplewise is not None:
            sw = metrics.samplewise
            sw.precision_sum += float(s["precision_sum"])
            sw.precision_count += int(s["precision_count"])
            sw.recall_sum += float(s["recall_sum"])
            sw.recall_count += int(s["recall_count"])
            sw.covered += int(s["covered"])
            sw.total += int(s["recall_count"])

    def finalize_into(self, metrics: "EvalMetrics") -> None:
        """Like :meth:`merge_into`, but AP is computed on the device: only
        the per-label APs, micro and macro AP and the counters cross to the
        host, not the 2 x L x num_bins histograms."""
        _, _, out = k3.finalize(self.state["hist"], self.num_labels, self.num_bins)
        micro, macro = (float(v) for v in out.cpu())
        self._merge_counters(metrics)
        metrics.auprc = _PrecomputedAUPRC(micro, macro)

    def merge_into(self, metrics: "EvalMetrics") -> None:
        """Fold the whole state, histograms included, into host metrics."""
        if not isinstance(metrics.auprc, BinnedAUPRC):
            raise ValueError("device accumulation produces binned AUPRC; "
                             "construct EvalMetrics with map_estimate=True")
        self._merge_counters(metrics)
        hist = self.state["hist"].cpu().numpy()
        half = self.num_labels * self.num_bins
        metrics.auprc.merge(hist[:half].reshape(metrics.auprc.pos.shape),
                            hist[half:].reshape(metrics.auprc.neg.shape))


# ----------------------------------------------------------------------
# Collection facade


class EvalMetrics:
    """The metric accumulators behind one update()/compute() pair
    (``map_estimate=True`` only: binned AUPRC)."""

    def __init__(self, num_labels: int, threshold: Optional[float] = 0.5,
                 map_estimate: bool = False, num_bins: int = 512):
        if not map_estimate:
            raise NotImplementedError(EXACT_AUPRC_LATER)
        self.num_labels = num_labels
        self.threshold = threshold
        self.confusion = (
            ConfusionAccumulator(num_labels, threshold) if threshold is not None else None
        )
        self.samplewise = (
            SamplewiseAccumulator(threshold) if threshold is not None else None
        )
        self.auprc = BinnedAUPRC(num_labels, num_bins)

    def update(self, probs: np.ndarray, targets: np.ndarray,
               mask: Optional[np.ndarray] = None,
               label_indices: Optional[np.ndarray] = None) -> None:
        probs = np.asarray(probs)
        targets = np.asarray(targets)
        if self.confusion is not None:
            self.confusion.update(probs, targets, mask, label_indices)
        if self.samplewise is not None:
            self.samplewise.update(probs, targets, mask)
        self.auprc.update(probs, targets, mask, label_indices=label_indices)

    def compute(self, prefix: Optional[str] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.confusion is not None:
            out.update(self.confusion.compute())
        if self.samplewise is not None:
            out.update(self.samplewise.compute())
        out.update(self.auprc.compute())
        if prefix:
            out = {f"{prefix}_{k}": v for k, v in out.items()}
        return out
