"""The decision-threshold sweep counter (K9): per-label tp/fp/fn at each of
T candidate thresholds, over every batch of an evaluation.

Port of ``protnote_tpu/train/trainer.py:Trainer._sweep_count_fn``: for each
threshold ``th`` (``lax.map`` there), with the probability ``p = 1 / (1 +
exp(-x))`` in float32 (XLA lowers ``jax.nn.sigmoid`` to exactly that
expression; only the exponential may differ by an ulp between XLA, the CPU
and CUDA), ``t = label > 0`` and ``valid = mask[b] > 0``::

    pred = p >= th & valid
    tp += sum_b(pred & t),  fp += sum_b(pred & ~t),  fn += sum_b(~pred & t & valid)

into (T, L) int32 counters, columns at or past L (label padding) dropped.

:class:`SweepCounter` dispatches on the device it is given: on the CPU it
keeps the (T, L) counters and adds each batch with the plain version
(:func:`count_reference`, the ``lax.map`` loop); on a CUDA device it keeps
the kernel's state, a histogram of every valid element over ``k = #{sorted
thresholds <= p}`` (``csrc/threshold_sweep.cu``), and :meth:`SweepCounter.counts`
turns it into the same counters with one finalize launch.  Sorted, the
thresholds a probability reaches are a prefix, so the two agree exactly,
except for an element within an ulp of a threshold.  Nothing falls back from
the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from protnote_tpu_torch.ops.eval_accumulator import probabilities

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

MAX_THRESHOLDS = 1024  # the kernels keep the thresholds in shared memory

# Launches of each K9 entry point since the process started (or since a
# caller last set them to 0).
LAUNCHES = {"update": 0, "finalize": 0}
_launch_lock = threading.Lock()


def check_inputs(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 num_labels: int) -> None:
    if logits.dim() != 2 or tuple(labels.shape) != tuple(logits.shape):
        raise ValueError(f"logits {tuple(logits.shape)} and labels "
                         f"{tuple(labels.shape)} must be one (B, L) shape")
    if tuple(mask.shape) != (logits.shape[0],):
        raise ValueError(f"mask {tuple(mask.shape)} vs {logits.shape[0]} rows")
    if logits.shape[1] < num_labels:
        raise ValueError(f"{logits.shape[1]} columns for {num_labels} labels")


# ----------------------------------------------------------------------
# plain PyTorch versions


def count_reference(acc: Counts, logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """The JAX count in eager PyTorch: one compare-reduce a threshold, added
    into ``acc = (tp, fp, fn)`` (T, L) int32 in place."""
    L = acc[0].shape[1]
    check_inputs(logits, labels, mask, L)
    probs = probabilities(logits)
    t = labels > 0
    valid = mask[:, None] > 0
    th = thresholds.to(device=logits.device, dtype=torch.float32)
    for i in range(th.shape[0]):
        pred = (probs >= th[i]) & valid
        for a, hit in zip(acc, (pred & t, pred & ~t, ~pred & t & valid)):
            a[i] += hit.sum(0, dtype=torch.int32)[:L]
    return acc


def finalize_reference(hist: torch.Tensor, order: torch.Tensor, num_labels: int,
                       num_thresholds: int) -> Counts:
    """The kernel's finalize in eager PyTorch: the (T, L) counts of its
    histogram (``order``: the stable argsort of the thresholds)."""
    T, L = num_thresholds, num_labels
    h = hist.view(2, T + 1, L).long()
    above = h.flip(1).cumsum(1).flip(1)[:, 1:]  # sum over k > i, sorted order i
    tp_s, fp_s = above[0], above[1]
    fn_s = h[0].sum(0, keepdim=True) - tp_s
    out = []
    for sorted_counts in (tp_s, fp_s, fn_s):
        c = torch.empty_like(sorted_counts)
        c[order.long()] = sorted_counts
        out.append(c.to(torch.int32))
    return tuple(out)


# ----------------------------------------------------------------------
# CUDA kernels (csrc/threshold_sweep.cu)


_P, _I = ctypes.c_void_p, ctypes.c_int
_UPDATE_ARGS = [_P] * 4 + [_I] * 4 + [_P, _P]
_FINALIZE_ARGS = [_P, _P, _I, _I] + [_P] * 4


def _fn(symbol: str, argtypes):
    from protnote_tpu_torch.ops.kernels import kernel_function

    return kernel_function("threshold_sweep", symbol, argtypes)


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _check_cuda(name: str, tensors, dtypes) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"the CUDA threshold sweep needs CUDA tensors, not {device}")
    for t, dt in zip(tensors, dtypes):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} on {device}, got "
                             f"{t.dtype} on {t.device}")
    return device


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def update_cuda(hist: torch.Tensor, sorted_thresholds: torch.Tensor, logits: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor, num_labels: int) -> None:
    """One batch into the kernel's histogram (2 x (T + 1) x L int32)."""
    check_inputs(logits, labels, mask, num_labels)
    T = sorted_thresholds.shape[0]
    if hist.numel() != 2 * (T + 1) * num_labels:
        raise ValueError(f"hist has {hist.numel()} counts, not 2 x {T + 1} x {num_labels}")
    if not 0 < T <= MAX_THRESHOLDS:
        raise ValueError(f"the sweep kernels take 1-{MAX_THRESHOLDS} thresholds, not {T}")
    f32 = torch.float32
    device = _check_cuda("threshold_sweep_update",
                         [logits, labels, mask, sorted_thresholds, hist],
                         [f32, f32, f32, f32, torch.int32])
    B, Lb = logits.shape
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        _raise_on(_fn("threshold_sweep_update", _UPDATE_ARGS)(
            logits.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            sorted_thresholds.data_ptr(), B, Lb, num_labels, T, hist.data_ptr(), stream),
            "threshold_sweep_update")
        _count("update")


def finalize_cuda(hist: torch.Tensor, order: torch.Tensor, num_labels: int,
                  num_thresholds: int) -> Counts:
    """The (T, L) int32 counts of the kernel's histogram, one launch."""
    T, L = num_thresholds, num_labels
    if hist.numel() != 2 * (T + 1) * L or tuple(order.shape) != (T,):
        raise ValueError(f"hist {hist.numel()} / order {tuple(order.shape)} vs "
                         f"{T} thresholds x {L} labels")
    if not 0 < T <= MAX_THRESHOLDS:
        raise ValueError(f"the sweep kernels take 1-{MAX_THRESHOLDS} thresholds, not {T}")
    device = _check_cuda("threshold_sweep_finalize", [hist, order],
                         [torch.int32, torch.int32])
    out = tuple(torch.empty(T, L, dtype=torch.int32, device=device) for _ in range(3))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        _raise_on(_fn("threshold_sweep_finalize", _FINALIZE_ARGS)(
            hist.data_ptr(), order.data_ptr(), L, T, *(o.data_ptr() for o in out),
            stream), "threshold_sweep_finalize")
        _count("finalize")
    return out


# ----------------------------------------------------------------------
# dispatch


class SweepCounter:
    """tp/fp/fn at each of ``thresholds`` for ``num_labels`` labels, summed
    over :meth:`update` calls on ``device`` (CPU: the plain counters; CUDA:
    the kernel's histogram)."""

    def __init__(self, thresholds, num_labels: int, device):
        self.device = torch.device(device)
        self.num_labels = int(num_labels)
        self.thresholds = torch.from_numpy(
            np.ascontiguousarray(thresholds, dtype=np.float32)).to(self.device)
        T = self.thresholds.shape[0]
        if self.device.type == "cpu":
            self.acc = tuple(torch.zeros(T, self.num_labels, dtype=torch.int32)
                             for _ in range(3))
        elif self.device.type == "cuda":
            if not 0 < T <= MAX_THRESHOLDS:
                raise ValueError(f"the sweep kernels take 1-{MAX_THRESHOLDS} "
                                 f"thresholds, not {T}")
            self.sorted, order = torch.sort(self.thresholds, stable=True)
            self.order = order.to(torch.int32)
            self.hist = torch.zeros(2 * (T + 1) * self.num_labels, dtype=torch.int32,
                                    device=self.device)
        else:
            raise ValueError(f"no threshold sweep for device {self.device}")

    def update(self, logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> None:
        """Add one batch: logits and labels (B, >= L), mask (B,)."""
        if logits.device.type != self.device.type:
            raise ValueError(f"logits on {logits.device}, sweep on {self.device}")
        if self.device.type == "cpu":
            count_reference(self.acc, logits, labels, mask, self.thresholds)
        else:
            update_cuda(self.hist, self.sorted, logits, labels, mask, self.num_labels)

    def counts(self) -> Counts:
        """(tp, fp, fn), each (T, L) int32 on the sweep's device."""
        if self.device.type == "cpu":
            return self.acc
        return finalize_cuda(self.hist, self.order, self.num_labels,
                             self.thresholds.shape[0])
