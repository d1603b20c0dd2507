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
thresholds <= p}`` (``csrc/threshold_sweep.cu``).  A batch only writes its
elements' slot codes into a ring of ``RING_ROWS`` rows (one launch); a flush
counts the ring's rows into the histogram (a block counts its 128 label
columns over all the rows in shared memory, then adds the nonzero counts;
:func:`flush_plan`) when the ring is full and before the counts are read,
and :meth:`SweepCounter.counts` turns the histogram into the same counters
with one finalize launch.  Sorted, the
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
from protnote_tpu_torch.ops.kernels import call_on_stream, kernel_function

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

MAX_THRESHOLDS = 1024  # the kernels keep the thresholds in shared memory
RING_ROWS = 256  # rows of slot codes a counter keeps before it flushes them (8 batches of 32)
CODE_BUCKETS = 1024  # probability buckets of the codes' threshold table (csrc BUCKETS)
NO_SLOT = 0xFFFF  # the code of a masked row's element (NO_SLOT)
FLUSH_COLS = 128  # label columns of a flush block (COLS)
FLUSH_CHUNK_ROWS = 255  # rows a flush block counts in bytes before it adds them (CHUNK_ROWS)
FLUSH_MAX_SLOTS = 768  # (slot, 128 columns) byte counts of a flush block: 96 KB (SLOT_BYTES)

# Launches of each K9 entry point since the process started (or since a
# caller last set them to 0).
LAUNCHES = {"update": 0, "flush": 0, "finalize": 0}
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


def codes_reference(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                    sorted_thresholds: torch.Tensor, num_labels: int) -> torch.Tensor:
    """The codes kernel in eager PyTorch: (B, L) int64 slot codes, ``k =
    #{sorted thresholds <= p}`` (0 for a NaN p) plus T + 1 for a negative,
    ``NO_SLOT`` for a masked row."""
    check_inputs(logits, labels, mask, num_labels)
    T = sorted_thresholds.shape[0]
    p = probabilities(logits[:, :num_labels])
    k = torch.searchsorted(sorted_thresholds.to(p.device, torch.float32), p.contiguous(),
                           right=True)
    k = torch.where(torch.isnan(p), torch.zeros_like(k), k)
    slot = torch.where(labels[:, :num_labels] > 0, 0, T + 1) + k
    return torch.where(mask[:, None] > 0, slot, torch.full_like(slot, NO_SLOT))


def flush_reference(hist: torch.Tensor, codes: torch.Tensor, num_labels: int) -> torch.Tensor:
    """The flush kernel in eager PyTorch: every code but ``NO_SLOT`` of the
    (rows, >= L) ``codes`` adds one to ``hist[code * L + column]`` (int32, in
    place)."""
    c = codes[:, :num_labels].long() & 0xFFFF
    cols = torch.arange(num_labels, device=c.device).expand_as(c)
    keys = (c * num_labels + cols)[c != NO_SLOT]
    hist += torch.bincount(keys, minlength=hist.numel()).to(torch.int32)
    return hist


# ----------------------------------------------------------------------
# CUDA kernels (csrc/threshold_sweep.cu)


def flush_plan(num_thresholds: int) -> Tuple[int, int]:
    """``(range, ranges)``: the flush's histogram slots ``2 (T + 1)`` cut
    into ``ranges`` runs of ``range`` slots, each a block's byte counts in
    shared memory (blockIdx.y; every range reads the codes again).  One
    range up to T = 383; T = 1,024 takes 3 of 684."""
    slots = 2 * (num_thresholds + 1)
    ranges = -(-slots // FLUSH_MAX_SLOTS)
    size = -(-slots // ranges)
    return size, -(-slots // size)


def code_pitch(num_labels: int) -> int:
    """The row pitch of the slot codes: L rounded up to 8 (16-byte rows)."""
    return -(-num_labels // 8) * 8


_P, _I = ctypes.c_void_p, ctypes.c_int
_CODES_ARGS = [_P] * 4 + [_I] * 5 + [_P, _P]
_FLUSH_ARGS = [_P] + [_I] * 5 + [_P, _P]
_FINALIZE_ARGS = [_P, _P, _I, _I] + [_P] * 4


def _fn(symbol: str, argtypes):
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
    """One batch into the kernel's histogram (2 x (T + 1) x L int32): its
    codes into a buffer of its own, then a flush (two launches; a
    :class:`SweepCounter` flushes many batches' codes at once)."""
    T = sorted_thresholds.shape[0]
    if hist.numel() != 2 * (T + 1) * num_labels:
        raise ValueError(f"hist has {hist.numel()} counts, not 2 x {T + 1} x {num_labels}")
    if not 0 < T <= MAX_THRESHOLDS:
        raise ValueError(f"the sweep kernels take 1-{MAX_THRESHOLDS} thresholds, not {T}")
    device = _check_cuda("threshold_sweep_update", [hist, sorted_thresholds],
                         [torch.int32, torch.float32])
    pitch = code_pitch(num_labels)
    codes = torch.empty(max(logits.shape[0], 1), pitch, dtype=torch.int16, device=device)
    rows = _codes(codes.data_ptr(), pitch, sorted_thresholds.data_ptr(), T, device.index,
                  logits, labels, mask, num_labels)
    _flush(codes.data_ptr(), rows, num_labels, pitch, T, hist.data_ptr(), device.index)


def _codes(codes_ptr: int, pitch: int, sorted_ptr: int, T: int, index: int,
           logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
           num_labels: int) -> int:
    """One batch's slot codes into the rows at ``codes_ptr``, with the
    sorted thresholds already checked (on card ``index``): only the batch's
    tensors are checked here, in one expression of the cheapest calls
    (``get_device``: an int, no device object).  Returns the batch's rows."""
    f32, shape = torch.float32, logits.shape
    if (logits.dtype != f32 or labels.dtype != f32 or mask.dtype != f32
            or logits.get_device() != index or labels.get_device() != index
            or mask.get_device() != index or not logits.is_contiguous()
            or not labels.is_contiguous() or not mask.is_contiguous()):
        raise ValueError(f"threshold_sweep_update: expected contiguous {f32} on cuda:{index}, "
                         f"got {[(t.dtype, str(t.device)) for t in (logits, labels, mask)]}")
    if len(shape) != 2 or labels.shape != shape or mask.shape[0] != shape[0] or \
            mask.dim() != 1 or shape[1] < num_labels:
        check_inputs(logits, labels, mask, num_labels)  # raises with the shapes
    _raise_on(call_on_stream(index, _fn("threshold_sweep_codes", _CODES_ARGS),
                             logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), sorted_ptr,
                             shape[0], shape[1], num_labels, T, pitch, codes_ptr),
              "threshold_sweep_codes")
    _count("update")
    return shape[0]


def _flush(codes_ptr: int, rows: int, num_labels: int, pitch: int, T: int, hist_ptr: int,
           index: int) -> None:
    """``rows`` rows of codes into the histogram, one launch."""
    _raise_on(call_on_stream(index, _fn("threshold_sweep_flush", _FLUSH_ARGS), codes_ptr, rows,
                             num_labels, pitch, T, flush_plan(T)[0], hist_ptr),
              "threshold_sweep_flush")
    _count("flush")


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
    _raise_on(call_on_stream(device, _fn("threshold_sweep_finalize", _FINALIZE_ARGS),
                             hist.data_ptr(), order.data_ptr(), L, T,
                             *(o.data_ptr() for o in out)), "threshold_sweep_finalize")
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
            self.pitch = code_pitch(self.num_labels)
            self.index = self.hist.get_device()
            self._sorted = (self.sorted.data_ptr(), T)  # what every batch's launch passes
            # the ring of slot codes (made at the first batch), its rows, the
            # rows waiting for a flush
            self.codes, self.capacity, self.pending = None, 0, 0
        else:
            raise ValueError(f"no threshold sweep for device {self.device}")

    def update(self, logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> None:
        """Add one batch: logits and labels (B, >= L), mask (B,)."""
        if self.device.type == "cpu":
            if logits.device.type != "cpu":
                raise ValueError(f"logits on {logits.device}, sweep on {self.device}")
            count_reference(self.acc, logits, labels, mask, self.thresholds)
            return
        rows = logits.shape[0]
        if rows > self.capacity:
            self.flush()
            self.capacity = max(RING_ROWS, rows)
            self.codes = torch.empty(self.capacity, self.pitch, dtype=torch.int16,
                                     device=self.device)
            self._codes_ptr = self.codes.data_ptr()
        elif self.pending + rows > self.capacity:
            self.flush()
        self.pending += _codes(self._codes_ptr + 2 * self.pending * self.pitch, self.pitch,
                               *self._sorted, self.index, logits, labels, mask, self.num_labels)

    def flush(self) -> None:
        """Count the ring's waiting rows into the histogram (CUDA; the
        counts read it after a flush)."""
        if self.device.type == "cuda" and self.pending:
            _flush(self._codes_ptr, self.pending, self.num_labels, self.pitch, self._sorted[1],
                   self.hist.data_ptr(), self.index)
            self.pending = 0

    def counts(self) -> Counts:
        """(tp, fp, fn), each (T, L) int32 on the sweep's device."""
        if self.device.type == "cpu":
            return self.acc
        self.flush()
        return finalize_cuda(self.hist, self.order, self.num_labels,
                             self.thresholds.shape[0])
