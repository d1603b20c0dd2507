"""On-device evaluation accumulator (K3): the batch update and the AP
finalize of ``DeviceEvalAccumulator``.

Port of ``protnote_tpu/evaln/metrics.py:DeviceEvalAccumulator.update_fn``
and ``finalize_into._finalize``.  The state is the JAX layout, a dict of
tensors on one device: ``tp``/``fp``/``fn`` (L,) int32, ``hist``
(2 * L * nb,) int32 (all positive histograms, then all negative ones),
``precision_sum``/``recall_sum`` () float32 and ``precision_count``/
``recall_count``/``covered`` () int32.  PyTorch tensors are mutable, so
:func:`update` adds into the state in place (and returns it), where the JAX
function returned a new state.

:func:`update` and :func:`finalize` dispatch on the device: CPU tensors take
the plain PyTorch versions (:func:`update_reference`,
:func:`finalize_reference`), CUDA tensors the hand-written kernels of
``csrc/eval_accumulator.cu``; input the kernels do not take raises, and
nothing falls back from one to the other.

Both versions compute the probability as ``1 / (1 + exp(-x))`` in float32,
bin it as ``clip(int(p * nb), 0, nb - 1)`` and compare ``p >= th``.  The
exponentials of the CPU, of XLA and of CUDA can differ by an ulp, so an
element within an ulp of a bin edge or of the threshold may land on the
other side; the tests draw their inputs away from those edges.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

State = Dict[str, torch.Tensor]

MAX_ROWS = (1 << 15) - 1  # the JAX update's packed int32 counts allow 32767
MAX_BINS = 1024  # the finalize kernel runs one thread per bin

# Launches of each K3 entry point since the process started (or since a
# caller last set them to 0).
LAUNCHES = {"update": 0, "row_tail": 0, "finalize": 0}
_launch_lock = threading.Lock()


def init_state(num_labels: int, num_bins: int, device) -> State:
    """A zero state on ``device``."""
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
    return {
        "tp": zi(num_labels), "fp": zi(num_labels), "fn": zi(num_labels),
        "hist": zi(2 * num_labels * num_bins),
        "precision_sum": torch.zeros((), dtype=torch.float32, device=device),
        "precision_count": zi(),
        "recall_sum": torch.zeros((), dtype=torch.float32, device=device),
        "recall_count": zi(),
        "covered": zi(),
    }


def probabilities(logits: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` in float32: the expression the kernel uses."""
    return 1.0 / (1.0 + torch.exp(-logits.float()))


def check_inputs(state: State, logits: torch.Tensor, targets: torch.Tensor,
                 example_mask: torch.Tensor, label_mask: torch.Tensor,
                 cols: Optional[torch.Tensor], num_bins: int) -> None:
    """Raise on input either version does not take."""
    if logits.dim() != 2:
        raise ValueError(f"logits must be (B, L), not {tuple(logits.shape)}")
    B, Lb = logits.shape
    if B > MAX_ROWS:
        raise ValueError(
            f"batch dimension {B} overflows the packed int32 pos/valid "
            f"histogram counts (max {MAX_ROWS} rows per update); split the batch")
    L = state["tp"].shape[0]
    if state["hist"].numel() != 2 * L * num_bins:
        raise ValueError(f"hist has {state['hist'].numel()} counts, not "
                         f"2 x {L} labels x {num_bins} bins")
    if tuple(targets.shape) != (B, Lb):
        raise ValueError(f"targets {tuple(targets.shape)} vs logits {(B, Lb)}")
    if tuple(example_mask.shape) != (B,) or tuple(label_mask.shape) != (Lb,):
        raise ValueError(f"masks {tuple(example_mask.shape)}, "
                         f"{tuple(label_mask.shape)} vs logits {(B, Lb)}")
    if cols is None:
        if Lb > L:
            raise ValueError(f"{Lb} columns without cols exceed the {L} state rows")
    elif tuple(cols.shape) != (Lb,):
        raise ValueError(f"cols {tuple(cols.shape)} vs {Lb} columns")


# ----------------------------------------------------------------------
# plain PyTorch versions


def update_reference(state: State, logits: torch.Tensor, targets: torch.Tensor,
                     example_mask: torch.Tensor, label_mask: torch.Tensor,
                     cols: Optional[torch.Tensor], threshold: float,
                     num_bins: int) -> State:
    """The JAX ``update_fn`` in eager PyTorch, adding into ``state``."""
    check_inputs(state, logits, targets, example_mask, label_mask, cols, num_bins)
    nb = num_bins
    L = state["tp"].shape[0]
    probs = probabilities(logits)
    valid = (example_mask[:, None] > 0) & (label_mask[None, :] > 0)
    t = (targets > 0) & valid
    pred = (probs >= torch.tensor(threshold, dtype=torch.float32)) & valid
    incs = [(pred & t).sum(0, dtype=torch.int32), (pred & ~t).sum(0, dtype=torch.int32),
            (~pred & t).sum(0, dtype=torch.int32)]
    for name, inc in zip(("tp", "fp", "fn"), incs):
        if cols is None:
            state[name][: inc.shape[0]] += inc
        else:
            state[name].index_add_(0, cols.long(), inc)
    row_counts = torch.stack([(pred & t).sum(1, dtype=torch.int32),
                              pred.sum(1, dtype=torch.int32),
                              t.sum(1, dtype=torch.int32)], dim=1)
    row_tail_reference(state, row_counts, example_mask)
    # per-column bin counts: one bincount over (column, bin) pairs
    Lb = logits.shape[1]
    bins = (probs * nb).to(torch.int32).clamp(0, nb - 1).long()
    flat = torch.arange(Lb, device=logits.device)[None, :] * nb + bins
    pos_inc = torch.bincount(flat[t], minlength=Lb * nb).reshape(Lb, nb)
    neg_inc = torch.bincount(flat[valid & ~t], minlength=Lb * nb).reshape(Lb, nb)
    hist2d = state["hist"].view(2 * L, nb)
    if cols is None:
        hist2d[:Lb] += pos_inc.to(torch.int32)
        hist2d[L : L + Lb] += neg_inc.to(torch.int32)
    else:
        hist2d.index_add_(0, cols.long(), pos_inc.to(torch.int32))
        hist2d.index_add_(0, cols.long() + L, neg_inc.to(torch.int32))
    return state


def row_tail_reference(state: State, row_counts: torch.Tensor,
                       example_mask: torch.Tensor) -> State:
    """Fold one batch's (B, 3) int32 row counts (tp_row, pred_row, t_row,
    over valid elements) into the samplewise sums, in float32."""
    row_valid = example_mask > 0
    tp_row, pred_row, t_row = row_counts.unbind(1)
    has_pred = (pred_row > 0) & row_valid
    p = tp_row.float() / pred_row.clamp(min=1).float()
    state["precision_sum"] += torch.where(has_pred, p, torch.zeros_like(p)).sum()
    state["precision_count"] += has_pred.sum(dtype=torch.int32)
    r = tp_row.float() / t_row.clamp(min=1).float()
    state["recall_sum"] += torch.where(row_valid, r, torch.zeros_like(r)).sum()
    state["recall_count"] += row_valid.sum(dtype=torch.int32)
    state["covered"] += has_pred.sum(dtype=torch.int32)
    return state


def _ap(pos: torch.Tensor, neg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """AP over the last axis from integer histograms: reversed cumulative
    sums as integers, then float32 arithmetic as the JAX ``_ap``."""
    tp = pos.long().flip(-1).cumsum(-1).float()
    fp = neg.long().flip(-1).cumsum(-1).float()
    n_pos = tp[..., -1:]
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(n_pos, min=1.0)
    recall_prev = torch.cat([torch.zeros_like(recall[..., :1]), recall[..., :-1]], dim=-1)
    return ((recall - recall_prev) * precision).sum(-1), n_pos[..., 0]


def finalize_reference(hist: torch.Tensor, num_labels: int, num_bins: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ap (L,), n_pos (L,), [map_micro, map_macro])``, float32.  Label-axis
    sums for micro AP are taken as integers (the JAX code sums in f32)."""
    half = num_labels * num_bins
    pos = hist[:half].view(num_labels, num_bins)
    neg = hist[half:].view(num_labels, num_bins)
    ap_l, npos_l = _ap(pos, neg)
    micro, npos_all = _ap(pos.long().sum(0), neg.long().sum(0))
    valid = npos_l > 0
    macro = torch.where(valid, ap_l, torch.zeros_like(ap_l)).sum() / torch.clamp(
        valid.sum(), min=1).float()
    nan = torch.tensor(float("nan"), device=hist.device)
    micro = torch.where(npos_all > 0, micro, nan)
    macro = torch.where(valid.any(), macro, nan)
    return ap_l, npos_l, torch.stack([micro, macro])


# ----------------------------------------------------------------------
# CUDA kernels (csrc/eval_accumulator.cu)


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _lib():
    """The built library with the ctypes signature of each entry point."""
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    lib = load_kernel_library("eval_accumulator").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eval_acc_update.argtypes = [p] * 5 + [i] * 4 + [ctypes.c_float] + [p] * 6
    lib.eval_acc_row_tail.argtypes = [p, p, i] + [p] * 6
    lib.eval_acc_finalize.argtypes = [p, i, i] + [p] * 5
    for fn in (lib.eval_acc_update, lib.eval_acc_row_tail, lib.eval_acc_finalize):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, tensors, dtypes) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"the CUDA eval accumulator needs CUDA tensors, not {device}")
    for t, dt in zip(tensors, dtypes):
        if t.device != device:
            raise ValueError(f"{name}: every tensor must be on {device}")
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return device


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


_SUMS = ("precision_sum", "precision_count", "recall_sum", "recall_count", "covered")
_SUM_DTYPES = (torch.float32, torch.int32, torch.float32, torch.int32, torch.int32)


def update_cuda(state: State, logits: torch.Tensor, targets: torch.Tensor,
                example_mask: torch.Tensor, label_mask: torch.Tensor,
                cols: Optional[torch.Tensor], threshold: float,
                num_bins: int) -> State:
    """The kernels' wrapper: the column update, then the row tail."""
    check_inputs(state, logits, targets, example_mask, label_mask, cols, num_bins)
    f32, i32 = torch.float32, torch.int32
    tensors = [logits, targets, example_mask, label_mask] + [
        state[n] for n in ("tp", "fp", "fn", "hist")]
    dtypes = [f32] * 4 + [i32] * 4
    if cols is not None:
        tensors, dtypes = tensors + [cols], dtypes + [i32]
    device = _check_cuda("eval_acc_update", tensors, dtypes)
    B, Lb = logits.shape
    row_counts = torch.zeros(B, 3, dtype=i32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the C launch goes to the thread's device
        _raise_on(_lib().eval_acc_update(
            logits.data_ptr(), targets.data_ptr(), example_mask.data_ptr(),
            label_mask.data_ptr(), None if cols is None else cols.data_ptr(),
            B, Lb, state["tp"].shape[0], num_bins, float(threshold),
            state["tp"].data_ptr(), state["fp"].data_ptr(), state["fn"].data_ptr(),
            state["hist"].data_ptr(), row_counts.data_ptr(), stream), "eval_acc_update")
        _count("update")
    return row_tail_cuda(state, row_counts, example_mask)


def row_tail_cuda(state: State, row_counts: torch.Tensor,
                  example_mask: torch.Tensor) -> State:
    """The row-tail kernel's wrapper (:func:`row_tail_reference` on the card)."""
    B = example_mask.shape[0]
    if tuple(row_counts.shape) != (B, 3):
        raise ValueError(f"row_counts {tuple(row_counts.shape)} vs {B} rows")
    device = _check_cuda("eval_acc_row_tail",
                         [row_counts, example_mask] + [state[n] for n in _SUMS],
                         [torch.int32, torch.float32, *_SUM_DTYPES])
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        _raise_on(_lib().eval_acc_row_tail(
            row_counts.data_ptr(), example_mask.data_ptr(), B,
            *(state[n].data_ptr() for n in _SUMS), stream), "eval_acc_row_tail")
        _count("row_tail")
    return state


def finalize_cuda(hist: torch.Tensor, num_labels: int, num_bins: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The finalize kernels' wrapper (one launch of the C entry point: the
    per-label pass and the micro/macro tail)."""
    if num_bins > MAX_BINS:
        raise ValueError(f"the finalize kernel takes at most {MAX_BINS} bins")
    if hist.numel() != 2 * num_labels * num_bins:
        raise ValueError(f"hist has {hist.numel()} counts, not 2 x {num_labels} "
                         f"labels x {num_bins} bins")
    device = _check_cuda("eval_acc_finalize", [hist], [torch.int32])
    ap = torch.empty(num_labels, dtype=torch.float32, device=device)
    npos = torch.empty(num_labels, dtype=torch.float32, device=device)
    micro = torch.empty(2 * num_bins, dtype=torch.int64, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        _raise_on(_lib().eval_acc_finalize(hist.data_ptr(), num_labels, num_bins,
                                        ap.data_ptr(), npos.data_ptr(),
                                        micro.data_ptr(), out.data_ptr(), stream),
                  "eval_acc_finalize")
        _count("finalize")
    return ap, npos, out


# ----------------------------------------------------------------------
# dispatch


def update(state: State, logits: torch.Tensor, targets: torch.Tensor,
           example_mask: torch.Tensor, label_mask: torch.Tensor,
           cols: Optional[torch.Tensor], threshold: float, num_bins: int) -> State:
    """Add one batch into ``state`` (in place; returns it).  ``cols=None``:
    the batch's columns are state rows 0..Lb-1; else ``cols`` (Lb,) int32
    names each column's row."""
    if logits.device.type == "cpu":
        return update_reference(state, logits, targets, example_mask, label_mask,
                                cols, threshold, num_bins)
    if logits.device.type == "cuda":
        return update_cuda(state, logits, targets, example_mask, label_mask, cols,
                           threshold, num_bins)
    raise ValueError(f"no eval accumulator for device {logits.device}")


def finalize(hist: torch.Tensor, num_labels: int, num_bins: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ap (L,), n_pos (L,), [map_micro, map_macro])`` on ``hist``'s device."""
    if hist.device.type == "cpu":
        return finalize_reference(hist, num_labels, num_bins)
    if hist.device.type == "cuda":
        return finalize_cuda(hist, num_labels, num_bins)
    raise ValueError(f"no eval accumulator for device {hist.device}")
