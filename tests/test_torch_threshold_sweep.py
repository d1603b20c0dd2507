"""K9, the decision-threshold sweep counter: the port's plain PyTorch version
(protnote_tpu_torch/ops/threshold_sweep.py, the CPU path of ``SweepCounter``)
and a numpy emulation of the CUDA kernels' algorithm (thresholds sorted once,
a histogram over k = #{sorted thresholds <= p}, suffix sums in finalize)
against the JAX ``Trainer._sweep_count_fn`` on the same batches.

Logits are drawn so that every probability lies at least 1e-6 from every
threshold (XLA's and torch's exponentials may differ by an ulp, ~6e-8 here);
NaN logits are added on purpose.  With that margin every count is exactly
equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from protnote_tpu.train.trainer import Trainer as JaxTrainer
from protnote_tpu_torch.ops import threshold_sweep as k9

CLI_THRESHOLDS = np.arange(0.01, 1.0, 0.01, dtype=np.float32)
# unsorted, with a duplicate and thresholds outside (0, 1)
ODD_THRESHOLDS = np.array([0.7, 0.2, 0.5, 0.2, 0.95, 0.05, -0.1, 1.5, 0.5], np.float32)
L = 29


def _batches(rng, thresholds, n=4, width=L + 3):
    """``n`` batches of 8 rows over ``width`` >= L columns (label padding
    past L): padded rows, about 20% positives, two NaN logits a batch."""
    out = []
    for i in range(n):
        p = rng.uniform(1e-4, 1 - 1e-4, size=(8, width))
        for _ in range(100):
            bad = np.abs(p[..., None] - thresholds).min(-1) < 1e-6
            if not bad.any():
                break
            p[bad] = rng.uniform(1e-4, 1 - 1e-4, size=int(bad.sum()))
        lg = np.log(p / (1 - p)).astype(np.float32)
        lg[i % 8, i] = lg[(i + 3) % 8, L - 1 - i] = np.nan
        labels = (rng.random(lg.shape) < 0.2).astype(np.float32)
        mask = np.ones(8, np.float32)
        mask[8 - 1 - i % 3:] = 0  # 1-3 padding rows
        out.append((lg, labels, mask))
    return out


def _jax_counts(batches, thresholds):
    count = JaxTrainer._sweep_count_fn(None, thresholds)
    acc = tuple(jnp.zeros((len(thresholds), L), jnp.int32) for _ in range(3))
    for lg, labels, mask in batches:
        acc = count(acc, jnp.asarray(lg), jnp.asarray(labels), jnp.asarray(mask))
    return [np.asarray(a) for a in acc]


def _emulated_update(batches, thresholds):
    """The update kernel's algorithm in numpy: a stable argsort once; per
    valid element k = #{sorted thresholds <= p} (searchsorted right; NaN ->
    0) into a (2, T + 1, L) histogram of positives, then negatives."""
    T = len(thresholds)
    order = np.argsort(thresholds, kind="stable")
    s = thresholds[order]
    hist = np.zeros((2, T + 1, L), np.int32)
    for lg, labels, mask in batches:
        x = lg[:, :L]
        p = np.float32(1) / (np.float32(1) + np.exp(-x))
        k = np.where(np.isnan(p), 0, np.searchsorted(s, p, side="right"))
        valid = np.broadcast_to(mask[:, None] > 0, x.shape)
        neg = (labels[:, :L] <= 0).astype(np.int64)
        cols = np.broadcast_to(np.arange(L), x.shape)
        np.add.at(hist, (neg[valid], k[valid], cols[valid]), 1)
    return hist, order


def _emulated_finalize(hist, order):
    """The finalize kernel's algorithm in numpy: suffix sums over k > i,
    written back in the thresholds' order."""
    above = np.cumsum(hist[:, ::-1], 1)[:, ::-1][:, 1:]  # sum over k > i
    tp_s, fp_s = above[0], above[1]
    fn_s = hist[0].sum(0) - tp_s
    out = []
    for c in (tp_s, fp_s, fn_s):
        o = np.empty_like(c)
        o[order] = c
        out.append(o.astype(np.int32))
    return out


@pytest.mark.parametrize("thresholds", [CLI_THRESHOLDS, ODD_THRESHOLDS],
                         ids=["cli_99", "unsorted_duplicates"])
def test_plain_version_matches_jax(thresholds):
    rng = np.random.default_rng(len(thresholds))
    batches = _batches(rng, thresholds)
    want = _jax_counts(batches, thresholds)
    sweep = k9.SweepCounter(thresholds, L, "cpu")
    for lg, labels, mask in batches:
        sweep.update(torch.from_numpy(lg), torch.from_numpy(labels), torch.from_numpy(mask))
    for name, got, w in zip(("tp", "fp", "fn"), sweep.counts(), want):
        assert got.dtype == torch.int32 and tuple(got.shape) == w.shape
        np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    assert want[0].sum() > 0 and want[2].sum() > 0
    if len(thresholds) == len(ODD_THRESHOLDS):  # the duplicate's rows are equal
        for a in want:
            np.testing.assert_array_equal(a[1], a[3])


@pytest.mark.parametrize("thresholds", [CLI_THRESHOLDS, ODD_THRESHOLDS],
                         ids=["cli_99", "unsorted_duplicates"])
def test_kernel_algorithm_matches_jax(thresholds):
    """Sort + histogram + suffix sums, emulated in numpy, give JAX's counts
    exactly; the plain finalize (``finalize_reference``) of the same
    histogram gives them too."""
    rng = np.random.default_rng(10 + len(thresholds))
    batches = _batches(rng, thresholds)
    want = _jax_counts(batches, thresholds)
    hist, order = _emulated_update(batches, thresholds)
    for name, got, w in zip(("tp", "fp", "fn"), _emulated_finalize(hist, order), want):
        np.testing.assert_array_equal(got, w, err_msg=name)
    got = k9.finalize_reference(torch.from_numpy(hist.reshape(-1)),
                                torch.from_numpy(order.astype(np.int32)), L, len(thresholds))
    for name, g, w in zip(("tp", "fp", "fn"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_wrappers_raise_on_what_they_do_not_take():
    ones = torch.ones
    with pytest.raises(ValueError, match="CUDA tensors"):
        k9.update_cuda(torch.zeros(2 * 3 * 4, dtype=torch.int32), ones(2), ones(2, 4),
                       ones(2, 4), ones(2), 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k9.finalize_cuda(torch.zeros(2 * 3 * 4, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), 4, 2)
    with pytest.raises(ValueError, match="columns for"):
        k9.count_reference(tuple(torch.zeros(2, 5, dtype=torch.int32) for _ in range(3)),
                           ones(2, 4), ones(2, 4), ones(2), ones(2))
    with pytest.raises(ValueError, match="no threshold sweep"):
        k9.SweepCounter([0.5], 4, "meta")
    sweep = k9.SweepCounter([0.5], 4, "cpu")
    with pytest.raises(ValueError, match="sweep on"):
        sweep.update(torch.ones(2, 4, device="meta"), torch.ones(2, 4, device="meta"),
                     torch.ones(2, device="meta"))
