"""K3, the on-device eval accumulator: the port's plain PyTorch version
(protnote_tpu_torch/ops/eval_accumulator.py, the CPU path of
``DeviceEvalAccumulator``) against the JAX ``DeviceEvalAccumulator``, and
the port's copies of the host metric classes against their JAX originals.

Logits are drawn so that every probability lies at least 2e-6 from every
bin edge k/nb and from the threshold: the exponentials of XLA and of torch
may differ by an ulp (~6e-8 here), and only an element within that distance
of an edge could change bin.  With that margin the integer state (tp/fp/fn,
histograms, counts) must be exactly equal; the float32 samplewise sums agree
to 1e-6 relative (sums of the same float32 terms in another order), and
finalize (per-label AP, micro and macro AP) to 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from protnote_tpu.evaln import metrics as jm
from protnote_tpu_torch.evaln import metrics as tm
from protnote_tpu_torch.ops import eval_accumulator as k3

B, L = 8, 37


def _logits(rng, shape, nb, th):
    p = rng.uniform(1e-3, 1 - 1e-3, size=shape)
    for _ in range(100):
        bad = (np.abs(p * nb - np.round(p * nb)) / nb < 2e-6) | (np.abs(p - th) < 2e-6)
        if not bad.any():
            break
        p[bad] = rng.uniform(1e-3, 1 - 1e-3, size=int(bad.sum()))
    return np.log(p / (1 - p)).astype(np.float32)


def _batches(rng, nb, th, cols_path):
    """Four batches with padded rows and a label_mask with zeros; on the
    ``cols`` path each batch scores a 20-label subset padded to 24 slots."""
    out = []
    for i in range(4):
        em = np.ones(B, np.float32)
        em[B - 1 - i % 3 :] = 0  # 1-3 padding rows
        if cols_path:
            li = np.sort(rng.choice(L, 20, replace=False))
            Lb, lm = 24, np.r_[np.ones(20), np.zeros(4)].astype(np.float32)
        else:
            li, Lb = None, L
            lm = (rng.random(L) < 0.85).astype(np.float32)
        lg = _logits(rng, (B, Lb), nb, th)
        tg = (rng.random((B, Lb)) < 0.25).astype(np.float32)
        out.append((lg, tg, em, lm, li))
    return out


def _run(batches, threshold, nb):
    ja = jm.DeviceEvalAccumulator(L, threshold, num_bins=nb)
    ta = tm.DeviceEvalAccumulator(L, threshold, num_bins=nb, device="cpu")
    for lg, tg, em, lm, li in batches:
        ja.update(jnp.asarray(lg), jnp.asarray(tg), jnp.asarray(em), jnp.asarray(lm), li)
        ta.update(torch.from_numpy(lg), torch.from_numpy(tg), torch.from_numpy(em),
                  torch.from_numpy(lm), li)
    return ja, ta


CASES = [(cols, th, nb) for cols in (False, True) for th in (None, 0.3)
         for nb in (512, 64)]


@pytest.mark.parametrize("cols_path, threshold, nb", CASES)
def test_update_matches_jax(cols_path, threshold, nb):
    rng = np.random.default_rng(int(cols_path) * 7 + nb)
    ja, ta = _run(_batches(rng, nb, 0.5 if threshold is None else threshold, cols_path),
                  threshold, nb)
    assert set(ja.state) == set(ta.state)
    for k, v in ja.state.items():
        want, got = np.asarray(v), ta.state[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=k)
    assert int(ta.state["hist"].sum()) > 0 and int(ta.state["tp"].sum()) > 0


@pytest.mark.parametrize("cols_path, threshold, nb", CASES)
def test_finalize_and_merge_match_jax(cols_path, threshold, nb):
    rng = np.random.default_rng(100 + int(cols_path) * 7 + nb)
    ja, ta = _run(_batches(rng, nb, 0.5 if threshold is None else threshold, cols_path),
                  threshold, nb)
    for how in ("finalize_into", "merge_into"):
        jmet = jm.EvalMetrics(L, threshold=threshold, map_estimate=True, num_bins=nb)
        tmet = tm.EvalMetrics(L, threshold=threshold, map_estimate=True, num_bins=nb)
        getattr(ja, how)(jmet)
        getattr(ta, how)(tmet)
        want, got = jmet.compute(), tmet.compute()
        assert set(got) == set(want)
        if threshold is None:
            assert set(got) == {"map_micro", "map_macro"}
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6, rel=0, nan_ok=True), (how, k)


def test_finalize_per_label_ap_and_empty_state():
    """Per-label AP of the plain finalize against the JAX ``_ap`` written
    out in numpy, and NaN micro/macro when no label has a positive."""
    rng = np.random.default_rng(3)
    nb = 512
    hist = rng.integers(0, 5, size=2 * L * nb).astype(np.int32)
    hist[: L * nb].reshape(L, nb)[::3] = 0  # labels with no positives
    ap, npos, out = k3.finalize_reference(torch.from_numpy(hist), L, nb)
    pos = hist[: L * nb].reshape(L, nb).astype(np.float32)
    neg = hist[L * nb :].reshape(L, nb).astype(np.float32)
    tp, fp = np.cumsum(pos[:, ::-1], -1), np.cumsum(neg[:, ::-1], -1)
    n_pos = tp[:, -1:]
    recall = tp / np.maximum(n_pos, 1)
    want = np.sum((recall - np.c_[np.zeros(L), recall[:, :-1]])
                  * tp / np.maximum(tp + fp, 1), -1)
    np.testing.assert_allclose(ap.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(npos.numpy(), n_pos[:, 0])
    assert out[1].item() == pytest.approx(want[n_pos[:, 0] > 0].mean(), abs=1e-6)
    _, _, empty = k3.finalize_reference(torch.zeros(2 * L * nb, dtype=torch.int32), L, nb)
    assert torch.isnan(empty).all()


def test_inputs_the_jax_update_refuses_raise():
    state = k3.init_state(2, 16, "cpu")
    ones = lambda *s: torch.ones(*s)  # noqa: E731
    with pytest.raises(ValueError, match="32767"):
        k3.update(state, ones(32768, 2), ones(32768, 2), ones(32768), ones(2), None, 0.5, 16)
    with pytest.raises(ValueError, match="exceed"):
        k3.update(state, ones(2, 3), ones(2, 3), ones(2), ones(3), None, 0.5, 16)
    with pytest.raises(ValueError, match="no eval accumulator"):
        k3.update(state, torch.ones(2, 2, device="meta"), ones(2, 2), ones(2), ones(2),
                  None, 0.5, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.update_cuda(state, ones(2, 2), ones(2, 2), ones(2), ones(2), None, 0.5, 16)


def test_cols_for_matches_jax():
    ja = jm.DeviceEvalAccumulator(L, 0.5)
    ta = tm.DeviceEvalAccumulator(L, 0.5, device="cpu")
    for li, width in ((None, L), (None, 30), (np.arange(L), L), (np.array([4, 9, 2]), 5),
                      (np.arange(30), 30)):
        want, got = ja.cols_for(li, width), ta.cols_for(li, width)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert got.dtype == torch.int32


def test_host_copies_match_jax():
    rng = np.random.default_rng(11)
    probs = rng.random((20, L)).astype(np.float32)
    targets = (rng.random((20, L)) < 0.3).astype(np.float32)
    mask = rng.random(20) < 0.8
    li = rng.choice(60, L, replace=False)
    probs60 = rng.random((6, 60)).astype(np.float32)
    targets60 = (rng.random((6, 60)) < 0.3).astype(np.float32)
    tp, fp, fn = (rng.integers(0, 9, L) for _ in range(3))
    assert tm.confusion_metrics(tp, fp, fn) == jm.confusion_metrics(tp, fp, fn)
    for threshold in (0.5, 0.2):
        jc, tc = jm.ConfusionAccumulator(60, threshold), tm.ConfusionAccumulator(60, threshold)
        js, ts = jm.SamplewiseAccumulator(threshold), tm.SamplewiseAccumulator(threshold)
        for acc in (jc, tc):
            acc.update(probs, targets, mask, label_indices=li)
            acc.update(probs60, targets60)
            acc.merge_counts(tp.repeat(2)[:60], fp.repeat(2)[:60], fn.repeat(2)[:60])
        for acc in (js, ts):
            acc.update(probs, targets, mask)
            acc.update(probs[:5], targets[:5])
        assert tc.compute() == jc.compute()
        assert ts.compute() == js.compute()
    jb, tb = jm.BinnedAUPRC(60, 64), tm.BinnedAUPRC(60, 64)
    for acc in (jb, tb):
        acc.update(probs, targets, mask, label_indices=li)
        acc.update(probs60, targets60)
        acc.merge(np.ones((60, 64), np.int32), np.zeros((60, 64), np.int32))
    np.testing.assert_array_equal(tb.pos, jb.pos)
    np.testing.assert_array_equal(tb.neg, jb.neg)
    assert tb.compute() == jb.compute()
    jmet, tmet = jm.EvalMetrics(L, 0.5, map_estimate=True), tm.EvalMetrics(L, 0.5, map_estimate=True)
    for met in (jmet, tmet):
        met.update(probs, targets, mask)
    assert tmet.compute("test") == jmet.compute("test")
    assert tm._PrecomputedAUPRC(0.1, 0.2).compute() == jm._PrecomputedAUPRC(0.1, 0.2).compute()
    with pytest.raises(NotImplementedError, match="ExactAUPRC"):
        tm.EvalMetrics(L, 0.5, map_estimate=False)
