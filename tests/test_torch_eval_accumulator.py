"""K3, the on-device eval accumulator: the port's plain PyTorch version
(protnote_tpu_torch/ops/eval_accumulator.py, the CPU path of
``DeviceEvalAccumulator``) and a numpy emulation of the CUDA kernels' order
of work (row groups, a last-block row tail, a warp a label in finalize)
against the JAX ``DeviceEvalAccumulator``, and the port's copies of the host
metric classes against their JAX originals.

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
    # ESTIMATE_MAP False: the exact host AUPRC
    jmet, tmet = jm.EvalMetrics(L, 0.5), tm.EvalMetrics(L, 0.5)
    assert isinstance(tmet.auprc, tm.ExactAUPRC)
    for met in (jmet, tmet):
        met.update(probs, targets, mask)
        met.update(probs[:5], targets[:5])
    assert tmet.compute("test") == jmet.compute("test")


# ----------------------------------------------------------------------
# the CUDA kernels' order of work, emulated in numpy

ROWS_PER_THREAD, UPDATE_THREADS, FINALIZE_WARPS = 4, 256, 8
f32 = np.float32


def _warp_sum_down(v):
    """Lane 0's result of ``warp_sum`` (shfl_down 16, 8, 4, 2, 1)."""
    v = v.astype(f32).copy()
    for o in (16, 8, 4, 2, 1):
        v[: 32 - o] = v[: 32 - o] + v[o:32]
    return v[0]


def _block_sum(per_thread):
    """``block_sum`` over a block of len(per_thread) threads (a multiple of
    32): each warp's tree, then warp 0's tree over the warp sums."""
    warps = np.array([_warp_sum_down(w) for w in per_thread.reshape(-1, 32)], f32)
    return _warp_sum_down(np.r_[warps, np.zeros(32 - warps.size, f32)])


def _emulated_update(state, lg, tg, em, lm, cols, th, nb):
    """One ``eval_acc_update`` launch on a numpy copy of the state: every
    integer count is order-free; the row tail sums thread b % 256's rows in
    order, then a block sum."""
    B, Lb = lg.shape
    L = state["tp"].shape[0]
    p = f32(1) / (f32(1) + np.exp(-lg.astype(f32)))
    valid = (em[:, None] > 0) & (lm[None, :] > 0)
    t = (tg > 0) & valid
    pred = (p >= f32(th)) & valid
    rows = np.arange(Lb) if cols is None else np.asarray(cols)
    rows = np.where(lm > 0, rows, 0)
    bins = np.clip((p * f32(nb)).astype(np.int32), 0, nb - 1)
    slot = np.where(t, rows[None, :], L + rows[None, :]) * nb + bins
    np.add.at(state["hist"], slot[valid], 1)
    row_counts = np.zeros((B, 3), np.int64)
    for b0 in range(0, B, ROWS_PER_THREAD):  # a block row group's atomics
        g = slice(b0, b0 + ROWS_PER_THREAD)
        for name, hit in (("tp", pred & t), ("fp", pred & ~t), ("fn", ~pred & t)):
            np.add.at(state[name], rows, hit[g].sum(0).astype(np.int32))
        for c0 in range(0, Lb, UPDATE_THREADS):  # a block's per-row sums
            cs = slice(c0, c0 + UPDATE_THREADS)
            row_counts[g] += np.stack([(pred & t)[g, cs].sum(1), pred[g, cs].sum(1),
                                       t[g, cs].sum(1)], 1)
    # the last block's tail
    ps, rs = np.zeros(UPDATE_THREADS, f32), np.zeros(UPDATE_THREADS, f32)
    pc = rc = 0
    for b in range(B):
        j = b % UPDATE_THREADS
        tp_row, pred_row, t_row = (f32(v) for v in row_counts[b])
        if em[b] > 0:
            if pred_row > 0:
                ps[j] = ps[j] + tp_row / max(pred_row, f32(1))
                pc += 1
            rs[j] = rs[j] + tp_row / max(t_row, f32(1))
            rc += 1
    state["precision_sum"] = f32(state["precision_sum"] + _block_sum(ps))
    state["recall_sum"] = f32(state["recall_sum"] + _block_sum(rs))
    for name, v in (("precision_count", pc), ("recall_count", rc), ("covered", pc)):
        state[name] = np.int32(state[name] + v)
    return state


def _ap_terms(tp_i, pos, fp_i, n_pos):
    tpf, fpf, npf = f32(tp_i), f32(fp_i), f32(n_pos)
    precision = tpf / np.maximum(tpf + fpf, f32(1))
    recall = tpf / np.maximum(npf, f32(1))
    recall_prev = f32(tp_i - pos) / np.maximum(npf, f32(1))
    return ((recall - recall_prev) * precision).astype(f32)


def _emulated_finalize(hist, L, nb, resident=264):
    """``eval_acc_finalize``: a warp a label (``resident`` blocks of 8 warps
    fit the card; 264 on an H100), lane j holding PER consecutive bins from
    the top down, f32 terms summed by the lane then by a butterfly; integer
    micro sums; each warp's AP sum over its labels in order, each block's
    over its warps in order; the one-block micro/macro tail."""
    per = 1
    while 32 * per < nb:
        per *= 2
    h = hist.reshape(2, L, nb)[:, :, ::-1].astype(np.int64)  # top bin first
    h = np.concatenate([h, np.zeros((2, L, 32 * per - nb), np.int64)], 2)
    lanes = h.reshape(2, L, 32, per)
    lane_tot = lanes.sum(3)
    before = np.cumsum(lane_tot, 2) - lane_tot  # the shuffle scan, exclusive
    tp_i = before[0][..., None] + np.cumsum(lanes[0], 2)
    fp_i = before[1][..., None] + np.cumsum(lanes[1], 2)
    n_pos = lane_tot[0].sum(1)
    terms = _ap_terms(tp_i, lanes[0], fp_i, n_pos[:, None, None])
    lane_sum = np.zeros((L, 32), f32)
    for k in range(per):
        lane_sum = lane_sum + terms[:, :, k]
    for o in (16, 8, 4, 2, 1):  # butterfly: every lane ends with one sum
        lane_sum = lane_sum + lane_sum[:, np.arange(32) ^ o]
    ap = lane_sum[:, 0]
    # the tail block: nb threads (a multiple of 32), thread j at bin nb-1-j
    threads = (nb + 31) // 32 * 32
    micro = h[:, :, :nb].sum(1)  # per reversed bin, exact
    mtp, mfp = np.cumsum(micro[0]), np.cumsum(micro[1])
    mterm = np.zeros(threads, f32)
    mterm[:nb] = _ap_terms(mtp, micro[0], mfp, mtp[-1])
    micro_ap = _block_sum(mterm) if mtp[-1] > 0 else f32("nan")
    blocks = min(-(-L // FINALIZE_WARPS), resident)
    warps = blocks * FINALIZE_WARPS
    warp_ap = np.zeros(warps, f32)
    for l in range(L):
        if n_pos[l] > 0:
            warp_ap[l % warps] = warp_ap[l % warps] + ap[l]
    block_ap = np.zeros(blocks, f32)
    for b in range(blocks):
        for w in range(FINALIZE_WARPS):
            block_ap[b] = block_ap[b] + warp_ap[b * FINALIZE_WARPS + w]
    s = np.zeros(threads, f32)
    for b in range(blocks):
        s[b % threads] = s[b % threads] + block_ap[b]
    n = int((n_pos > 0).sum())
    macro = _block_sum(s) / f32(max(n, 1)) if n else f32("nan")
    return ap, n_pos.astype(f32), np.array([micro_ap, macro], f32)


@pytest.mark.parametrize("cols_path, threshold, nb", CASES)
def test_kernel_order_matches_jax(cols_path, threshold, nb):
    """The kernels' update (row groups and atomics, the last block's row
    tail) and finalize (a warp a label) emulated in numpy, against the JAX
    accumulator on the same batches: integer state exact, float32 sums to
    1e-6 relative, micro/macro AP to 1e-6."""
    rng = np.random.default_rng(200 + int(cols_path) * 7 + nb)
    batches = _batches(rng, nb, 0.5 if threshold is None else threshold, cols_path)
    ja, ta = _run(batches, threshold, nb)
    state = {k: v.numpy().copy() for k, v in ta.state.items()}
    state = {k: np.zeros_like(v) for k, v in state.items()}
    th = 0.5 if threshold is None else threshold
    for lg, tg, em, lm, li in batches:
        cols = ta.cols_for(li, lg.shape[1])
        _emulated_update(state, lg, tg, em, lm, None if cols is None else cols.numpy(),
                         th, nb)
    for k, v in ja.state.items():
        want = np.asarray(v)
        if want.dtype == np.int32:
            np.testing.assert_array_equal(state[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(state[k], want, rtol=1e-6, atol=0, err_msg=k)
    ap, npos, out = _emulated_finalize(state["hist"], L, nb)
    jmet = jm.EvalMetrics(L, threshold=threshold, map_estimate=True, num_bins=nb)
    ja.finalize_into(jmet)
    want = jmet.compute()
    assert out[0] == pytest.approx(want["map_micro"], abs=1e-6, rel=0)
    assert out[1] == pytest.approx(want["map_macro"], abs=1e-6, rel=0)
    ap_p, npos_p, _ = k3.finalize_reference(torch.from_numpy(state["hist"]), L, nb)
    np.testing.assert_array_equal(npos, npos_p.numpy())
    np.testing.assert_allclose(ap, ap_p.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("nb", [512, 100])
def test_kernel_finalize_order_many_labels_a_warp(nb):
    """The finalize's order with few resident blocks, so each warp walks
    many labels (and with 100 bins, a lane's last bins past the histogram),
    against the plain finalize on the same random histograms: per-label AP
    and micro/macro AP to 1e-6, n_pos exactly."""
    rng = np.random.default_rng(nb)
    labels = 3000
    hist = rng.integers(0, 4, size=2 * labels * nb).astype(np.int32)
    hist[: labels * nb].reshape(labels, nb)[::5] = 0  # labels with no positives
    hist[: labels * nb][rng.random(labels * nb) < 0.9] = 0  # positives are rare
    ap, npos, out = _emulated_finalize(hist, labels, nb, resident=3)
    ap_p, npos_p, out_p = k3.finalize_reference(torch.from_numpy(hist), labels, nb)
    np.testing.assert_array_equal(npos, npos_p.numpy())
    np.testing.assert_allclose(ap, ap_p.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, out_p.numpy(), atol=1e-6, rtol=0)
