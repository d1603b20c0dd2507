"""The port's CUDA kernels on the card: the pair scorer (K1), its int8 form
(K2), the eval accumulator (K3), the threshold-sweep counter (K9), the
training pair GEMM (K4) and its backward (K4-bwd), BN+ReLU (K5), the
streamed scorer's tile passes (K6: moments, affine + ReLU, the head),
the text tower's masked attention (K8a) and residual LayerNorm (K8b) and
their backward (K8a-bwd, K8b-bwd), and the encoder's masked dilated conv
chain (K7: the conv, its dX and dW, the train-mode masked BN + ReLU, the
pool) against
their plain PyTorch versions, and the serving engine on CUDA against
the same engine on the CPU.  These need an NVIDIA
card (the kernels have no CPU mode) and skip without one.  The file imports neither jax nor the repo's conftest fixtures,
so on the card's machine it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerance 2e-2 on logits and 1e-2 on probabilities: the kernel and the plain
version round the same activations to bf16, but sum in other orders (the
logits with atomics), so an activation can land one bf16 step (2^-8) apart.
K3 on the same logits on both sides: integer state exactly equal (inputs are
drawn at least 2e-6 from every bin edge and from the threshold, far beyond
the ulp by which two exponentials can differ), float32 sums to 1e-6
relative, AP to 1e-6 absolute.
K9 on the same logits on both sides (drawn 2e-6 from every threshold):
counts exactly equal.
K2: the carried layer-1 rows (int8 codes or bf16) exactly equal, the logits
to 2e-2 (only the w_out dot sums in another order).
K4 and K5 on the same bf16 inputs on both sides: bf16 outputs to two bf16
steps (rtol 2^-6, atol 1e-2: the GEMM sums in another order, and the BN
affine's float32 inverse square root may differ by an ulp), float32 moments
to 1e-5 relative, the float32 column sums of the backward to 1e-3 relative
(other summation orders over ~1,500 rows of bf16 products).
K6 on the same bf16 inputs: bf16 outputs (y, dz) to two bf16 steps (rtol
2^-6, atol 1e-2), the float32 column sums (moments, dinv, dshift, dw) and
the logits and db to 1e-3 of their largest |value| (other summation orders
over ~1,500 rows); the streamed scorer through K4 + K6 against its plain
version at the decomposed scorer's tolerances (logits 3e-2, running
statistics 1e-3, gradients 5e-2 of their largest |value|).
K4-bwd on the same bf16 inputs on both sides: da2, dc2 and dW each within
1e-2 of the plain output's largest |value| (both round dx1 to bf16 before
its sums, but the products and the sums run in other orders, so an element
of dx1 or of an output can land one bf16 step apart).
K8a and K8b on the same bf16 inputs on both sides: within 1e-2 of the plain
output's largest |value| (two bf16 steps: the score and output sums run in
other orders, so a probability or an output can round to the neighbouring
bf16 value).
K8a-bwd and K8b-bwd on the same bf16 inputs: each gradient within 2^-6 of
the plain gradient's largest |value| (dP and the outputs are rounded to bf16
from sums in other orders); K8b-bwd's dscale and dbias to 1e-3, and the same
bits on a second call.
K7 on the same bf16 inputs: the conv's output to two bf16 steps (rtol 2^-6,
atol 1e-2: the conv sums in another order, then the bias and the residual
are rounded again), its masked rows exactly 0 (or the residual); dX, dW,
dbias and the BN's dx within 2^-6 of the plain gradient's largest |value|
(each rounded to bf16 from a float32 sum in another order), the BN's
running statistics to 1e-5 and dscale/dbias to 1e-3 of their largest
|value|; the pool to 1e-5; the encoder (3 blocks at 112 channels) through K7
within 5e-2 of the plain chain's largest pooled |value|.
"""

import numpy as np
import pytest
import torch

from protnote_tpu_torch.evaln.metrics import DeviceEvalAccumulator
from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer
from protnote_tpu_torch.ops import eval_accumulator as k3
from protnote_tpu_torch.ops import layer_norm as k8b
from protnote_tpu_torch.ops import pair_scorer as ps
from protnote_tpu_torch.ops import streaming_train as st
from protnote_tpu_torch.ops import text_attention as k8a
from protnote_tpu_torch.ops import threshold_sweep as k9
from protnote_tpu_torch.serving import ServingEngine


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _folded(rng, d, width, n_hidden, device):
    def w(*shape):
        fan_in = shape[0]
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)
                                * np.float32(np.sqrt(6.0 / fan_in)))

    bf16 = torch.bfloat16
    return ps.FoldedOutputMLP(
        w1_p=w(d, width).to(device, bf16), w1_l=w(d, width).to(device, bf16),
        b1=(0.1 * w(width)).to(device, bf16), w1_prod=None,
        hidden=[(w(width, width).to(device, bf16), (0.1 * w(width)).to(device, bf16))
                for _ in range(n_hidden)],
        w_out=w(width).to(device, bf16), b_out=torch.tensor(0.3, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("width", [128, 256, 384, 512])
@pytest.mark.parametrize("n_hidden", [1, 2, 3])
def test_kernel_matches_plain_on_card(monkeypatch, n_hidden, width, batch):
    """1-3 hidden layers (every launch mode), widths 128 and 384 (128-column
    tiles), 256 (one 256-column tile) and 512 (two: the first layer in
    clusters of two blocks), and 128 labels a chunk: 3 chunks of 300 labels,
    the last ragged (44 labels padded to 128 rows a sequence; at batch 1 a
    chunk of fewer than 128 pair rows)."""
    dev = _card()
    monkeypatch.setattr(ps, "TARGET_ROWS", 128 * batch)
    rng = np.random.default_rng(100 * n_hidden + width + batch)
    folded = _folded(rng, 16, width, n_hidden, dev)
    P_e = torch.from_numpy(rng.normal(size=(batch, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    plan = ps.launch_plan(batch, 300, width, n_hidden)
    assert [ch.nl for ch in plan.chunks] == [128, 128, 44]
    before = ps.LAUNCHES
    got = ps.pair_logits_tiled(folded, P_e, L_e, label_tile=128)
    want = ps.pair_logits_tiled_reference(folded, P_e, L_e, label_tile=128)
    torch.cuda.synchronize()
    assert ps.LAUNCHES - before == len(plan.launches())  # 3 chunks x n_hidden
    assert float(want.std()) > 0.3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_kernel_one_chunk_on_card():
    """The default plan: one chunk of all 300 labels, padded to 384 rows a
    sequence, 15 row tiles on 12 column tiles of 256."""
    dev = _card()
    rng = np.random.default_rng(4)
    folded = _folded(rng, 16, 3072, 2, dev)
    P_e = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    before = ps.LAUNCHES
    got = ps.pair_logits_tiled(folded, P_e, L_e)
    want = ps.pair_logits_tiled_reference(folded, P_e, L_e)
    torch.cuda.synchronize()
    assert ps.LAUNCHES - before == 2
    assert float(want.std()) > 0.3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take_on_card():
    dev = _card()
    rng = np.random.default_rng(0)
    P_e = torch.zeros(3, 16, device=dev, dtype=torch.bfloat16)
    L_e = torch.zeros(40, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        ps.pair_logits_tiled(_folded(rng, 16, 96, 2, dev), P_e, L_e)
    with pytest.raises(ValueError, match="bfloat16"):
        ps.pair_logits_tiled(_folded(rng, 16, 128, 2, dev), P_e, L_e,
                             compute_dtype=torch.float32)


@pytest.mark.cuda
def test_serving_engine_on_card_matches_cpu():
    dev = _card()
    L, K = 37, 2
    pi_cfg = ProteInferConfig(output_channels=24, kernel_size=5, num_resnet_blocks=2,
                              num_labels=L, compute_dtype=torch.bfloat16)
    pn_cfg = ProtNoteConfig(protein_embedding_dim=24, label_embedding_dim=16, latent_dim=32,
                            projection_head_num_layers=2, output_mlp_num_layers=3,
                            output_mlp_hidden_dim_scale_factor=4, label_tile=16,
                            inference_descriptions_per_label=K, compute_dtype=torch.bfloat16)
    pi_p, pi_s = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    pn_p, pn_s = init_protnote(torch.Generator().manual_seed(1), pn_cfg)
    ts = {"trainable": {"protnote": pn_p}, "model_state": pn_s,
          "enc_params": pi_p, "enc_state": pi_s}
    rng = np.random.default_rng(0)
    matrix = rng.normal(size=(L * K, 16)).astype(np.float32)
    vocab = [f"GO:{i:07d}" for i in range(L)]
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)) for n in (12, 40, 70)]
    kw = dict(buckets=(32, 64), max_batch=4)
    on_card = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, device=dev, **kw)
    on_cpu = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, device="cpu", **kw)
    before = ps.LAUNCHES
    got = on_card.score(seqs)
    assert ps.LAUNCHES > before
    np.testing.assert_allclose(got, on_cpu.score(seqs), atol=1e-2, rtol=0)


def _k3_batches(rng, L, nb, th, n):
    """n batches of 32 rows: padded rows, a label_mask with zeros, and on
    odd batches a 100-label subset (the cols path) padded to 128 slots."""
    out = []
    for i in range(n):
        em = np.ones(32, np.float32)
        em[30 - i :] = 0
        if i % 2:
            li = np.sort(rng.choice(L, 100, replace=False))
            lm = np.r_[np.ones(100), np.zeros(28)].astype(np.float32)
        else:
            li, lm = None, (rng.random(L) < 0.9).astype(np.float32)
        p = rng.uniform(1e-3, 1 - 1e-3, size=(32, lm.size))
        for _ in range(100):
            bad = (np.abs(p * nb - np.round(p * nb)) / nb < 2e-6) | (np.abs(p - th) < 2e-6)
            if not bad.any():
                break
            p[bad] = rng.uniform(1e-3, 1 - 1e-3, size=int(bad.sum()))
        lg = np.log(p / (1 - p)).astype(np.float32)
        tg = (rng.random(lg.shape) < 0.1).astype(np.float32)
        out.append((lg, tg, em, lm, li))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [512, 100])
def test_eval_accumulator_matches_plain_on_card(nb):
    """K3's update (dense and cols paths) and finalize against the plain
    version on the same tensors, over 1000 labels and 6 batches."""
    dev = _card()
    L, th = 1000, 0.4
    rng = np.random.default_rng(nb)
    kern = DeviceEvalAccumulator(L, th, num_bins=nb, device=dev)
    plain = DeviceEvalAccumulator(L, th, num_bins=nb, device=dev)
    before = dict(k3.LAUNCHES)
    for lg, tg, em, lm, li in _k3_batches(rng, L, nb, th, 6):
        args = [torch.from_numpy(a).to(dev) for a in (lg, tg, em, lm)]
        kern.update(*args, label_indices=li)
        cols = plain.cols_for(li, lg.shape[1])
        k3.update_reference(plain.state, *args, cols, th, nb)
    torch.cuda.synchronize()
    assert k3.LAUNCHES["update"] - before["update"] == 6  # the row tail folded in
    assert kern._scratch is not None and int(kern._scratch.abs().sum()) == 0
    for k, v in plain.state.items():
        got = kern.state[k].cpu().numpy()
        if v.dtype == torch.int32:
            np.testing.assert_array_equal(got, v.cpu().numpy(), err_msg=k)
        else:
            np.testing.assert_allclose(got, v.cpu().numpy(), rtol=1e-6, atol=0, err_msg=k)
    ap, npos, out = k3.finalize(kern.state["hist"], L, nb)
    ap_p, npos_p, out_p = k3.finalize_reference(plain.state["hist"], L, nb)
    torch.cuda.synchronize()
    assert k3.LAUNCHES["finalize"] - before["finalize"] == 1
    np.testing.assert_array_equal(npos.cpu().numpy(), npos_p.cpu().numpy())
    np.testing.assert_allclose(ap.cpu().numpy(), ap_p.cpu().numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.cpu().numpy(), out_p.cpu().numpy(), atol=1e-6, rtol=0)
    assert 0 < float(out[0]) < 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 300])
def test_eval_accumulator_row_tail_on_card(rows):
    """The last block's row tail at row counts that leave a ragged row group
    (37) and loop a tail thread over two rows (300), without a kept scratch
    (the wrapper then allocates one) and twice with one."""
    dev = _card()
    L, nb, th = 700, 512, 0.5
    rng = np.random.default_rng(rows)
    lg = torch.from_numpy(rng.normal(size=(rows, L)).astype(np.float32) * 2).to(dev)
    tg = torch.from_numpy((rng.random((rows, L)) < 0.1).astype(np.float32)).to(dev)
    em = torch.ones(rows, device=dev)
    em[-1] = 0
    lm = torch.ones(L, device=dev)
    states = [k3.init_state(L, nb, dev) for _ in range(3)]
    scratch = k3.scratch_for(None, rows, dev)
    for _ in range(2):
        k3.update_cuda(states[0], lg, tg, em, lm, None, th, nb)
        k3.update_cuda(states[1], lg, tg, em, lm, None, th, nb, scratch)
        k3.update_reference(states[2], lg, tg, em, lm, None, th, nb)
    torch.cuda.synchronize()
    assert int(scratch.abs().sum()) == 0
    for k, v in states[2].items():
        for got in states[:2]:
            if v.dtype == torch.int32:
                assert torch.equal(got[k], v), k
            else:
                torch.testing.assert_close(got[k], v, rtol=1e-6, atol=0)


def _sweep_batches(rng, thresholds, L, width, n):
    out = []
    for i in range(n):
        p = rng.uniform(1e-4, 1 - 1e-4, size=(32, width))
        for _ in range(100):
            bad = np.abs(p[..., None] - thresholds).min(-1) < 2e-6
            if not bad.any():
                break
            p[bad] = rng.uniform(1e-4, 1 - 1e-4, size=int(bad.sum()))
        lg = np.log(p / (1 - p)).astype(np.float32)
        lg[i, i] = np.nan
        labels = (rng.random(lg.shape) < 0.1).astype(np.float32)
        mask = np.ones(32, np.float32)
        mask[30 - i:] = 0
        out.append((lg, labels, mask))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", [
    np.arange(0.01, 1.0, 0.01, dtype=np.float32),
    np.array([0.7, 0.2, 0.5, 0.2, 0.95, 0.05, -0.1, 1.5], np.float32)],
    ids=["cli_99", "unsorted_duplicates"])
def test_threshold_sweep_matches_plain_on_card(thresholds):
    """K9's update and finalize against the plain version (the lax.map
    loop) on the same tensors: 1,000 labels padded to 1,024 columns, 5
    batches with padded rows and a NaN logit each."""
    dev = _card()
    L = 1000
    rng = np.random.default_rng(len(thresholds))
    sweep = k9.SweepCounter(thresholds, L, dev)
    T = len(thresholds)
    plain = tuple(torch.zeros(T, L, dtype=torch.int32, device=dev) for _ in range(3))
    th = torch.from_numpy(thresholds).to(dev)
    before = dict(k9.LAUNCHES)
    for lg, labels, mask in _sweep_batches(rng, thresholds, L, 1024, 5):
        args = [torch.from_numpy(a).to(dev) for a in (lg, labels, mask)]
        sweep.update(*args)
        k9.count_reference(plain, *args, th)
    got = sweep.counts()
    torch.cuda.synchronize()
    assert k9.LAUNCHES["update"] - before["update"] == 5
    assert k9.LAUNCHES["finalize"] - before["finalize"] == 1
    for name, g, w in zip(("tp", "fp", "fn"), got, plain):
        assert torch.equal(g, w), name
    assert int(got[0].sum()) > 0 and int(got[2].sum()) > 0
    order = sweep.order.long()
    for g, w in zip(k9.finalize_reference(sweep.hist, sweep.order, L, T), got):
        assert torch.equal(g, w)
    assert torch.equal(sweep.sorted, th[order])


@pytest.mark.cuda
def test_threshold_sweep_raises_on_what_it_does_not_take():
    dev = _card()
    with pytest.raises(ValueError, match="1-1024 thresholds"):
        k9.SweepCounter(np.linspace(0, 1, 1025, dtype=np.float32), 4, dev)
    sweep = k9.SweepCounter([0.5], 4, dev)
    ones = lambda *s: torch.ones(*s, device=dev)  # noqa: E731
    with pytest.raises(ValueError, match="expected contiguous"):
        sweep.update(ones(2, 4).double(), ones(2, 4), ones(2))
    with pytest.raises(ValueError, match="columns for"):
        sweep.update(ones(2, 3), ones(2, 3), ones(2))


@pytest.mark.cuda
def test_eval_accumulator_finalize_empty_on_card():
    dev = _card()
    _, _, out = k3.finalize(torch.zeros(2 * 10 * 512, dtype=torch.int32, device=dev),
                            10, 512)
    assert torch.isnan(out.cpu()).all()


BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-2


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(
        "cuda", torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(128, 256), (256, 384)])
def test_pair_train_kernel_matches_plain_on_card(K, N):
    """K4's forward on a ragged pair count (5 sequences x 301 labels, the
    last label tile of each sequence 45 labels) in one launch, with the
    256- and the 128-column tile; its backward is the plain one on both
    sides.  Then the kernel on the first 4 sequences into a z of 5 whose
    last sequence holds NaN: a store of sequence 3's last tile that crossed
    into the next sequence's rows (as a 2-D store at row b * L + l would)
    would overwrite them, whatever order the tiles ran in."""
    _card()
    rng = np.random.default_rng(7)
    B, L = 5, 301
    a2, c2 = _bf16(rng, B, K), _bf16(rng, L, K)
    w = _bf16(rng, K, N, scale=0.2)
    before = st.LAUNCHES["pair_train_hidden"]
    got = st.pair_hidden(a2, c2, w)
    want = st.pair_hidden_reference(a2, c2, w)
    torch.cuda.synchronize()
    assert st.LAUNCHES["pair_train_hidden"] - before == 1
    assert float(want.float().std()) > 0.3
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)

    z = torch.full((B * L, N), float("nan"), device="cuda", dtype=torch.bfloat16)
    wt = w.t().contiguous()
    plan = st.pair_train_plan(B - 1, L, K, N)
    err = st._pair_fn()(a2.data_ptr(), c2.data_ptr(), wt.data_ptr(), z.data_ptr(), B - 1, L, K,
                        N, plan.block_n, plan.grid, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.isnan(z[(B - 1) * L:].float()).all()
    torch.testing.assert_close(z[:(B - 1) * L].float(), want[:(B - 1) * L].float(),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.cuda
def test_pair_train_kernel_raises_on_what_it_does_not_take():
    dev = _card()
    a2, c2 = torch.zeros(2, 64, device=dev), torch.zeros(3, 64, device=dev)
    w = torch.zeros(64, 128, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        st.pair_hidden(a2, c2, w)
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="multiples of 128"):
        st.pair_hidden(a2.to(bf16), c2.to(bf16), w.to(bf16))


K4_BWD_REL_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,K,N", [(5, 301, 128, 256), (1, 301, 256, 384), (3, 1, 128, 128),
                                     (4, 200, 384, 512), (2, 130, 256, 128)])
def test_pair_train_backward_kernels_match_plain_on_card(B, L, K, N):
    """K4-bwd's two kernels through ``pair_hidden``'s backward (one launch
    each) against the plain backward: L not a multiple of 64 or 128 (the
    last label tile of each sequence ragged), one sequence, one label, the
    256- and the 128-column dW tile."""
    _card()
    rng = np.random.default_rng(17)
    a2, c2 = _bf16(rng, B, K), _bf16(rng, L, K)
    w = _bf16(rng, K, N, scale=0.2)
    dz = _bf16(rng, B * L, N)
    leaves = [t.clone().requires_grad_(True) for t in (a2, c2, w)]
    before = dict(st.LAUNCHES)
    st.pair_hidden(*leaves).backward(dz)
    torch.cuda.synchronize()
    assert st.LAUNCHES["pair_train_dx"] - before["pair_train_dx"] == 1
    assert st.LAUNCHES["pair_train_dw"] - before["pair_train_dw"] == 1
    want = st._pair_hidden_backward_plain(a2, c2, w, dz)
    for got, ref in zip((t.grad for t in leaves), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert float(ref.float().abs().max()) > 0
        err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        assert err <= K4_BWD_REL_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("block_n", [128, 256])
@pytest.mark.parametrize("splits", [1, 3])
def test_pair_train_dw_column_tiles_on_card(block_n, splits):
    """The dW kernel with each of its column tiles and with split pair rows
    (f32 partial sums added by the second pass), through its entry point,
    against the plain backward's dW."""
    _card()
    rng = np.random.default_rng(19)
    B, L, K, N = 2, 130, 256, 768
    a2, c2 = _bf16(rng, B, K), _bf16(rng, L, K)
    w = _bf16(rng, K, N, scale=0.2)
    dz = _bf16(rng, B * L, N)
    part = torch.empty(splits, K, N, device="cuda")
    dw = torch.empty(K, N, device="cuda", dtype=torch.bfloat16)
    err = st._dw_fn()(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(), part.data_ptr(),
                      dw.data_ptr(), B, L, K, N, block_n, splits, 7,
                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = st._pair_hidden_backward_plain(a2, c2, w, dz)[2].float()
    assert float((dw.float() - want).abs().max() / want.abs().max()) <= K4_BWD_REL_TOL


@pytest.mark.cuda
def test_pair_train_backward_kernels_raise_on_what_they_do_not_take():
    dev = _card()
    bf16 = torch.bfloat16
    a2, c2 = torch.zeros(2, 128, device=dev, dtype=bf16), torch.zeros(3, 128, device=dev,
                                                                        dtype=bf16)
    w = torch.zeros(128, 128, device=dev, dtype=bf16)
    with pytest.raises(ValueError, match="does not match"):
        st._pair_hidden_backward_cuda(a2, c2, w, torch.zeros(5, 128, device=dev, dtype=bf16))
    with pytest.raises(ValueError, match="does not match"):
        st._pair_hidden_backward_cuda(a2, c2, w, torch.zeros(6, 128, device=dev))
    with pytest.raises(ValueError, match="multiples of 128"):
        st._pair_hidden_backward_cuda(a2[:, :64].contiguous(), c2[:, :64].contiguous(), w[:64],
                                      torch.zeros(6, 128, device=dev, dtype=bf16))


@pytest.mark.cuda
def test_bn_relu_kernels_match_plain_on_card():
    """K5 forward (y, mean, var) and backward (dz, dscale, dbias) on the
    same inputs, with masked rows and a running mean far from the batch
    mean."""
    _card()
    rng = np.random.default_rng(8)
    N, H = 1505, 512
    z = _bf16(rng, N, H) + 3.0
    rows = torch.from_numpy((rng.random((N, 1)) < 0.9).astype(np.float32)).cuda()
    n = rows.sum()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(0, 0.1, H).astype(np.float32)).cuda()
    running = torch.full((H,), 2.5, device="cuda")
    dy = _bf16(rng, N, H)
    outs = {}
    for ref in (False, True):
        z_ = z.clone().requires_grad_(True)
        s_, b_ = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        fn = st.bn_relu_reference if ref else st.bn_relu
        y, mean, var = fn(z_, rows, n, s_, b_, running)
        y.backward(dy)
        outs[ref] = (y, mean, var, z_.grad, s_.grad, b_.grad)
    torch.cuda.synchronize()
    (y, mean, var, dz, ds, db), (y0, mean0, var0, dz0, ds0, db0) = outs[False], outs[True]
    torch.testing.assert_close(mean, mean0, rtol=1e-5, atol=0)
    torch.testing.assert_close(var, var0, rtol=1e-5, atol=0)
    torch.testing.assert_close(y.float(), y0.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    torch.testing.assert_close(dz.float(), dz0.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    torch.testing.assert_close(ds, ds0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(db, db0, rtol=1e-3, atol=1e-3)
    assert float((y > 0).float().mean()) > 0.2 and float(dz.float().abs().max()) > 0


@pytest.mark.cuda
def test_decomposed_scorer_kernels_match_plain_on_card():
    """``pair_logits_dense_decomposed`` through K4 + K5 against
    its plain version on the card: logits, new BN state and gradients."""
    _card()
    rng = np.random.default_rng(9)
    d, H, B, L = 32, 256, 6, 203
    cfg = ProtNoteConfig(protein_embedding_dim=24, label_embedding_dim=16, latent_dim=d,
                         projection_head_num_layers=2, output_mlp_num_layers=3,
                         output_mlp_hidden_dim_scale_factor=H // d)
    p, s = init_protnote(torch.Generator().manual_seed(3), cfg)
    p = {k: v for k, v in p["output_mlp"].items()}
    s = s["output_mlp"]
    from protnote_tpu_torch.models.layers import tree_to

    p, s = tree_to(p, "cuda"), tree_to(s, "cuda")
    P_e, L_e = _bf16(rng, B, d), _bf16(rng, L, d)
    em = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.float32, device="cuda")
    lm = (torch.arange(L, device="cuda") < 190).float()
    res = {}
    for ref in (False, True):
        leaves = [p["layers"][1]["kernel"], p["bns"][1]["scale"], p["bns"][2]["bias"]]
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        pp = {"layers": [p["layers"][0], {"kernel": leaves[0]}, p["layers"][2]],
              "bns": [p["bns"][0], {"scale": leaves[1], "bias": p["bns"][1]["bias"]},
                      {"scale": p["bns"][2]["scale"], "bias": leaves[2]}],
              "out": p["out"]}
        Pg, Lg = P_e.clone().requires_grad_(True), L_e.clone().requires_grad_(True)
        fn = st.pair_logits_dense_decomposed_reference if ref else \
            st.pair_logits_dense_decomposed
        logits, new = fn(pp, s, Pg, Lg, example_mask=em, label_mask=lm)
        (torch.sigmoid(logits) * em[:, None] * lm[None, :]).square().sum().backward()
        res[ref] = (logits, new, [Pg.grad, Lg.grad] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    (lg, new, grads), (lg0, new0, grads0) = res[False], res[True]
    torch.testing.assert_close(lg, lg0, rtol=0, atol=3e-2)
    for a, b in zip(new["bns"], new0["bns"]):
        torch.testing.assert_close(a["mean"], b["mean"], rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(a["var"], b["var"], rtol=1e-3, atol=1e-4)
    for a, b in zip(grads, grads0):
        scale_ = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=5e-2 * scale_)


def _close_sums(got, want):
    got, want = got.detach().float(), want.detach().float()
    scale_ = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * max(scale_, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1505, 8])
def test_streamed_bn_kernels_match_plain_on_card(N):
    """K6's three functions, forward and backward through autograd, on the
    same inputs as their plain versions: masked rows, a shift far from the
    mean, a quarter of the gates shut; the sums the same bits twice."""
    _card()
    rng = np.random.default_rng(10)
    H = 512
    z = _bf16(rng, N, H) + 1.0
    rows = torch.from_numpy((rng.random((N, 1)) < 0.9).astype(np.float32)).cuda()
    vec = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, H).astype(np.float32)).cuda()  # noqa
    r, inv, shift = vec(2.0, 3.0), vec(0.5, 1.5), vec(-1.2, 0.2)
    w = _bf16(rng, 1, H)[0]
    b = torch.tensor(0.3, device="cuda")
    cts = [torch.from_numpy(rng.normal(size=(H,)).astype(np.float32)).cuda() for _ in range(2)]
    dy, dout = _bf16(rng, N, H), torch.from_numpy(rng.normal(size=N).astype(np.float32)).cuda()
    outs = {}
    for ref in (False, True):
        sfx = "_reference" if ref else ""
        leaves = [t.clone().requires_grad_(True) for t in (z, inv, shift, w, b)]
        s1, s2 = getattr(st, "stream_moments" + sfx)(leaves[0], rows, r)
        y = getattr(st, "affine_relu" + sfx)(leaves[0], leaves[1], leaves[2])
        logits = getattr(st, "stream_head" + sfx)(*leaves)
        torch.autograd.backward((s1, s2, y, logits), (cts[0], cts[1], dy, dout))
        outs[ref] = [s1, s2, y, logits] + [t.grad for t in leaves]
    torch.cuda.synchronize()
    again = st._stream_moments_cuda(z, rows, r)
    assert torch.equal(again[0], outs[False][0]) and torch.equal(again[1], outs[False][1])
    for k, (a, b_) in enumerate(zip(outs[False], outs[True])):
        if a.dtype == torch.bfloat16:  # y, dz, dw
            torch.testing.assert_close(a.float(), b_.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        else:
            _close_sums(a, b_)
    assert float((outs[False][2] > 0).float().mean()) > 0.2


@pytest.mark.cuda
def test_streamed_bn_kernels_raise_on_what_they_do_not_take():
    _card()
    z = torch.zeros(4, 200, dtype=torch.bfloat16, device="cuda")
    v = torch.zeros(200, device="cuda")
    with pytest.raises(ValueError, match="multiple of 256"):
        st._affine_relu_cuda(z, v, v)
    z = torch.zeros(4, 256, device="cuda")
    v = torch.zeros(256, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        st._affine_relu_cuda(z, v, v)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", [False, True])
def test_streamed_scorer_kernels_match_plain_on_card(cache):
    """``pair_logits_streaming_train`` through K4 + K6 against its plain
    version (tiles of 64 over 203 labels, a masked sequence and masked
    labels): logits, new BN state and gradients; the kernels launched."""
    _card()
    rng = np.random.default_rng(11)
    d, H, B, L = 32, 256, 6, 203
    cfg = ProtNoteConfig(protein_embedding_dim=24, label_embedding_dim=16, latent_dim=d,
                         projection_head_num_layers=2, output_mlp_num_layers=3,
                         output_mlp_hidden_dim_scale_factor=H // d)
    p, s = init_protnote(torch.Generator().manual_seed(3), cfg)
    from protnote_tpu_torch.models.layers import tree_to
    from protnote_tpu_torch.train.optim import tree_leaves, tree_map

    p, s = tree_to(p["output_mlp"], "cuda"), tree_to(s["output_mlp"], "cuda")
    P_e, L_e = _bf16(rng, B, d), _bf16(rng, L, d)
    em = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.float32, device="cuda")
    lm = (torch.arange(L, device="cuda") < 190).float()
    res = {}
    for ref in (False, True):
        for k in st.LAUNCHES:
            st.LAUNCHES[k] = 0
        pp = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        Pg, Lg = P_e.clone().requires_grad_(True), L_e.clone().requires_grad_(True)
        fn = st.pair_logits_streaming_train_reference if ref else st.pair_logits_streaming_train
        logits, new = fn(pp, s, Pg, Lg, example_mask=em, label_mask=lm, label_tile=64,
                         cache_first=cache)
        (torch.sigmoid(logits) * em[:, None] * lm[None, :]).square().sum().backward()
        res[ref] = (logits, new, [Pg.grad, Lg.grad] + [t.grad for t in tree_leaves(pp)],
                    dict(st.LAUNCHES))
    torch.cuda.synchronize()
    (lg, new, grads, launches), (lg0, new0, grads0, launches0) = res[False], res[True]
    assert not any(launches0.values())
    assert all(launches[k] > 0 for k in ("pair_train_hidden", "pair_train_dx", "stream_moments",
                                         "stream_moments_backward", "affine_relu",
                                         "affine_relu_backward", "stream_head",
                                         "stream_head_backward"))
    assert launches["bn_relu_forward"] == launches["bn_relu_backward"] == 0
    torch.testing.assert_close(lg, lg0, rtol=0, atol=3e-2)
    for a, b in zip(new["bns"], new0["bns"]):
        torch.testing.assert_close(a["mean"], b["mean"], rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(a["var"], b["var"], rtol=1e-3, atol=1e-4)
    for a, b in zip(grads, grads0):
        scale_ = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=5e-2 * scale_)


def _int8(folded, P_e, L_e, static, label_tile):
    """The folded MLP quantized for K2, static scales calibrated on the
    inputs or dynamic."""
    scales = ps.calibrate_act_scales(folded, P_e, L_e, label_tile) if static else None
    return ps.quantize_folded(folded, act_scales=scales)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 1024])
@pytest.mark.parametrize("n_hidden", [1, 2, 3])
@pytest.mark.parametrize("static", [True, False])
def test_int8_kernel_matches_plain_on_card(monkeypatch, static, n_hidden, width):
    """K2, static and dynamic scales, 1-3 hidden layers (every epilogue),
    width 256 (every column in the row scales) and 1024 (the 1/8
    subsample), on the launch plan with chunks of 128 labels a sequence, the
    last (44 labels) ending mid-tile: the carried layer-1 rows of three
    chunks (one starting mid-tile) equal the plain version's bit for bit,
    the logits within 2e-2 (the w_out dot sums in another order, with
    atomics)."""
    dev = _card()
    monkeypatch.setattr(ps, "TARGET_ROWS", 128 * 5)
    rng = np.random.default_rng(10 * n_hidden + int(static))
    folded = _folded(rng, 16, width, n_hidden, dev)
    P_e = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    q = _int8(folded, P_e, L_e, static, 128)
    before = dict(ps.INT8_LAUNCHES)
    got = ps.pair_logits_tiled_int8(q, P_e, L_e, label_tile=128)
    want = ps.pair_logits_tiled_int8_reference(q, P_e, L_e, label_tile=128)
    torch.cuda.synchronize()
    launched = {k: ps.INT8_LAUNCHES[k] - before[k] for k in before}
    assert launched == {"pair_int8_layer": 3 * n_hidden, "pair_int8_codes": 3 if static else 0,
                        "pair_int8_row_scale": 0 if static else 3 * n_hidden}
    assert float(want.std()) > 0.3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-2, rtol=0)
    if n_hidden >= 2:
        for l0, nl in ((0, 128), (256, 44), (100, 77)):
            mine = ps.int8_carry_cuda(q, P_e, L_e, l0, nl)
            theirs = ps.int8_carry_reference(q, P_e, L_e, l0, nl)
            torch.cuda.synchronize()
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
            assert torch.equal(mine, theirs)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 1024])
def test_int8_code_passes_match_plain_on_card(width):
    """K2's code passes alone on a chunk that ends mid-tile: layer 1's
    static codes (``pair_int8_codes``) and the dynamic row scales and codes
    (``pair_int8_row_scale``, from a and c and from bf16 rows) equal their
    plain versions exactly."""
    dev = _card()
    rng = np.random.default_rng(width)
    folded = _folded(rng, 16, width, 2, dev)
    P_e = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    scales = ps.calibrate_act_scales(folded, P_e, L_e, 128)
    ch = ps.single_chunk_plan(3, width, 2, 30, 150).chunks[0]
    rows = 3 * ch.nl_pad
    x = torch.from_numpy(np.abs(rng.normal(size=(rows, width))).astype(np.float32)).to(
        dev, torch.bfloat16)
    for q in (ps.quantize_folded(folded, act_scales=scales), ps.quantize_folded(folded)):
        plan = ps.single_chunk_plan(3, width, 2, ch.l0, ch.nl)
        k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16, plan)
        with torch.cuda.device(dev):
            k.quantize(ch, 0)
        torch.cuda.synchronize()
        if q.act_scales is not None:
            want = ps.int8_codes_reference(k.a, k.c, ch, scales[0])
            assert torch.equal(k.codes[0][:rows], want)
            continue
        want_s, want = ps.int8_row_scale_reference(ps._chunk_inputs(k.a, k.c, ch).to(torch.bfloat16))
        assert torch.equal(k.codes[0][:rows], want) and torch.equal(k.row_scale[:rows], want_s)
        k.h[:rows] = x
        with torch.cuda.device(dev):
            k.quantize(ch, 1)
        torch.cuda.synchronize()
        want_s, want = ps.int8_row_scale_reference(x)
        assert torch.equal(k.codes[0][:rows], want) and torch.equal(k.row_scale[:rows], want_s)


@pytest.mark.cuda
def test_int8_kernel_raises_on_what_it_does_not_take():
    dev = _card()
    rng = np.random.default_rng(0)
    folded = _folded(rng, 16, 256, 2, dev)
    P_e = torch.randn(3, 16, device=dev).to(torch.bfloat16)
    L_e = torch.randn(40, 16, device=dev).to(torch.bfloat16)
    q = ps.quantize_folded(folded)
    with pytest.raises(ValueError, match="bfloat16"):
        ps.pair_logits_tiled_int8(q, P_e, L_e, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        ps.pair_logits_tiled_int8_cuda(q, P_e.cpu(), L_e)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _attention_inputs(rng, B, nh, T, hd, lengths, dev):
    def t():
        return torch.from_numpy(rng.normal(size=(B, nh, T, hd)).astype(np.float32)
                                * 1.5).to(dev, torch.bfloat16)

    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return t(), t(), t(), torch.from_numpy(mask).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 64, 77, 128, 129, 256, 510, 512])
def test_text_attention_kernel_matches_plain_on_card(T, causal):
    """K8a at T on both sides of its one-pass limit (128) and of its 64-key
    tiles, up to 512, bidirectional and causal; rows: a full one, a half
    one, an all-masked filler row (the uniform softmax, finite) and one whose
    first 70 keys are masked (causal: the rows before its first kept key see
    every key, and the kernel may skip no tile for them)."""
    dev = _card()
    hd = 64
    rng = np.random.default_rng(T + 1000 * causal)
    B = 4
    q, k, v, mask = _attention_inputs(rng, B, 4, T, hd, [T, max(T // 2, 1), 0, 0], dev)
    mask[3, min(70, T - 1):] = 1
    before = k8a.LAUNCHES
    got = k8a.masked_attention(q, k, v, mask, causal)
    want = k8a.masked_attention_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert k8a.LAUNCHES - before == 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-2
    # the all-masked row: the uniform softmax over all T keys, as JAX gives it
    uniform = v[2].float().mean(1, keepdim=True).expand(-1, T, -1)
    assert _rel_err(got[2], uniform) <= 1e-2


@pytest.mark.cuda
def test_text_attention_kernel_raises_on_what_it_does_not_take():
    dev = _card()
    rng = np.random.default_rng(0)
    q, k, v, mask = _attention_inputs(rng, 1, 2, 513, 64, [513], dev)
    with pytest.raises(ValueError, match="at most 512"):
        k8a.masked_attention(q, k, v, mask, False)
    q, k, v, mask = _attention_inputs(rng, 1, 2, 16, 64, [16], dev)
    with pytest.raises(ValueError, match="bfloat16"):
        k8a.masked_attention(q.float(), k.float(), v.float(), mask, False)
    with pytest.raises(ValueError, match="int32"):
        k8a.masked_attention(q, k, v, mask.long(), False)
    q, k, v, mask = _attention_inputs(rng, 1, 2, 16, 48, [16], dev)
    with pytest.raises(ValueError, match="head width"):
        k8a.masked_attention(q, k, v, mask, False)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1024, 768, 256])
@pytest.mark.parametrize("residual", [True, False])
def test_layer_norm_kernel_matches_plain_on_card(H, residual):
    """K8b with and without the residual add, a row count that is not a
    multiple of the block's 8 rows, and rows with a large offset (where a
    one-pass variance would cancel)."""
    dev = _card()
    rng = np.random.default_rng(H + int(residual))
    N = 1000 + 3

    def t(shift=0.0):
        return torch.from_numpy((rng.normal(size=(N, H)) * 2 + shift).astype(np.float32)
                                ).to(dev, torch.bfloat16)

    x = t(shift=50.0)
    r = t() if residual else None
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=H).astype(np.float32) * 0.1).to(dev)
    before = k8b.LAUNCHES
    got = k8b.add_layer_norm(x, r, scale, bias, 1e-5)
    want = k8b.add_layer_norm_reference(x, r, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert k8b.LAUNCHES - before == 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 512, 768, 1024, 1280, 1536, 1792, 2048])
@pytest.mark.parametrize("residual", [True, False])
def test_layer_norm_kernel_walks_rows_on_card(H, residual):
    """K8b's persistent warps walk 25,349 rows (more than three a warp at
    any occupancy; odd, so not a multiple of the grid's rows, which are a
    multiple of its 4-warp blocks), each with the next row's loads in
    flight; scale and bias in registers up to H 1024, read per row above."""
    dev = _card()
    rng = np.random.default_rng(H + 7 * int(residual))
    N = 25349
    x = torch.from_numpy((rng.normal(size=(N, H)) * 2 + 20).astype(np.float32)).to(
        dev, torch.bfloat16)
    r = _bf16(rng, N, H) if residual else None
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=H).astype(np.float32) * 0.1).to(dev)
    got = k8b.add_layer_norm(x, r, scale, bias, 1e-5)
    want = k8b.add_layer_norm_reference(x, r, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_layer_norm_kernel_raises_on_what_it_does_not_take():
    dev = _card()
    x = torch.zeros(4, 1024, device=dev, dtype=torch.bfloat16)
    ones = torch.ones(1024, device=dev)
    with pytest.raises(ValueError, match="multiples of 256"):
        k8b.add_layer_norm(x[:, :100].contiguous(), None, ones[:100], ones[:100], 1e-5)
    with pytest.raises(ValueError, match="bfloat16"):
        k8b.add_layer_norm(x.float(), None, ones, ones, 1e-5)
    with pytest.raises(ValueError, match="float32"):
        k8b.add_layer_norm(x, None, ones.to(torch.bfloat16), ones, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 16, 77, 128, 200, 512])
def test_text_attention_backward_kernels_match_plain_on_card(T, causal):
    """K8a-bwd (the one-pass kernel up to T 128, the two kernels above)
    against the plain backward at T from 1 to 512, bidirectional and causal;
    rows: a full one, a half one, an all-masked filler row (JAX's
    uniform-softmax gradient, finite) and one whose first 70 keys are
    masked.  dq, dk and dv within 2^-6 of the plain
    output's largest |value| (dP is rounded to bf16 on both sides from f32
    sums in other orders, so it can land a bf16 step apart; dS and the
    outputs carry that step)."""
    dev = _card()
    rng = np.random.default_rng(3 * T + causal)
    q, k, v, mask = _attention_inputs(rng, 4, 4, T, 64, [T, max(T // 2, 1), 0, 0], dev)
    mask[3, min(70, T - 1):] = 1
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(dev, torch.bfloat16)
    before = k8a.BWD_LAUNCHES
    got = k8a.masked_attention_backward(q, k, v, mask, causal, g)
    want = k8a.masked_attention_backward_reference(q, k, v, mask, causal, g)
    torch.cuda.synchronize()
    assert k8a.BWD_LAUNCHES - before == k8a.backward_launches(T)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape, name
        assert bool(torch.isfinite(a).all()), name
        # (at T 1 dq and dk are exactly 0: one key, so dS = 0)
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2.0 ** -6 * float(b.float().abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [16, 64, 100, 128])
def test_text_attention_one_pass_backward_matches_two_kernels_on_card(T, causal):
    """The one-pass kernel (one launch) at the T the tower trains at and
    below, against the plain backward and against the two-kernel form on
    the same tensors: 8 rows of lengths T, T / 2, 1, 0 (all-masked filler
    rows), two more all-masked ones and two whose first keys are masked;
    each gradient within 2^-6 of the plain gradient's largest |value|,
    finite, and the same bits on a second call."""
    dev = _card()
    rng = np.random.default_rng(7 * T + causal)
    lengths = [T, max(T // 2, 1), 1, 0, 0, 0, T, T]
    q, k, v, mask = _attention_inputs(rng, 8, 3, T, 64, lengths, dev)
    mask[6, : T // 3] = 0
    mask[7, : T - 1] = 0
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(dev, torch.bfloat16)
    before = k8a.BWD_LAUNCHES
    got = k8a.masked_attention_backward(q, k, v, mask, causal, g)
    again = k8a.masked_attention_backward(q, k, v, mask, causal, g)
    two = k8a.two_kernel_backward_cuda(q, k, v, mask, causal, g)
    want = k8a.masked_attention_backward_reference(q, k, v, mask, causal, g)
    torch.cuda.synchronize()
    assert k8a.BWD_LAUNCHES - before == 2  # one a call; the two-kernel form is not counted
    for name, a, a2, t2, b in zip(("dq", "dk", "dv"), got, again, two, want):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, a2), name
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2.0 ** -6 * scale, name
        assert float((t2.float() - b.float()).abs().max()) <= 2.0 ** -6 * scale, name


@pytest.mark.cuda
def test_text_attention_autograd_runs_the_backward_kernels_on_card():
    """With a gradient wanted, ``masked_attention`` launches K8a and, on the
    way back, K8a-bwd (at T 40 its one-pass kernel) once each."""
    dev = _card()
    rng = np.random.default_rng(11)
    q, k, v, mask = _attention_inputs(rng, 2, 2, 40, 64, [40, 9], dev)
    q.requires_grad_(True)
    before = (k8a.LAUNCHES, k8a.BWD_LAUNCHES)
    out = k8a.masked_attention(q, k, v, mask, False)
    (dq,) = torch.autograd.grad(out.float().sum(), [q])
    torch.cuda.synchronize()
    assert (k8a.LAUNCHES - before[0], k8a.BWD_LAUNCHES - before[1]) == (1, 1)
    want = k8a.masked_attention_backward_reference(q.detach(), k, v, mask, False,
                                                   torch.ones_like(out))[0]
    assert _rel_err(dq, want) <= 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 1024, 2048])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("N", [3, 25349])
def test_layer_norm_backward_kernels_match_plain_on_card(H, residual, N):
    """K8b-bwd from the forward kernel's saved mu and rstd: dx within 2^-6
    of the plain dx's largest |value| (one bf16 step of an output rounded
    once), dscale and dbias (float32 sums over the rows, in blocks, then in
    block order) to 1e-3 of theirs; the same bits on a second call (no
    float atomics)."""
    dev = _card()
    rng = np.random.default_rng(H + 5 * int(residual) + N)
    x = torch.from_numpy((rng.normal(size=(N, H)) * 2 + 20).astype(np.float32)).to(
        dev, torch.bfloat16)
    r = _bf16(rng, N, H) if residual else None
    g = _bf16(rng, N, H)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=H).astype(np.float32) * 0.1).to(dev)
    stats = torch.empty(N, 2, device=dev)
    k8b.add_layer_norm_cuda(x, r, scale, bias, 1e-5, stats)
    _, want_stats = k8b._reference_with_stats(x, r, scale, bias, 1e-5)
    assert _rel_err(stats, want_stats) <= 1e-5
    before = k8b.BWD_LAUNCHES
    got = k8b.add_layer_norm_backward(x, r, scale, stats, g)
    again = k8b.add_layer_norm_backward(x, r, scale, stats, g)
    want = k8b.add_layer_norm_backward_reference(x, r, scale, want_stats, g)
    torch.cuda.synchronize()
    assert k8b.BWD_LAUNCHES - before == 4  # two calls, each the rows and the reduction
    assert got[0].dtype == torch.bfloat16 and got[0].shape == x.shape
    assert _rel_err(got[0], want[0]) <= 2.0 ** -6
    assert _rel_err(got[1], want[1]) <= 1e-3 and _rel_err(got[2], want[2]) <= 1e-3
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_layer_norm_autograd_runs_the_backward_kernels_on_card():
    dev = _card()
    rng = np.random.default_rng(5)
    x = _bf16(rng, 64, 1024).requires_grad_(True)
    r = _bf16(rng, 64, 1024)
    scale = torch.ones(1024, device=dev, requires_grad=True)
    bias = torch.zeros(1024, device=dev, requires_grad=True)
    before = (k8b.LAUNCHES, k8b.BWD_LAUNCHES)
    y = k8b.add_layer_norm(x, r, scale, bias, 1e-5)
    dx, ds, db = torch.autograd.grad(y.float().sum(), [x, scale, bias])
    torch.cuda.synchronize()
    assert (k8b.LAUNCHES - before[0], k8b.BWD_LAUNCHES - before[1]) == (1, 2)
    assert ds.dtype == db.dtype == torch.float32
    assert float(db.sub(64.0).abs().max()) == 0.0


@pytest.mark.cuda
def test_backward_kernels_raise_on_what_they_do_not_take():
    dev = _card()
    rng = np.random.default_rng(0)
    q, k, v, mask = _attention_inputs(rng, 1, 2, 16, 64, [16], dev)
    with pytest.raises(ValueError, match="dctx"):
        k8a.masked_attention_backward(q, k, v, mask, False, q.float())
    x = torch.zeros(4, 1024, device=dev, dtype=torch.bfloat16)
    ones = torch.ones(1024, device=dev)
    with pytest.raises(ValueError, match="stats"):
        k8b.add_layer_norm_backward(x, None, ones, torch.zeros(3, 2, device=dev), x)


# ----------------------------------------------------------------------
# K7: the encoder's masked dilated conv chain

K7_LENGTHS = (200, 131, 40, 7, 0)


def _k7_conv(rng, taps, cin, cout, dev):
    bound = 1.0 / np.sqrt(cin * taps)
    return {"kernel": torch.from_numpy(rng.uniform(-bound, bound, (taps, cin, cout))
                                       .astype(np.float32)).to(dev),
            "bias": torch.from_numpy(rng.uniform(-0.3, 0.3, cout).astype(np.float32)).to(dev)}


def _k7_lengths(T, dev):
    return torch.tensor([min(n, T) for n in K7_LENGTHS], dtype=torch.int32, device=dev)


def _within(got, want, rel, name=""):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, f"{name}: max |diff| {err} > {rel} x {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("T", [40, 200, 512])
@pytest.mark.parametrize("dilation,taps,cin,cout,prologue", [
    (1, 9, 21, 110, False),   # conv1: an odd one-hot width
    (3, 9, 110, 56, True),    # a block's dilated conv
    (81, 9, 110, 56, True),   # taps beyond every sequence at T 40 and 200
    (1, 1, 56, 110, True),    # the 1 x 1 conv, with the residual
    (1, 9, 20, 1100, False),  # the full widths: conv1 on the one-hot
    (81, 9, 1100, 550, True),  # the last block's dilated conv
    (1, 1, 550, 1100, True),  # a 1 x 1 conv with the residual
])
def test_masked_conv_kernel_matches_plain_on_card(T, dilation, taps, cin, cout, prologue):
    """``masked_conv_forward`` against ``masked_conv_reference`` on the same
    bf16 tensors (5 sequences, lengths 200..0): the eval-mode BN prologue,
    the residual add, masked rows exactly 0 (or the residual).  The inputs
    are contiguous, so a width that is not a multiple of 8 goes through the
    wrapper's copy to a padded pitch; the output comes at that pitch."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(dilation * 10 + taps + T)
    p = _k7_conv(rng, taps, cin, cout, dev)
    x = _bf16(rng, len(K7_LENGTHS), T, cin)
    lengths = _k7_lengths(T, dev)
    bn = residual = None
    if prologue:
        bn = (torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32)).to(dev),
              torch.from_numpy(rng.normal(0, 0.5, cin).astype(np.float32)).to(dev))
    if taps == 1:
        residual = _bf16(rng, len(K7_LENGTHS), T, cout)
    w, b = p["kernel"].to(torch.bfloat16), p["bias"].to(torch.bfloat16)
    before = k7.LAUNCHES["masked_conv_fwd"]
    got = k7.masked_conv_cuda(x, w, b, lengths, dilation, bn, residual)
    want = k7.masked_conv_reference(x, w, b, lengths, dilation, bn, residual)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_conv_fwd"] == before + 1
    assert got.stride(1) == k7.row_pitch(cout)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    pad = torch.arange(T, device=dev)[None, :] >= lengths[:, None].long()
    tail = got[pad].float()
    assert torch.equal(tail, torch.zeros_like(tail) if residual is None
                       else residual[pad].float())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [40, 512])
@pytest.mark.parametrize("dilation,taps,cin,cout", [(1, 9, 21, 110), (27, 9, 110, 56),
                                                     (1, 1, 56, 110), (81, 9, 1100, 550),
                                                     (1, 1, 550, 1100)])
def test_masked_conv_backward_kernels_match_plain_on_card(T, dilation, taps, cin, cout):
    """``masked_conv_dx`` and ``masked_conv_dw`` (dW and dbias) against the
    plain chain's autograd on the same bf16 tensors, a cotangent nonzero on
    padded rows too (the output mask must stop it): each within 2^-6 of the
    plain gradient's largest |value|; dW the same bits on a second call."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(dilation + taps + T)
    p = _k7_conv(rng, taps, cin, cout, dev)
    x, dy = _bf16(rng, len(K7_LENGTHS), T, cin), _bf16(rng, len(K7_LENGTHS), T, cout)
    lengths = _k7_lengths(T, dev)
    w = p["kernel"].to(torch.bfloat16).requires_grad_(True)
    b = p["bias"].to(torch.bfloat16).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    k7.masked_conv_reference(xr, w, b, lengths, dilation).backward(dy)
    dx = k7.masked_conv_dx_cuda(dy, w.detach(), lengths, dilation)
    dw, db = k7.masked_conv_dw_cuda(x, dy, lengths, taps, dilation)
    dw2, _ = k7.masked_conv_dw_cuda(x, dy, lengths, taps, dilation)
    torch.cuda.synchronize()
    _within(dx, xr.grad, 2.0 ** -6, "dx")
    _within(dw, w.grad, 2.0 ** -6, "dw")
    _within(db, b.grad, 2.0 ** -6, "db")
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 300])
@pytest.mark.parametrize("dilation,taps,cin,cout", [(1, 9, 20, 1100), (81, 9, 1100, 550),
                                                     (3, 9, 1100, 550), (1, 1, 550, 1100),
                                                     (2, 5, 70, 130)])
def test_masked_conv_dw_matches_plain_and_cudnn_on_card(T, dilation, taps, cin, cout):
    """``masked_conv_dw`` on its TMA + wgmma kernel at ragged lengths (T, 0,
    1, T - 1, 129 clipped to T, 37) with the full widths' split counts (1, 2
    and 4 splits) and an odd shape: dW and dbias within 2^-6 of the plain
    autograd's largest |value| and of cuDNN's backward filter on the masked
    tensors (``torch.nn.grad.conv1d_weight``, the library's yardstick), the
    same bits on a second call, from contiguous inputs (copied to the
    padded pitch) and from padded ones alike."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(dilation + taps + cin + T)
    p = _k7_conv(rng, taps, cin, cout, dev)
    lengths = torch.tensor([min(n, T) for n in (T, 0, 1, T - 1, 129, 37)], dtype=torch.int32,
                           device=dev)
    x, dy = _bf16(rng, 6, T, cin), _bf16(rng, 6, T, cout)
    w = p["kernel"].to(torch.bfloat16).requires_grad_(True)
    b = p["bias"].to(torch.bfloat16).requires_grad_(True)
    k7.masked_conv_reference(x, w, b, lengths, dilation).backward(dy)
    before = k7.LAUNCHES["masked_conv_dw"]
    dw, db = k7.masked_conv_dw_cuda(x, dy, lengths, taps, dilation)
    dw2, db2 = k7.masked_conv_dw_cuda(k7.pad_pitch(x), k7.pad_pitch(dy), lengths, taps, dilation)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).to(torch.bfloat16)[..., None]
    lib = torch.nn.grad.conv1d_weight((x * mask).transpose(1, 2).float(), (cout, cin, taps),
                                      (dy * mask).transpose(1, 2).float(),
                                      padding=dilation * (taps - 1) // 2, dilation=dilation)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_conv_dw"] == before + 2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert bool(torch.isfinite(dw.float()).all())
    _within(dw, w.grad, 2.0 ** -6, "dw")
    _within(db, b.grad, 2.0 ** -6, "db")
    _within(dw, lib.permute(2, 1, 0), 2.0 ** -6, "dw vs cuDNN")


@pytest.mark.cuda
@pytest.mark.parametrize("example_mask", [False, True])
def test_masked_bn_relu_kernels_match_plain_on_card(example_mask):
    """K7-BN's forward (output, new running statistics) and backward (dx,
    dscale, dbias) against the plain ``batchnorm_train`` + ReLU under
    autograd, with the count rule's dropped rows."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(9)
    T, C = 200, 110
    lengths = _k7_lengths(T, dev)
    em = (torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0], device=dev) if example_mask else None)
    x = (_bf16(rng, len(K7_LENGTHS), T, C) + 0.5)
    g = _bf16(rng, len(K7_LENGTHS), T, C)
    p = {"scale": torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev),
         "bias": torch.from_numpy(rng.normal(0, 0.3, C).astype(np.float32)).to(dev)}
    s = {"mean": torch.full((C,), 0.2, device=dev), "var": torch.full((C,), 1.5, device=dev)}
    outs = {}
    for plain in (True, False):
        xg = x.clone().requires_grad_(True)
        pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        fn = k7.masked_bn_relu_reference if plain else k7.masked_bn_relu_train
        y, new = fn(xg, pg, s, lengths, em, 1e-3, 0.01)
        y.backward(g)
        outs[plain] = (y.detach(), new, xg.grad, pg["scale"].grad, pg["bias"].grad)
    torch.cuda.synchronize()
    (y, new, dx, ds, db), (y0, new0, dx0, ds0, db0) = outs[False], outs[True]
    torch.testing.assert_close(y.float(), y0.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    for k in ("mean", "var"):
        torch.testing.assert_close(new[k], new0[k], rtol=1e-5, atol=1e-6)
    _within(dx, dx0, 2.0 ** -6, "dx")
    _within(ds, ds0, 1e-3, "dscale")
    _within(db, db0, 1e-3, "dbias")
    assert float((y > 0).float().mean()) > 0.3


@pytest.mark.cuda
def test_masked_mean_pool_kernel_matches_plain_on_card():
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(11)
    feats = _bf16(rng, len(K7_LENGTHS), 512, 110)
    lengths = _k7_lengths(512, dev)
    got = k7.masked_mean_pool_cuda(feats, lengths)
    want = k7.masked_mean_pool_reference(feats, lengths)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert float(got[-1].abs().max()) == 0.0  # length 0: 0, not NaN


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_encoder_runs_no_cudnn_conv_on_card(monkeypatch, train):
    """``embed_from_ids`` on CUDA tensors with ``F.conv1d`` patched to raise:
    the eval path (and with ``train`` the train-mode path under autograd)
    runs through K7 alone, its launches rise, and the embeddings match the
    plain chain computed before the patch."""
    import torch.nn.functional as F

    from protnote_tpu_torch.models import proteinfer as tpi
    from protnote_tpu_torch.models.layers import tree_to
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    cfg = ProteInferConfig(output_channels=112, num_resnet_blocks=3,
                           compute_dtype=torch.bfloat16)
    params, state = init_proteinfer(torch.Generator().manual_seed(0), cfg)
    params, state = tree_to(params, dev), tree_to(state, dev)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 21, (5, 200))).to(dev)
    lengths = _k7_lengths(200, dev)
    em = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0], device=dev)
    onehot = tpi.one_hot_sequences(ids, cfg.input_channels, torch.bfloat16)
    want, _ = tpi.proteinfer_embed_reference(params, state, onehot, lengths, cfg, train, em)

    def refuse(*args, **kwargs):
        raise AssertionError("cuDNN conv1d on the card's path")

    monkeypatch.setattr(F, "conv1d", refuse)
    for k in k7.LAUNCHES:
        k7.LAUNCHES[k] = 0
    convs = [params["conv1"]] + [bp[k] for bp in params["blocks"]
                                 for k in ("conv_dilated", "conv_1x1")]
    leaves = [conv[k] for conv in convs for k in ("kernel", "bias")]
    for t in leaves:
        t.requires_grad_(train)
    got, new_state = tpi.embed_from_ids(params, state, ids, lengths, cfg, train=train,
                                        example_mask=em)
    if train:
        grads = torch.autograd.grad(got.sum(), leaves)
        assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_conv_fwd"] == 7 and k7.LAUNCHES["masked_mean_pool"] == 1
    if train:
        assert k7.LAUNCHES["masked_bn_relu_fwd"] == 6 and k7.LAUNCHES["masked_conv_dw"] == 7
        assert k7.LAUNCHES["masked_conv_dx"] == 6 and k7.LAUNCHES["masked_bn_relu_bwd"] == 6
        assert len(new_state["blocks"]) == 3
    _within(got.detach(), want, 5e-2, "pooled")


@pytest.mark.cuda
def test_masked_conv_kernels_raise_on_what_they_do_not_take():
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    x = torch.zeros(2, 16, 8, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 8, 6, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(6, device=dev, dtype=torch.bfloat16)
    lengths = torch.tensor([16, 3], device=dev)
    with pytest.raises(ValueError, match="kernel"):
        k7.masked_conv_cuda(x, w.float(), b, lengths, 1)
    with pytest.raises(ValueError, match="contiguous"):  # x at any pitch is copied; a bias not
        k7.masked_conv_cuda(x, w, torch.zeros(12, device=dev, dtype=torch.bfloat16)[::2],
                            lengths, 1)
    with pytest.raises(ValueError, match="MIXED_PRECISION"):
        k7.masked_conv(x.float(), {"kernel": w.float(), "bias": b.float()}, lengths, 1)
    ones = torch.ones(7, device=dev)
    with pytest.raises(ValueError, match="even"):
        k7.masked_bn_relu_train(torch.zeros(2, 16, 7, device=dev, dtype=torch.bfloat16),
                                {"scale": ones, "bias": ones}, {"mean": ones, "var": ones},
                                lengths, None, 1e-3, 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("dilation,taps,cin,cout,prologue", [
    (81, 9, 1100, 550, True), (1, 1, 550, 1100, True), (1, 9, 20, 1100, False)])
def test_masked_conv_padded_pitch_inputs_on_card(dilation, taps, cin, cout, prologue):
    """The chain's own layout: x and the residual at the padded pitch (a
    view of a wider buffer whose extra channels hold garbage the kernel must
    not read), lengths T, 0, 1, T - 1 and 129 at T 300 (< 324, the reach of
    the dilation-81 taps): the same bits as from contiguous inputs, and the
    plain version's values; dX from a padded dy against the plain autograd."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    T = 300
    rng = np.random.default_rng(dilation + cin)
    p = _k7_conv(rng, taps, cin, cout, dev)
    lengths = torch.tensor([T, 0, 1, T - 1, 129], dtype=torch.int32, device=dev)

    def padded(c):
        """(contiguous, the same values at the padded pitch)"""
        wide = _bf16(rng, 5, T, k7.row_pitch(c), scale=1e4)  # the padding holds garbage
        view = wide[..., :c]
        view.copy_(_bf16(rng, 5, T, c))
        return view.contiguous(), view

    x, x_pad = padded(cin)
    assert x_pad.stride(1) == k7.row_pitch(cin) and k7.pad_pitch(x_pad) is x_pad
    residual, res_pad = padded(cout)
    if taps != 1:
        residual = res_pad = None
    bn = None
    if prologue:
        bn = (torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32)).to(dev),
              torch.from_numpy(rng.normal(0, 0.5, cin).astype(np.float32)).to(dev))
    w, b = p["kernel"].to(torch.bfloat16), p["bias"].to(torch.bfloat16)
    got = k7.masked_conv_cuda(x_pad, w, b, lengths, dilation, bn, res_pad)
    again = k7.masked_conv_cuda(x, w, b, lengths, dilation, bn, residual)
    want = k7.masked_conv_reference(x, w, b, lengths, dilation, bn, residual)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    dy, dy_pad = padded(cout)
    wg, xr = w.clone().requires_grad_(True), x.clone().requires_grad_(True)
    k7.masked_conv_reference(xr, wg, b, lengths, dilation).backward(dy)
    dx = k7.masked_conv_dx_cuda(dy_pad, w, lengths, dilation)
    assert torch.equal(dx, k7.masked_conv_dx_cuda(dy, w, lengths, dilation))
    _within(dx, xr.grad, 2.0 ** -6, "dx")


@pytest.mark.cuda
def test_conv_entry_points_raise_on_a_pitch_off_16_bytes():
    """The C entry points themselves refuse an input pitch that is not a
    multiple of 8 channels (TMA reads rows that start on 16 bytes): CUDA's
    invalid-value error, raised by the launch helper, and no launch
    counted."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    B, T, cin, cout, taps = 2, 64, 21, 16, 3
    x = torch.zeros(B, T, cin, device=dev, dtype=torch.bfloat16)
    w = k7.conv_weight_layout(torch.zeros(taps, cin, cout, device=dev, dtype=torch.bfloat16),
                              dx=False)
    wdx = k7.conv_weight_layout(torch.zeros(taps, cin, cout, device=dev, dtype=torch.bfloat16),
                                dx=True)
    b = torch.zeros(cout, device=dev, dtype=torch.bfloat16)
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    plan = torch.from_numpy(k7.conv_tile_plan(lengths.cpu().numpy(), T, taps, 1, cout,
                                              False)).to(dev)
    y = torch.empty(B, T, 16, device=dev, dtype=torch.bfloat16)
    before = dict(k7.LAUNCHES)
    with pytest.raises(RuntimeError, match="masked_conv_forward launch failed"):
        k7._launch("masked_conv", "masked_conv_forward", "masked_conv_fwd", dev, x.data_ptr(),
                   w.data_ptr(), b.data_ptr(), None, None, None, lengths.data_ptr(),
                   plan.data_ptr(),
                   y.data_ptr(), B, T, cin, cout, cin, 16, 0, w.shape[2], w.shape[1], taps, 1,
                   len(plan), 1)
    dy = torch.zeros(B, T, cout + 2, device=dev, dtype=torch.bfloat16)  # pitch 18
    dx = torch.empty(B, T, cin, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="masked_conv_dx launch failed"):
        k7._launch("masked_conv_bwd", "masked_conv_dx", "masked_conv_dx", dev, dy.data_ptr(),
                   wdx.data_ptr(), lengths.data_ptr(), plan.data_ptr(), dx.data_ptr(), B, T,
                   cin, cout, cout + 2, cin, wdx.shape[2], wdx.shape[1], taps, 1, len(plan), 1)
    assert k7.LAUNCHES == before
