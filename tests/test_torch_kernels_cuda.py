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
|value|; the pool to 1e-5 (its transpose bit for bit); the encoder (3 blocks at
112 channels) through K7
within 5e-2 of the plain chain's largest pooled |value|.
K4, K4-bwd and K5 in float32 (pair_train_hidden_f32, csrc/pair_train_bwd_f32.cu,
bn_relu_forward_f32 / bn_relu_backward_f32) on the same float32 inputs: z,
da2, dc2, y, dz and the moments within 1e-5 of the plain float32 tensor's
largest |value| (the split's products, float32 sums in other orders); dW
within 2 x 2^-24 x sqrt(pair rows / 64) of its largest |value| where that
is more (the float32 additions of its 64-row stages, a random walk over the
depth: tests/test_torch_pair_train_f32.py holds the figure against float64),
against float64 on its 128 x 128 tiles (at full width four of them), and
past 65,536 pair rows within 1e-3 of the plain version's (cuBLAS float32 at
a million rows is itself up to 2.9e-4 of the largest |value| from float64);
K5's backward on the kernel's own statistics (a pre-activation within an
ulp of 0 gates differently under an inverse square root an ulp apart).
K6 and the dense scorer's kernels in float32 (the _f32 entries of
streamed_bn.cu, bn_relu.cu and pair_dense.cu, pair_train_prod_f32,
pair_train_dw_prod_f32) on the same float32 inputs: every output within
1e-5 of the plain float32 tensor's largest |value|, dW_prod against float64
at dW's figure; the dropout mask and kept values the same bits as the plain
version's on the kernel's own affine; the streamed and dense scorers'
logits and running statistics within 1e-5, their gradients within 1e-4
(train-mode BatchNorm's backward over float32 sums in other orders).
K1 and K2 in float32 (csrc/pair_scorer_f32.cu, pair_mlp_head_f32, K2's
float32 w_out) on the same float32 inputs: logits within 1e-5 of the plain
float32 chain's largest |logit| (the split product leaves out terms below
2^-24 of each product; the rest is float32 summation in other orders), and
no bf16 kernel launched.
K7 in float32 (eval mode) on the same float32 inputs: the conv within 1e-5
of the plain conv's largest |value| (cuDNN with TF32 off; only the order of
the float32 sums differs), masked rows exactly 0 (or the residual), the same
bits on a second call; the pool to 1e-5; the encoder with its float32 head
within 1e-4 of the plain chain's largest |value|.
K8a, K8a-bwd, K8b and K8b-bwd in float32 (csrc/text_attention_f32.cu, the
_f32 entries of csrc/layer_norm.cu) on the same float32 inputs: ctx, dq,
dk, dv, y, the saved statistics, dx, dscale and dbias within 1e-5 of the
plain float32 tensor's largest |value| (attention's products as 3xTF32 on
the tensor cores, K8b's FMA chains, float32 sums in other orders; the plain
products cuBLAS with TF32 off), also at attention scores of about +-27,
each kernel the same bits on a second call, and no bf16 form launched.
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
                             compute_dtype=torch.float16)


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


def _sweep_first_design(tmp_path):
    """K9's first update (``csrc/variants/threshold_sweep_v1.cu``), built
    with the port's nvcc flags: ``fn(hist, sweep, logits, labels, mask)``."""
    import ctypes
    import subprocess

    from protnote_tpu_torch.ops import kernels

    out = tmp_path / "libthreshold_sweep_v1.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR), "-o",
                    str(out), str(kernels.CSRC_DIR / "variants" / "threshold_sweep_v1.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.threshold_sweep_update.argtypes = [P] * 4 + [I] * 4 + [P, P]

    def update(hist, sweep, logits, labels, mask):
        B, Lb = logits.shape
        assert lib.threshold_sweep_update(
            logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), sweep.sorted.data_ptr(), B, Lb,
            sweep.num_labels, sweep.sorted.shape[0], hist.data_ptr(),
            torch.cuda.current_stream().cuda_stream) == 0
    return update


_T1024 = np.sort(np.random.default_rng(4).uniform(0, 1, 1024)).astype(np.float32)
_T1024[500] = _T1024[501]  # a duplicate


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", [
    np.arange(0.01, 1.0, 0.01, dtype=np.float32),
    np.array([0.7, 0.2, 0.5, 0.2, 0.95, 0.05, -0.1, 1.5], np.float32), _T1024],
    ids=["cli_99", "unsorted_duplicates", "t1024"])
def test_threshold_sweep_matches_plain_on_card(thresholds, tmp_path):
    """K9's update and finalize against the plain version (the lax.map
    loop) on the same tensors: 1,000 labels padded to 1,024 columns, 5
    batches with padded rows and a NaN logit each; the histogram equal to
    the first design's (one atomic add an element) after a flush of three
    batches' codes mid-evaluation and after the last two, at 99, 8 unsorted
    and 1,024 thresholds (three slot ranges)."""
    dev = _card()
    L = 1000
    rng = np.random.default_rng(len(thresholds))
    sweep = k9.SweepCounter(thresholds, L, dev)
    T = len(thresholds)
    plain = tuple(torch.zeros(T, L, dtype=torch.int32, device=dev) for _ in range(3))
    th = torch.from_numpy(thresholds).to(dev)
    first_update, first_hist = _sweep_first_design(tmp_path), torch.zeros_like(sweep.hist)
    before = dict(k9.LAUNCHES)
    for i, (lg, labels, mask) in enumerate(_sweep_batches(rng, thresholds, L, 1024, 5)):
        args = [torch.from_numpy(a).to(dev) for a in (lg, labels, mask)]
        sweep.update(*args)
        first_update(first_hist, sweep, *args)
        if i == 2:  # three batches' codes flushed at once, mid-evaluation
            sweep.flush()
            assert torch.equal(sweep.hist, first_hist)
        k9.count_reference(plain, *args, th)
    got = sweep.counts()  # flushes the last two batches' codes
    torch.cuda.synchronize()
    assert torch.equal(sweep.hist, first_hist)
    assert k9.LAUNCHES["update"] - before["update"] == 5
    assert k9.LAUNCHES["flush"] - before["flush"] == 2
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
    f16 = torch.float16
    a2, c2 = torch.zeros(2, 64, device=dev, dtype=f16), torch.zeros(3, 64, device=dev, dtype=f16)
    w = torch.zeros(64, 128, device=dev, dtype=f16)
    with pytest.raises(ValueError, match="bfloat16 or in float32"):
        st.pair_hidden(a2, c2, w)
    with pytest.raises(ValueError, match="all operands alike"):
        st.pair_hidden(a2.float(), c2.float(), w.to(torch.bfloat16))
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="multiples of 128"):
        st.pair_hidden(a2.to(bf16), c2.to(bf16), w.to(bf16))


K4_BWD_REL_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,K,N", [(5, 301, 128, 256), (1, 301, 256, 384), (3, 1, 128, 128),
                                     (4, 200, 384, 512), (2, 130, 256, 128), (7, 301, 384, 256),
                                     (32, 40, 512, 256), (32, 2048, 3072, 3072)])
def test_pair_train_backward_kernels_match_plain_on_card(B, L, K, N):
    """K4-bwd's two kernels through ``pair_hidden``'s backward (one launch
    each) against the plain backward: L not a multiple of 64 (the last label
    tile of each sequence ragged), one sequence, an odd B (the last pair's
    second sequence past B), one label, K an odd multiple of 128 (a half
    column tile), the 256- and the 128-column dW tile, small L (the pairs
    split into groups) and the streamed scorer's tile at full width; a
    second call gives the same bits."""
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
    again = st._pair_hidden_backward_cuda(a2, c2, w, dz)
    for got, second in zip((t.grad for t in leaves), again):
        assert torch.equal(got, second)


@pytest.mark.cuda
@pytest.mark.parametrize("block_n", [128, 256])
@pytest.mark.parametrize("pieces", [1, 3])
def test_pair_train_dw_column_tiles_on_card(block_n, pieces):
    """The dW kernel with each of its column tiles, through its entry point:
    every tile whole, and two tiles whole with the others cut into 3 ranges
    of label blocks (f32 slots added by the second pass), against the plain
    backward's dW."""
    _card()
    rng = np.random.default_rng(19)
    B, L, K, N = 2, 130, 256, 768
    a2, c2 = _bf16(rng, B, K), _bf16(rng, L, K)
    w = _bf16(rng, K, N, scale=0.2)
    dz = _bf16(rng, B * L, N)
    tiles = (K // 128) * (N // block_n)
    full = 0 if pieces == 1 else 2
    part = torch.empty(max(1, (tiles - full) * pieces), 128, block_n, device="cuda")
    dw = torch.empty(K, N, device="cuda", dtype=torch.bfloat16)
    err = st._dw_fn()(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(), part.data_ptr(),
                      dw.data_ptr(), B, L, K, N, block_n, full, pieces, 7,
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
    z = torch.zeros(4, 256, dtype=torch.float16, device="cuda")
    v = torch.zeros(256, device="cuda")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
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
@pytest.mark.parametrize("width", [128, 384, 768, 1024, 3072, 4096])
@pytest.mark.parametrize("batch", [1, 5, 32, 65, 256])
def test_int8_code_passes_match_plain_on_card(batch, width):
    """K2's code passes alone on a chunk that ends mid-tile (labels [30,
    180), padded to 256), at B 1 to 256 (sequence tiles of at most 32) and H
    128 to 4096 (stride 1 below 1024; at 768 and 4096 the scale kernel
    stages its sampled columns in two rounds, and at 4096 a later layer's
    row is read twice): layer 1's static codes
    (``pair_int8_codes``) and the dynamic row scales and codes
    (``pair_int8_row_scale``, from a and c and from bf16 rows of both signs)
    equal their plain versions exactly, and the padding rows are written."""
    dev = _card()
    rng = np.random.default_rng(width + batch)
    folded = _folded(rng, 16, width, 2, dev)
    P_e = torch.from_numpy(rng.normal(size=(batch, 16)).astype(np.float32)).to(
        dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    scales = ps.calibrate_act_scales(folded, P_e, L_e, 128)
    plan = ps.single_chunk_plan(batch, width, 2, 30, 150)
    ch = plan.chunks[0]
    rows = batch * ch.nl_pad
    gen = torch.Generator(device=dev).manual_seed(width + batch)
    x = torch.randn(rows, width, generator=gen, device=dev).to(torch.bfloat16)
    for q in (ps.quantize_folded(folded, act_scales=scales), ps.quantize_folded(folded)):
        k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16, plan)
        k.codes[0].fill_(99)
        with torch.cuda.device(dev):
            k.quantize(ch, 0)
        torch.cuda.synchronize()
        if q.act_scales is not None:
            want = ps.int8_codes_reference(k.a, k.c, ch, scales[0])
            assert torch.equal(k.codes[0][:rows], want)
            continue
        x1 = ps._chunk_inputs(k.a, k.c, ch).to(torch.bfloat16)
        want_s, want = ps.int8_row_scale_reference(x1)
        assert torch.equal(k.codes[0][:rows], want) and torch.equal(k.scales_of(ch, 0), want_s)
        k.h[:rows] = x
        k.codes[0].fill_(99)
        with torch.cuda.device(dev):
            k.quantize(ch, 1)
        torch.cuda.synchronize()
        want_s, want = ps.int8_row_scale_reference(x)
        assert torch.equal(k.codes[0][:rows], want) and torch.equal(k.scales_of(ch, 1), want_s)


@pytest.mark.cuda
def test_int8_kernel_raises_on_what_it_does_not_take():
    dev = _card()
    rng = np.random.default_rng(0)
    folded = _folded(rng, 16, 256, 2, dev)
    P_e = torch.randn(3, 16, device=dev).to(torch.bfloat16)
    L_e = torch.randn(40, 16, device=dev).to(torch.bfloat16)
    q = ps.quantize_folded(folded)
    with pytest.raises(ValueError, match="bfloat16"):
        ps.pair_logits_tiled_int8(q, P_e, L_e, compute_dtype=torch.float16)
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
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k8a.masked_attention(q.half(), k.half(), v.half(), mask, False)
    with pytest.raises(ValueError, match="share a dtype"):
        k8a.masked_attention(q.float(), k, v, mask, False)
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
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k8b.add_layer_norm(x.half(), None, ones, ones, 1e-5)
    with pytest.raises(ValueError, match="residual"):
        k8b.add_layer_norm(x.float(), x, ones, ones, 1e-5)
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


def _f32_attention_inputs(rng, T, dev, large=False):
    """B 4, nh 2, hd 64 float32: a full row, one whose first keys (70, or
    half of them) and last 9 are masked, an all-masked filler row and a
    ragged row.  ``large``: q and k rows of norm 15.4 around eight shared
    directions, so that scores reach about +-27 (inside +-29.7)."""
    q, k, v, g = (torch.from_numpy(rng.normal(size=(4, 2, T, 64)).astype(np.float32) * s).to(dev)
                  for s in (1.5, 1.5, 1.0, 0.5))
    if large:
        u = rng.normal(size=(8, 64))

        def rows(sign):
            x = u[rng.integers(0, 8, size=(4, 2, T))] * sign + 0.3 * rng.normal(size=(4, 2, T, 64))
            x = 15.4 * x / np.linalg.norm(x, axis=-1, keepdims=True)
            return torch.from_numpy(x.astype(np.float32)).to(dev)

        q, k = rows(1.0), rows(rng.choice([-1.0, 1.0], size=(4, 2, T, 1)))
    mask = torch.zeros(4, T, dtype=torch.int32, device=dev)
    mask[0] = 1
    mask[1, min(70, T // 2): T - 9] = 1
    mask[3, : int(rng.integers(1, T + 1))] = 1
    return q, k, v, g, mask


def _f32_attention_check(T, causal, large, seed):
    """K8a f32 and K8a-bwd f32 against their plain float32 versions: ctx,
    dq, dk, dv within 1e-5 of the plain tensor's largest |value|, the
    float32 counts moved by one forward and ``backward_launches`` a
    backward, the bf16 counts not; the same bits on a second call of each;
    the filler row JAX's uniform softmax."""
    dev = _card()
    rng = np.random.default_rng(seed)
    q, k, v, g, mask = _f32_attention_inputs(rng, T, dev, large)
    before = (k8a.LAUNCHES, k8a.BWD_LAUNCHES, k8a.F32_LAUNCHES, k8a.F32_BWD_LAUNCHES)
    got = k8a.masked_attention(q, k, v, mask, causal)
    grads = k8a.masked_attention_backward(q, k, v, mask, causal, g)
    torch.cuda.synchronize()
    after = (k8a.LAUNCHES, k8a.BWD_LAUNCHES, k8a.F32_LAUNCHES, k8a.F32_BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == \
        [0, 0, 1, k8a.backward_launches(T, torch.float32)]
    got_again = k8a.masked_attention(q, k, v, mask, causal)
    again = k8a.masked_attention_backward(q, k, v, mask, causal, g)
    want = k8a.masked_attention_reference(q, k, v, mask, causal)
    want_grads = k8a.masked_attention_backward_reference(q, k, v, mask, causal, g)
    torch.cuda.synchronize()
    for name, a, b in (("ctx", got, want), *zip(("dq", "dk", "dv"), grads, want_grads)):
        assert a.dtype == torch.float32 and a.shape == q.shape, name
        _within(a, b, 1e-5, name)
    assert torch.equal(got, got_again)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    uniform = v[2].mean(1, keepdim=True).expand(-1, T, -1)
    _within(got[2], uniform, 1e-5, "filler row")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [64, 128, 129, 200, 512])
def test_text_attention_f32_kernels_match_plain_on_card(T, causal):
    """K8a f32 (``masked_attention_f32``) and K8a-bwd f32 (one kernel up to
    128 tokens, the dQ and dK/dV kernels above) on float32 tensors against
    the plain float32 version (``Precision.HIGHEST``: cuBLAS with TF32
    off), full, ragged and all-masked rows (``_f32_attention_check``)."""
    _f32_attention_check(T, causal, False, T + 2 * causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [128, 512])
def test_text_attention_f32_kernels_at_large_scores_on_card(T, causal):
    """The same with scores of about +-27, where the split's error in a
    score reaches expf at 27 times its size."""
    _f32_attention_check(T, causal, True, 7 * T + causal)


@pytest.mark.cuda
def test_text_attention_f32_autograd_runs_the_f32_kernels_on_card():
    """With a gradient wanted on float32 tensors, ``masked_attention``
    launches K8a f32 and, on the way back, K8a-bwd f32 (one kernel at 128
    tokens)."""
    dev = _card()
    rng = np.random.default_rng(12)
    q, k, v, _, mask = _f32_attention_inputs(rng, 128, dev)
    q.requires_grad_(True)
    before = (k8a.F32_LAUNCHES, k8a.F32_BWD_LAUNCHES, k8a.LAUNCHES, k8a.BWD_LAUNCHES)
    out = k8a.masked_attention(q, k, v, mask, True)
    (dq,) = torch.autograd.grad(out.sum(), [q])
    torch.cuda.synchronize()
    after = (k8a.F32_LAUNCHES, k8a.F32_BWD_LAUNCHES, k8a.LAUNCHES, k8a.BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == \
        [1, k8a.backward_launches(128, torch.float32), 0, 0]
    want = k8a.masked_attention_backward_reference(q.detach(), k, v, mask, True,
                                                   torch.ones_like(out))[0]
    _within(dq, want, 1e-5, "dq")


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("N", [3, 2049])
def test_layer_norm_f32_kernels_match_plain_on_card(residual, N):
    """K8b f32 and K8b-bwd f32 at H 1024 on float32 rows with a large
    offset: y, the saved mu and rstd, dx, dscale and dbias within 1e-5 of
    the plain float32 tensor's largest |value|; the float32 counts move,
    the bf16 counts do not; the backward the same bits on a second call."""
    dev = _card()
    rng = np.random.default_rng(N + int(residual))
    H = 1024

    def t(shift=0.0):
        return torch.from_numpy((rng.normal(size=(N, H)) * 2 + shift).astype(np.float32)).to(dev)

    x, r, g = t(shift=20.0), t() if residual else None, t()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=H).astype(np.float32) * 0.1).to(dev)
    stats = torch.empty(N, 2, device=dev)
    before = (k8b.LAUNCHES, k8b.BWD_LAUNCHES, k8b.F32_LAUNCHES, k8b.F32_BWD_LAUNCHES)
    y = k8b.add_layer_norm_cuda(x, r, scale, bias, 1e-5, stats)
    got = k8b.add_layer_norm_backward(x, r, scale, stats, g)
    again = k8b.add_layer_norm_backward(x, r, scale, stats, g)
    want_y, want_stats = k8b._reference_with_stats(x, r, scale, bias, 1e-5)
    want = k8b.add_layer_norm_backward_reference(x, r, scale, want_stats, g)
    torch.cuda.synchronize()
    after = (k8b.LAUNCHES, k8b.BWD_LAUNCHES, k8b.F32_LAUNCHES, k8b.F32_BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [0, 0, 1, 4]
    assert y.dtype == got[0].dtype == torch.float32 and y.shape == got[0].shape == x.shape
    _within(y, want_y, 1e-5, "y")
    _within(stats, want_stats, 1e-5, "stats")
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        _within(a, b, 1e-5, name)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_layer_norm_f32_autograd_runs_the_f32_kernels_on_card():
    dev = _card()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(64, 1024)).astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.normal(size=(64, 1024)).astype(np.float32)).to(dev)
    x.requires_grad_(True)
    scale = torch.ones(1024, device=dev, requires_grad=True)
    bias = torch.zeros(1024, device=dev, requires_grad=True)
    before = (k8b.F32_LAUNCHES, k8b.F32_BWD_LAUNCHES, k8b.LAUNCHES, k8b.BWD_LAUNCHES)
    y = k8b.add_layer_norm(x, r, scale, bias, 1e-5)
    dx, ds, db = torch.autograd.grad(y.sum(), [x, scale, bias])
    torch.cuda.synchronize()
    after = (k8b.F32_LAUNCHES, k8b.F32_BWD_LAUNCHES, k8b.LAUNCHES, k8b.BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 2, 0, 0]
    assert dx.dtype == ds.dtype == db.dtype == torch.float32
    assert float(db.sub(64.0).abs().max()) == 0.0


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


def _padding(t, C):
    """The padding channels of a (B, T, C) tensor at row_pitch(C)."""
    from protnote_tpu_torch.ops import masked_conv as k7

    Bt, Tt, _ = t.shape
    P = k7.row_pitch(C)
    return torch.as_strided(t, (Bt, Tt, P - C), (Tt * P, P, 1), t.storage_offset() + C)


@pytest.mark.cuda
@pytest.mark.parametrize("example_mask", [False, True])
@pytest.mark.parametrize("C", [1100, 550])
@pytest.mark.parametrize("padded", [True, False])
def test_masked_bn_relu_kernels_match_plain_on_card(example_mask, C, padded):
    """K7-BN's forward (output, new running statistics) and backward (dx,
    dscale, dbias) against the plain ``batchnorm_train`` + ReLU under
    autograd, with the count rule's dropped rows, a length-0 and a
    full-length row, on inputs at the convs' padded pitch (1,104 / 552: views
    of wider buffers whose padding channels hold NaN, which must not reach a
    sum) and contiguous (which the wrappers copy to that pitch); y and dx at
    ``row_pitch(C)`` with zero padding channels, the same bits on a second
    call, two kernels a wrapper call (counted in the C library)."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(9 + C)
    T = 200
    lengths = _k7_lengths(T, dev)
    assert int(lengths.max()) == T and int(lengths.min()) == 0
    em = (torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0], device=dev) if example_mask else None)

    def act(shift=0.0):
        t = _bf16(rng, len(K7_LENGTHS), T, C) + shift
        if not padded:
            return t
        wide = torch.full((len(K7_LENGTHS), T, k7.row_pitch(C)), float("nan"), device=dev,
                          dtype=torch.bfloat16)
        wide[..., :C] = t
        return wide[..., :C]

    x, g = act(0.5), act()
    assert (k7.pitch_of(x) == k7.row_pitch(C)) == padded
    p = {"scale": torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev),
         "bias": torch.from_numpy(rng.normal(0, 0.3, C).astype(np.float32)).to(dev)}
    s = {"mean": torch.full((C,), 0.2, device=dev), "var": torch.full((C,), 1.5, device=dev)}
    outs = {}
    for plain in (True, False):
        xg = x.detach().requires_grad_(True)  # x's own layout
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
    assert bool(torch.isfinite(dx.float()).all())

    fwd = k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"], s["var"],
                                         lengths, em, 1e-3, 0.01)
    y1, _, _, stats, counts = fwd
    bwd = k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
    fwd2 = k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"], s["var"],
                                          lengths, em, 1e-3, 0.01)
    bwd2 = k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(fwd + bwd, fwd2 + bwd2))
    for t in (y1, bwd[0]):
        assert k7.pitch_of(t) == k7.row_pitch(C)
        assert bool((_padding(t, C) == 0).all())
    assert torch.equal(y1, y)
    before, kernels = dict(k7.LAUNCHES), k7.bn_kernels_launched()
    k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"], s["var"], lengths, em,
                                   1e-3, 0.01)
    k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
    torch.cuda.synchronize()
    assert k7.bn_kernels_launched() - kernels == 4  # two a wrapper call, counted in C
    assert k7.LAUNCHES["masked_bn_relu_fwd"] == before["masked_bn_relu_fwd"] + 1
    assert k7.LAUNCHES["masked_bn_relu_bwd"] == before["masked_bn_relu_bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padded", "contiguous"])
@pytest.mark.parametrize("C", [110, 1100])
@pytest.mark.parametrize("T", [512, 1024])
def test_masked_mean_pool_kernel_matches_plain_on_card(T, C, layout):
    """The pool at buckets 512 and 1,024 on an input at the padded pitch
    (16-byte loads) and a contiguous one (8 or 4 bytes a load): within 1e-5
    of the plain pool, the same bits on a second call, 0 for length 0."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(11)
    feats = _bf16(rng, len(K7_LENGTHS), T, C)
    if layout == "padded":
        feats = k7.pad_pitch(feats)
        assert feats.stride(1) == k7.row_pitch(C) != C or C % 8 == 0
    lengths = torch.tensor([T, 300, 40, 7, 0], dtype=torch.int32, device=dev)
    before = k7.LAUNCHES["masked_mean_pool"]
    got = k7.masked_mean_pool_cuda(feats, lengths)
    again = k7.masked_mean_pool_cuda(feats, lengths)
    want = k7.masked_mean_pool_reference(feats, lengths)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_mean_pool"] == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, again)
    assert float(got[-1].abs().max()) == 0.0  # length 0: 0, not NaN


@pytest.mark.cuda
@pytest.mark.parametrize("C", [110, 1100])
@pytest.mark.parametrize("T", [7, 512])
def test_masked_mean_pool_backward_kernel_matches_plain_on_card(T, C):
    """``masked_mean_pool_backward`` bit for bit against
    ``masked_mean_pool_backward_reference`` (signed zeros included), its
    padding channels 0, at the padded pitch; and the pool's autograd on the
    card launches it once and gives the same bits."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    g = torch.from_numpy(np.random.default_rng(12).normal(size=(5, C)).astype(np.float32)).to(dev)
    lengths = torch.tensor([T, min(T, 300), 4, T + 3, 0], dtype=torch.int32, device=dev)
    before = k7.LAUNCHES["masked_mean_pool_bwd"]
    got = k7.masked_mean_pool_backward_cuda(g, lengths, T)
    want = k7.masked_mean_pool_backward_reference(g, lengths, T, torch.bfloat16)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_mean_pool_bwd"] == before + 1
    assert got.stride() == (T * k7.row_pitch(C), k7.row_pitch(C), 1)
    assert torch.equal(got.contiguous().view(torch.int16), want.view(torch.int16))
    P = k7.row_pitch(C)
    pad = torch.as_strided(got, (5, T, P - C), (T * P, P, 1), got.storage_offset() + C)
    assert not pad.view(torch.int16).any()
    feats = _bf16(np.random.default_rng(13), 5, T, C).requires_grad_(True)
    (dx,) = torch.autograd.grad(k7.masked_mean_pool(feats, lengths), [feats], g)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_mean_pool_bwd"] == before + 2
    assert torch.equal(dx.contiguous().view(torch.int16), want.view(torch.int16))


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
def test_encoder_chain_makes_no_copies_around_the_batchnorms_on_card(monkeypatch):
    """One training step's encoder chain (3 blocks at 110 channels, the
    bottleneck 55: pitches 112 and 56) under autograd: every BatchNorm reads
    the conv output it follows and its cotangent (the next conv's dX) as they
    are, and the conv after it reads its y, its dX its dx (bn2) as they are;
    no ``aten::copy_`` of a (B, T, C) activation in the forward, and in the
    backward only the conv_1x1s' copies of their summed (contiguous)
    cotangent, one a block but the last, whose cotangent the pool's backward
    kernel writes at the padded pitch."""
    from torch.profiler import ProfilerActivity, profile

    from protnote_tpu_torch.models import proteinfer as tpi
    from protnote_tpu_torch.models.layers import tree_to
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    cfg = ProteInferConfig(output_channels=110, num_resnet_blocks=3,
                           compute_dtype=torch.bfloat16)
    params, state = init_proteinfer(torch.Generator().manual_seed(0), cfg)
    params, state = tree_to(params, dev), tree_to(state, dev)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 21, (5, 200))).to(dev)
    lengths = _k7_lengths(200, dev)
    leaves = [t for bp in params["blocks"] for part in bp.values() for t in part.values()]
    for t in leaves:
        t.requires_grad_(True)
    seen = {"conv_out": set(), "conv_in": set(), "dx_out": set(), "dy_in": set(),
            "bn_x": [], "bn_y": [], "bn_g": [], "bn_dx": []}
    calls = {name: getattr(k7, name) for name in (
        "masked_conv_cuda", "masked_conv_dx_cuda", "masked_conv_dw_cuda",
        "masked_bn_relu_forward_cuda", "masked_bn_relu_backward_cuda")}

    def conv(x, *args, **kwargs):
        seen["conv_in"].add(x.data_ptr())
        y = calls["masked_conv_cuda"](x, *args, **kwargs)
        seen["conv_out"].add(y.data_ptr())
        return y

    def conv_dx(dy, *args, **kwargs):
        seen["dy_in"].add(dy.data_ptr())
        dx = calls["masked_conv_dx_cuda"](dy, *args, **kwargs)
        seen["dx_out"].add(dx.data_ptr())
        return dx

    def conv_dw(x, dy, *args, **kwargs):
        seen["dy_in"].add(dy.data_ptr())
        return calls["masked_conv_dw_cuda"](x, dy, *args, **kwargs)

    def bn_fwd(x, *args):
        out = calls["masked_bn_relu_forward_cuda"](x, *args)
        seen["bn_x"].append(x.data_ptr())
        seen["bn_y"].append(out[0].data_ptr())
        return out

    def bn_bwd(x, dy, *args):
        out = calls["masked_bn_relu_backward_cuda"](x, dy, *args)
        seen["bn_g"].append(dy.data_ptr())
        seen["bn_dx"].append(out[0].data_ptr())
        return out

    for name, fn in (("masked_conv_cuda", conv), ("masked_conv_dx_cuda", conv_dx),
                     ("masked_conv_dw_cuda", conv_dw), ("masked_bn_relu_forward_cuda", bn_fwd),
                     ("masked_bn_relu_backward_cuda", bn_bwd)):
        monkeypatch.setattr(k7, name, fn)

    def copies(prof):
        return sorted(e.input_shapes[0][2] for e in prof.events()
                      if e.name == "aten::copy_" and e.input_shapes
                      and len(e.input_shapes[0]) == 3 and tuple(e.input_shapes[0][:2]) == (5, 200)
                      and e.input_shapes[0][2] in (110, 55))  # not the one-hot's cast

    shapes = dict(activities=[ProfilerActivity.CPU], record_shapes=True)
    with profile(**shapes) as fwd_prof:
        got, _ = tpi.embed_from_ids(params, state, ids, lengths, cfg, train=True)
        torch.cuda.synchronize()
    with profile(**shapes) as bwd_prof:
        grads = torch.autograd.grad(got.sum(), leaves)
        torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in grads)
    assert len(seen["bn_x"]) == len(seen["bn_g"]) == 6
    assert set(seen["bn_x"]) <= seen["conv_out"]  # the conv output as it is
    assert set(seen["bn_y"]) <= seen["conv_in"]  # read by the next conv as it is
    assert set(seen["bn_g"]) <= seen["dx_out"]  # the next conv's dX as it is
    assert set(seen["bn_dx"][::2]) <= seen["dy_in"]  # bn2's dx: conv_dilated's dy
    assert copies(fwd_prof) == []
    # the summed (contiguous) cotangent of blocks 1-2's conv_1x1; the last
    # block's comes from the pool's backward kernel at the padded pitch
    assert copies(bwd_prof) == [110] * 2


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
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k7.masked_conv(x.half(), {"kernel": w.half(), "bias": b.half()}, lengths, 1)
    # float32 with a gradient and train-mode BatchNorm in float32 run their
    # kernels (item 16c), held to the plain versions
    gen = torch.Generator(device=dev).manual_seed(3)
    xf = torch.randn(2, 16, 8, generator=gen, device=dev)
    pf = {"kernel": torch.randn(3, 8, 6, generator=gen, device=dev).requires_grad_(),
          "bias": torch.randn(6, generator=gen, device=dev).requires_grad_()}
    before = dict(k7.LAUNCHES)
    y = k7.masked_conv(xf, pf, lengths, 1)
    gk = torch.autograd.grad(y.sum(), [pf["kernel"], pf["bias"]])
    yr = k7.masked_conv_reference(xf, pf["kernel"], pf["bias"], lengths, 1)
    gr = torch.autograd.grad(yr.sum(), [pf["kernel"], pf["bias"]])
    assert k7.LAUNCHES["masked_conv_fwd_f32"] == before["masked_conv_fwd_f32"] + 1
    assert k7.LAUNCHES["masked_conv_dw_f32"] == before["masked_conv_dw_f32"] + 1
    _within(y, yr, 1e-5, "f32 y")
    for got, want, name in zip(gk, gr, ("dW", "dbias")):
        _within(got, want, 1e-5, f"f32 {name}")
    sp = {"scale": torch.ones(6, device=dev), "bias": torch.ones(6, device=dev)}
    ss = {"mean": torch.ones(6, device=dev), "var": torch.ones(6, device=dev)}
    xb = torch.randn(2, 16, 6, generator=gen, device=dev)
    yb, new = k7.masked_bn_relu_train(xb, sp, ss, lengths, None, 1e-3, 0.01)
    yb0, new0 = k7.masked_bn_relu_reference(xb, sp, ss, lengths, None, 1e-3, 0.01)
    assert k7.LAUNCHES["masked_bn_relu_fwd_f32"] == before["masked_bn_relu_fwd_f32"] + 1
    _within(yb, yb0, 1e-5, "f32 BN y")
    _within(new["var"], new0["var"], 1e-5, "f32 BN running var")
    ones = torch.ones(7, device=dev)
    with pytest.raises(ValueError, match="scale"):  # any C; a scale of another width raises
        k7.masked_bn_relu_train(torch.zeros(2, 16, 7, device=dev, dtype=torch.bfloat16),
                                {"scale": torch.ones(6, device=dev), "bias": ones},
                                {"mean": ones, "var": ones}, lengths, None, 1e-3, 0.01)
    with pytest.raises(ValueError, match="sequences"):
        k7.masked_bn_relu_train(torch.zeros(k7.BN_MAX_B + 1, 2, 7, device=dev,
                                            dtype=torch.bfloat16),
                                {"scale": ones, "bias": ones}, {"mean": ones, "var": ones},
                                torch.ones(k7.BN_MAX_B + 1, device=dev), None, 1e-3, 0.01)


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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [40, 300, 512])
@pytest.mark.parametrize("dilation,taps,cin,cout,prologue", [
    (1, 9, 20, 1100, False),   # conv1 on the one-hot
    (1, 9, 1100, 550, True),   # the dilated convs, with the eval BN prologue
    (81, 9, 1100, 550, True),  # taps beyond every sequence at T 40 and 300
    (1, 1, 550, 1100, True),   # the 1 x 1 conv, with the residual
    (3, 9, 21, 110, True),     # widths off 4 and 16 channels
])
def test_masked_conv_f32_kernel_matches_plain_on_card(T, dilation, taps, cin, cout, prologue):
    """``masked_conv_forward_f32`` against ``masked_conv_reference`` in
    float32 (TF32 off) on the same tensors (5 sequences, lengths 200..0):
    within 1e-5 of the largest |value|, masked rows exactly 0 (or the
    residual), the same bits on a second call, one launch a call."""
    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    gemm_precision(torch.float32)
    rng = np.random.default_rng(dilation * 10 + taps + T + cin)
    p = _k7_conv(rng, taps, cin, cout, dev)
    x = torch.from_numpy(rng.normal(size=(len(K7_LENGTHS), T, cin)).astype(np.float32)).to(dev)
    lengths = _k7_lengths(T, dev)
    bn = residual = None
    if prologue:
        bn = (torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32)).to(dev),
              torch.from_numpy(rng.normal(0, 0.5, cin).astype(np.float32)).to(dev))
    if taps == 1:
        residual = torch.from_numpy(
            rng.normal(size=(len(K7_LENGTHS), T, cout)).astype(np.float32)).to(dev)
    before = k7.LAUNCHES["masked_conv_fwd_f32"]
    got = k7.masked_conv_f32_cuda(x, p["kernel"], p["bias"], lengths, dilation, bn, residual)
    again = k7.masked_conv_f32_cuda(x, p["kernel"], p["bias"], lengths, dilation, bn, residual)
    want = k7.masked_conv_reference(x, p["kernel"], p["bias"], lengths, dilation, bn, residual)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_conv_fwd_f32"] == before + 2
    assert got.dtype == torch.float32 and got.stride(1) == k7.row_pitch(cout)
    _within(got, want, 1e-5, "y")
    assert torch.equal(got, again)
    pad = torch.arange(T, device=dev)[None, :] >= lengths[:, None].long()
    tail = got[pad]
    assert torch.equal(tail.abs(), torch.zeros_like(tail) if residual is None
                       else residual[pad].abs())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padded", "contiguous"])
@pytest.mark.parametrize("C", [110, 550, 1100])
@pytest.mark.parametrize("T", [512, 1024])
def test_masked_mean_pool_f32_kernel_matches_plain_on_card(T, C, layout):
    """``masked_mean_pool_f32`` on float32 activations at the padded pitch
    (16-byte loads) and contiguous (4-byte loads where C is not a multiple
    of 4): within 1e-5 of the plain pool, the same bits twice, 0 for length
    0."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    rng = np.random.default_rng(13)
    feats = torch.from_numpy(rng.normal(size=(5, T, C)).astype(np.float32)).to(dev)
    if layout == "padded":
        feats = k7.pad_pitch(feats)
    lengths = torch.tensor([T, 300, 40, 7, 0], dtype=torch.int32, device=dev)
    before = k7.LAUNCHES["masked_mean_pool_f32"]
    got = k7.masked_mean_pool_cuda(feats, lengths)
    again = k7.masked_mean_pool_cuda(feats, lengths)
    want = k7.masked_mean_pool_reference(feats, lengths)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_mean_pool_f32"] == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, again)
    assert float(got[-1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [40, 512])
@pytest.mark.parametrize("dilation,taps,cin,cout", [(1, 9, 21, 110), (27, 9, 110, 56),
                                                     (1, 1, 56, 110), (81, 9, 1100, 550),
                                                     (1, 1, 550, 1100), (1, 9, 20, 1100)])
def test_masked_conv_f32_backward_kernels_match_plain_on_card(T, dilation, taps, cin, cout):
    """``masked_conv_dx_f32`` against the plain float32 autograd (TF32 off)
    within 1e-5 of its largest |value|, zero past each length; ``masked_conv
    _dw_f32`` (dW, dbias) against float64 within 1e-5 (its depth's sums in
    another order), the same bits on a second call, from contiguous and from
    padded inputs alike."""
    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    gemm_precision(torch.float32)
    rng = np.random.default_rng(dilation + taps + T + cin)
    p = _k7_conv(rng, taps, cin, cout, dev)
    x = torch.from_numpy(rng.normal(size=(len(K7_LENGTHS), T, cin)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(size=(len(K7_LENGTHS), T, cout)).astype(np.float32)).to(dev)
    lengths = _k7_lengths(T, dev)
    before = dict(k7.LAUNCHES)
    dx = k7.masked_conv_dx_f32_cuda(dy, p["kernel"], lengths, dilation)
    dw, db = k7.masked_conv_dw_f32_cuda(x, dy, lengths, taps, dilation)
    dw2, db2 = k7.masked_conv_dw_f32_cuda(k7.pad_pitch(x), k7.pad_pitch(dy), lengths, taps,
                                          dilation)
    want = k7.masked_conv_backward_reference(x, p["kernel"], p["bias"], dy, lengths, dilation)
    truth = k7.masked_conv_backward_reference(x.double(), p["kernel"].double(),
                                              p["bias"].double(), dy.double(), lengths, dilation)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_conv_dx_f32"] == before["masked_conv_dx_f32"] + 1
    assert k7.LAUNCHES["masked_conv_dw_f32"] == before["masked_conv_dw_f32"] + 2
    assert dx.stride(1) == k7.row_pitch(cin)
    _within(dx, want[0], 1e-5, "dx")
    _within(dx, truth[0], 1e-5, "dx f64")
    pad = torch.arange(T, device=dev)[None, :] >= lengths[:, None].long()
    assert not bool(dx[pad].any())
    _within(dw, truth[1], 1e-5, "dw f64")
    _within(db, truth[2], 1e-5, "db f64")
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("example_mask", [False, True])
@pytest.mark.parametrize("C", [1100, 550])
def test_masked_bn_relu_f32_kernels_match_plain_on_card(example_mask, C):
    """K7-BN's float32 forms at the padded pitch against the plain float32
    BatchNorm + ReLU and its autograd: y and dx within 1e-5 of their largest
    |value| (the closed form against autodiff; no bf16 rounding), the
    running statistics within 1e-5, dscale and dbias within 1e-4 (sums over
    the rows in another order); the same bits twice; padding channels 0."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(C)
    B_, T_ = 8, 300
    lengths = torch.tensor([300, 255, 129, 64, 31, 1, 0, 200], dtype=torch.int32, device=dev)
    em = torch.ones(B_, device=dev)
    em[3] = 0.0
    em = em if example_mask else None
    x = k7.pad_pitch(torch.randn(B_, T_, C, generator=gen, device=dev) + 0.3)
    g = k7.pad_pitch(torch.randn(B_, T_, C, generator=gen, device=dev))
    p = {"scale": torch.rand(C, generator=gen, device=dev) + 0.5,
         "bias": 0.3 * torch.randn(C, generator=gen, device=dev)}
    s = {"mean": torch.zeros(C, device=dev), "var": torch.ones(C, device=dev)}
    before = dict(k7.LAUNCHES)
    y, mean, var, stats, counts = k7.masked_bn_relu_forward_cuda(
        x, p["scale"], p["bias"], s["mean"], s["var"], lengths, em, 1e-3, 0.01)
    dx, ds, db = k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
    again = k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"], s["var"],
                                           lengths, em, 1e-3, 0.01)
    xg = x.clone().requires_grad_(True)
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y0, new0 = k7.masked_bn_relu_reference(xg, pg, s, lengths, em, 1e-3, 0.01)
    dx0, ds0, db0 = torch.autograd.grad(y0, [xg, pg["scale"], pg["bias"]], g)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_bn_relu_fwd_f32"] == before["masked_bn_relu_fwd_f32"] + 2
    assert k7.LAUNCHES["masked_bn_relu_bwd_f32"] == before["masked_bn_relu_bwd_f32"] + 1
    assert y.dtype == dx.dtype == torch.float32
    _within(y, y0, 1e-5, "y")
    _within(mean, new0["mean"], 1e-5, "mean")
    _within(var, new0["var"], 1e-5, "var")
    _within(dx, dx0, 1e-5, "dx")
    _within(ds, ds0, 1e-4, "dscale")
    _within(db, db0, 1e-4, "dbias")
    assert torch.equal(y, again[0]) and torch.equal(mean, again[1])
    for t in (y, dx):
        assert not bool(_padding(t, C).any())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [110, 1100])
def test_masked_mean_pool_backward_f32_matches_plain_on_card(C):
    """``masked_mean_pool_backward_f32``: the plain float32 transpose bit for
    bit (signed zeros too), padding channels 0, at ``row_pitch(C)``."""
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = _card()
    g = torch.randn(5, C, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    lengths = torch.tensor([512, 300, 40, 1, 0], dtype=torch.int32, device=dev)
    got = k7.masked_mean_pool_backward_cuda(g, lengths, 512, torch.float32)
    want = k7.masked_mean_pool_backward_reference(g, lengths, 512, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.stride(1) == k7.row_pitch(C)
    assert torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))
    assert not bool(_padding(got, C).any())


@pytest.mark.cuda
def test_encoder_f32_training_chain_matches_plain_on_card():
    """The float32 encoder (3 blocks at 112 channels) in train mode with an
    example mask through K7's float32 kernels: every trained leaf's gradient
    under one cotangent within 1e-4 (L2) of the plain chain's, the running
    statistics within 1e-5; every float32 training kernel launched and no
    bf16 K7 kernel."""
    from protnote_tpu_torch.models import proteinfer as tpi
    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.train.optim import tree_leaves, tree_map

    dev = _card()
    gemm_precision(torch.float32)
    cfg = ProteInferConfig(output_channels=112, num_resnet_blocks=3, num_labels=300)
    params, state = init_proteinfer(torch.Generator().manual_seed(5), cfg)
    params, state = tree_map(lambda t: t.to(dev), params), tree_map(lambda t: t.to(dev), state)
    rng = np.random.default_rng(5)
    lens = np.array([512, 300, 77, 1, 0, 129], np.int32)
    aa = rng.integers(0, 20, size=(6, 512))
    aa[np.arange(512)[None, :] >= lens[:, None]] = 20
    aa, lengths = torch.from_numpy(aa).to(dev), torch.from_numpy(lens).to(dev)
    em = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.float32, device=dev)
    leaves = [t for k, v in params.items() if k != "output" for t in tree_leaves(v)]
    cot = torch.randn(6, 112, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    before = dict(k7.LAUNCHES)
    runs = []
    for embed in (tpi.embed_from_ids, None):
        for t in leaves:
            t.requires_grad_(True)
        if embed is None:
            onehot = tpi.one_hot_sequences(aa, 20)
            P, new = tpi.proteinfer_embed_reference(params, state, onehot, lengths, cfg, True, em)
        else:
            P, new = embed(params, state, aa, lengths, cfg, train=True, example_mask=em)
        runs.append((torch.autograd.grad((P * cot).sum(), leaves), tree_leaves(new)))
        for t in leaves:
            t.requires_grad_(False)
    torch.cuda.synchronize()
    launched = {k: k7.LAUNCHES[k] - before[k] for k in k7.LAUNCHES}
    assert launched == {**{k: 0 for k in k7.LAUNCHES}, "masked_conv_fwd_f32": 7,
                        "masked_conv_dx_f32": 6, "masked_conv_dw_f32": 7,
                        "masked_bn_relu_fwd_f32": 6, "masked_bn_relu_bwd_f32": 6,
                        "masked_mean_pool_f32": 1, "masked_mean_pool_bwd_f32": 1}
    (gk, sk), (gp, sp) = runs
    for a, b in zip(gk, gp):
        if float(b.norm()) > 0:
            assert float((a - b).norm() / b.norm()) <= 1e-4
    for a, b in zip(sk, sp):
        _within(a, b, 1e-5, "running statistics")


@pytest.mark.cuda
def test_proteinfer_forward_f32_runs_the_f32_kernels_on_card():
    """The float32 encoder and head (``proteinfer_forward``, 3 blocks at 112
    channels) through the float32 kernels against the plain chain: within
    1e-4 of the largest |logit|; every conv and the pool launched."""
    from protnote_tpu_torch.models import proteinfer as tpi
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.train.optim import tree_map

    dev = _card()
    cfg = ProteInferConfig(output_channels=112, num_resnet_blocks=3, num_labels=300)
    params, state = init_proteinfer(torch.Generator().manual_seed(4), cfg)
    params, state = tree_map(lambda t: t.to(dev), params), tree_map(lambda t: t.to(dev), state)
    rng = np.random.default_rng(4)
    lens = np.array([512, 300, 77, 1, 0], np.int32)
    aa = rng.integers(0, 20, size=(5, 512))
    aa[np.arange(512)[None, :] >= lens[:, None]] = 20
    aa, lengths = torch.from_numpy(aa).to(dev), torch.from_numpy(lens).to(dev)
    onehot = tpi.one_hot_sequences(aa, 20)
    before = dict(k7.LAUNCHES)
    with torch.inference_mode():
        got, _ = tpi.proteinfer_forward(params, state, onehot, lengths, cfg)
        want, _ = tpi.proteinfer_forward_reference(params, state, onehot, lengths, cfg)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["masked_conv_fwd_f32"] - before["masked_conv_fwd_f32"] == 7
    assert k7.LAUNCHES["masked_mean_pool_f32"] - before["masked_mean_pool_f32"] == 1
    assert k7.LAUNCHES["masked_conv_fwd"] == before["masked_conv_fwd"]
    _within(got, want, 1e-4, "logits")


# ----------------------------------------------------------------------
# the dense scorer (ops/dense_scorer.py): K5 with dropout and without BN,
# the first layer (pair_first_add, pair_train_prod), its backward
# (pair_side_sums, pair_train_dw_prod), and K1's prod and zero-hidden forms
#
# Tolerances: bf16 outputs within 2^-6 of the plain output's largest |value|
# (sums in other orders, then one rounding), float32 sums (moments, column
# sums, side sums) within 1e-3 of theirs; the keep mask the same bits; the
# logits of K1's forms to 2e-2 as K1's.

from protnote_tpu_torch.ops import dense_scorer as ds  # noqa: E402


def _close(got, want, frac=2.0 ** -6):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= frac * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_dense_act_kernels_match_plain_on_card(bn, rate):
    """K5's dense forms (centred BN or bias, ReLU, dropout) and their
    backward against the plain versions on the same bf16 inputs, 3,001 rows
    x 512 with masked rows."""
    dev = _card()
    gen = torch.Generator().manual_seed(31 + int(bn) + int(10 * rate))
    N, H = 3001, 512
    z = (torch.randn(N, H, generator=gen) + 0.5).to(dev, torch.bfloat16)
    rows = (torch.rand(N, 1, generator=gen) < 0.9).float().to(dev)
    n = rows.sum()
    scale = (0.5 + torch.rand(H, generator=gen)).to(dev)
    bias = (0.2 * torch.randn(H, generator=gen)).to(dev)
    dy = torch.randn(N, H, generator=gen).to(dev, torch.bfloat16)
    seed = torch.tensor([11, 22], dtype=torch.int64, device=dev)
    outs = []
    for fn in ((ds.bn_relu_dropout, ds.bn_relu_dropout_reference) if bn else
               (ds.bias_relu_dropout, ds.bias_relu_dropout_reference)):
        zz = z.clone().requires_grad_(True)
        sc, bi = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        if bn:
            y, mean, var = fn(zz, rows, n, sc, bi, seed, 1, rate)
            stats = [mean, var]
        else:
            y, stats = fn(zz, bi, seed, 1, rate), []
            sc = None
        y.backward(dy)
        outs.append((y.detach(), stats, zz.grad, None if sc is None else sc.grad, bi.grad))
    (y, st_k, dz, dsc, dbi), (y0, st_p, dz0, dsc0, dbi0) = outs
    _close(y, y0)
    _close(dz, dz0)
    for a, b in zip(st_k, st_p):
        _close(a, b, 1e-3)
    for a, b in ((dsc, dsc0), (dbi, dbi0)):
        if b is not None:
            _close(a, b, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 2])
def test_dropout_mask_same_bits_on_card(layer):
    """The kernels' keep mask is the plain hash's, bit for bit: the no-BN
    form on z = 1 keeps bf16(1 / keep) exactly where the mask keeps, forward
    and backward; the keep rate within 0.5% of 1 - rate."""
    dev = _card()
    N, H, rate = 4099, 768, 0.1
    z = torch.ones(N, H, dtype=torch.bfloat16, device=dev, requires_grad=True)
    bias = torch.zeros(H, device=dev)
    seed = torch.tensor([2**31 - 2, 12345], dtype=torch.int64, device=dev)
    y = ds.bias_relu_dropout(z, bias, seed, layer, rate)
    y.backward(torch.ones_like(y))
    mask = ds.keep_mask(seed.cpu(), layer, rate, torch.arange(N)[:, None],
                        torch.arange(H)[None, :]).to(dev)
    kept = torch.tensor(1.0 / ds.keep_scale(rate, torch.bfloat16)).to(torch.bfloat16)
    assert torch.equal(y != 0, mask) and torch.equal(z.grad != 0, mask)
    assert bool((y[mask] == kept.to(dev)).all()) and bool((z.grad[mask] == kept.to(dev)).all())
    assert abs(float(mask.float().mean()) - (1 - rate)) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("prod", [False, True])
def test_dense_first_layer_matches_plain_on_card(prod):
    """The first layer (pair_first_add, or pair_train_prod with its
    epilogue) and its backward (the side sums, dW_prod, dJ's weighted side
    sums) against the plain version, 5 sequences x 301 labels, d 256, H 512;
    the side sums the same bits on a second call."""
    dev = _card()
    gen = torch.Generator().manual_seed(41 + int(prod))
    B, L, d, H = 5, 301, 256, 512
    a = torch.randn(B, H, generator=gen).to(dev)
    c = torch.randn(L, H, generator=gen).to(dev)
    P_e = torch.randn(B, d, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(L, d, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(d, H, generator=gen) / 16).to(dev) if prod else None
    dz = torch.randn(B * L, H, generator=gen).to(dev, torch.bfloat16)
    outs = []
    for fn in (ds.pair_first_layer, ds.pair_first_layer_reference):
        leaves = [t.clone().requires_grad_(True) for t in (a, c, P_e, L_e)]
        wg = None if w is None else w.clone().requires_grad_(True)
        z = fn(*leaves, wg)
        z.backward(dz)
        outs.append([z.detach()] + [t.grad for t in leaves] + [None if wg is None else wg.grad])
    for i, (k, p) in enumerate(zip(*outs)):
        if p is None:
            assert k is None or not prod
            continue
        _close(k, p, 1e-3 if i in (1, 2) else 2.0 ** -6)
    sb, sl = ds.side_sums_cuda(dz, B, L)
    sb2, sl2 = ds.side_sums_cuda(dz, B, L)
    assert torch.equal(sb, sb2) and torch.equal(sl, sl2)


def _first_design(tmp_path, source: str, symbols: dict):
    """A variant source of ``csrc/variants`` (a kernel's first design),
    built with the port's nvcc flags: the CDLL, each symbol's argtypes set."""
    import ctypes
    import subprocess

    from protnote_tpu_torch.ops import kernels

    out = tmp_path / f"lib{source}.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR), "-o",
                    str(out), str(kernels.CSRC_DIR / "variants" / f"{source}.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in symbols.items():
        getattr(lib, name).argtypes = argtypes
    return lib


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L", [301, 64, 7])
def test_side_sums_match_first_design_on_card(tmp_path, dtype, L):
    """``pair_side_sums`` (x read once) against its first design
    (``csrc/variants/pair_dense_v1.cu``) and the plain sums, 5 sequences x L
    labels x 512 columns, plain and weighted: sl the first design's bits, sb
    within 1e-5 of its largest |value| (float32 sums of the same products in
    another order), the same bits on a second call."""
    import ctypes

    from protnote_tpu_torch.ops.streaming_train import _chunks

    dev = _card()
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sym = "pair_side_sums" + ("_f32" if dtype == torch.float32 else "")
    first = _first_design(tmp_path, "pair_dense_v1", {sym: [P] * 6 + [I] * 4 + [LL, P]})
    gen = torch.Generator().manual_seed(L)
    B, K = 5, 512
    x = torch.randn(B * L, K, generator=gen).to(dev, dtype)
    u = torch.randn(B, K, generator=gen).to(dev, dtype)
    v = torch.randn(L, K, generator=gen).to(dev, dtype)
    for uu, vv in ((None, None), (u, v)):
        chunks, per = _chunks(L)
        sb1, sl1 = torch.empty(B, K, device=dev), torch.empty(L, K, device=dev)
        part = torch.empty(chunks, B * K, device=dev)
        assert getattr(first, sym)(
            x.data_ptr(), None if uu is None else uu.data_ptr(),
            None if vv is None else vv.data_ptr(), part.data_ptr(), sb1.data_ptr(),
            sl1.data_ptr(), B, L, K, chunks, per, torch.cuda.current_stream().cuda_stream) == 0
        x3 = x.float().view(B, L, K)
        want_b = (x3 * (1.0 if vv is None else vv.float()[None])).sum(1)
        sb, sl = ds.side_sums_cuda(x, B, L, uu, vv)
        sb2, sl2 = ds.side_sums_cuda(x, B, L, uu, vv)
        assert torch.equal(sl, sl1) and torch.equal(sb, sb2) and torch.equal(sl, sl2)
        _close(sb, sb1, 1e-5)
        _close(sb, want_b, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("serving,B", [(False, 5), (True, 5), (False, 2), (True, 1)])
def test_prod_matches_first_design_on_card(tmp_path, serving, B):
    """``pair_train_prod`` (64-row tiles a warpgroup, c by TMA) against its
    first design (``csrc/variants/pair_train_prod_v1.cu``), B sequences (5
    and 1: an odd pair; 2: one pair) x 301 labels, d 256, H 512: the same
    bits, in the training form and in K1's serving form (ReLU, 384 rows a
    sequence: the padded rows hold relu(a[b])); within 2^-6 of the plain
    version."""
    import ctypes

    dev = _card()
    P, I = ctypes.c_void_p, ctypes.c_int
    first = _first_design(tmp_path, "pair_train_prod_v1",
                          {"pair_train_prod": [P] * 6 + [I] * 8 + [P]})
    gen = torch.Generator().manual_seed(43 + int(serving))
    L, d, H = 301, 256, 512
    Lz = 384 if serving else L
    a = torch.randn(B, H, generator=gen).to(dev)
    c = torch.randn(L, H, generator=gen).to(dev)
    P_e = torch.randn(B, d, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(L, d, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(d, H, generator=gen) / 16).to(dev, torch.bfloat16)
    wt = w.t().contiguous()
    nan = float("nan")
    got = torch.full((B * Lz, H), nan, dtype=torch.bfloat16, device=dev)
    ds.pair_prod_cuda(a, c, P_e, L_e, w, relu=serving, out=got, rows_per_seq=Lz, wt=wt)
    want = torch.full_like(got, nan)
    assert first.pair_train_prod(P_e.data_ptr(), L_e.data_ptr(), wt.data_ptr(), a.data_ptr(),
                                 c.data_ptr(), want.data_ptr(), B, L, Lz, d, H, int(serving),
                                 256, 132, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    z = got.view(B, Lz, H)
    plain = (a[:, None] + c[None]) + ((P_e[:, None] * L_e[None]).float() @ w.float())
    if serving:
        plain = torch.relu(plain)
        assert torch.equal(z[:, L:], torch.relu(a)[:, None].expand(B, Lz - L, H)
                           .to(torch.bfloat16))
    _close(z[:, :L], plain.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("prod", [False, True])
@pytest.mark.parametrize("n_hidden", [0, 1, 2])
def test_kernel_prod_and_zero_hidden_match_plain_on_card(prod, n_hidden):
    """K1's refused forms, now run: ``w1_prod`` (pair_train_prod's ReLU'd
    first layer into the workspace) and no hidden layer (pair_mlp_head),
    against the plain scorer at 4 sequences x 300 labels (three chunks, the
    last ragged), d 128, H 256: logits to 2e-2."""
    dev = _card()
    rng = np.random.default_rng(7 + 10 * n_hidden + int(prod))
    folded = _folded(rng, 128, 256, n_hidden, dev)
    if prod:
        folded.w1_prod = torch.from_numpy(
            (rng.normal(size=(128, 256)) / 8).astype(np.float32)).to(dev, torch.bfloat16)
    P_e = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 128)).astype(np.float32)).to(dev,
                                                                               torch.bfloat16)
    got = ps.pair_logits_tiled(folded, P_e, L_e)
    want = ps.pair_logits_tiled_reference(folded, P_e, L_e)
    assert float((got - want).abs().max()) <= 2e-2 and float(want.std()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("fusion,bn,rate,remat", [
    ("concatenation", True, 0.1, False), ("concatenation_prod", False, 0.1, True),
    ("concatenation_prod", True, 0.0, False),
])
def test_dense_scorer_matches_plain_on_card(fusion, bn, rate, remat):
    """The whole dense training scorer through its kernels against its plain
    version on the same device tensors, 4 sequences x 300 labels, d 256, H
    512: logits to 3e-2 and running statistics to 1e-3 (the decomposed
    scorer's card tolerances).  Gradients: both bf16 chains against the
    plain chain in float32, the kernels' no farther than twice the plain
    bf16 chain's distance plus 2^-6 of the leaf's largest |value|.  (Held
    to each other, a pre-activation that the prod GEMM's other summation
    order rounds one bf16 step away moves a first-layer gradient, which
    train-mode BatchNorm's backward leaves as a small difference of large
    sums, by more than 5% of its largest |value| at this size.)"""
    dev = _card()
    cfg = ProtNoteConfig(latent_dim=256, output_mlp_hidden_dim_scale_factor=2,
                         feature_fusion=fusion, output_mlp_batchnorm=bn,
                         compute_dtype=torch.bfloat16)
    p, s = init_protnote(torch.Generator().manual_seed(5), cfg)
    p, s = p["output_mlp"], s.get("output_mlp")
    for lin in p["layers"] + [p["out"]]:
        lin["kernel"] = lin["kernel"] * 6 ** 0.5
    gen = torch.Generator().manual_seed(6)
    P_e = torch.randn(4, 256, generator=gen)
    L_e = torch.randn(300, 256, generator=gen)
    lm = (torch.arange(300) < 290).float()
    w = torch.randn(4, 300, generator=gen)
    seed = torch.tensor([5, 6], dtype=torch.int64)
    runs = []
    for fn, dtype in ((ds.pair_logits_dense, torch.bfloat16),
                      (ds.pair_logits_dense_reference, torch.bfloat16),
                      (ds.pair_logits_dense_reference, torch.float32)):
        pp = {k: ([{kk: vv.to(dev).requires_grad_(True) for kk, vv in d.items()} for d in v]
                  if isinstance(v, list) else
                  {kk: vv.to(dev).requires_grad_(True) for kk, vv in v.items()})
              for k, v in p.items()}
        ss = None if s is None else {"bns": [{k: v.to(dev) for k, v in b.items()}
                                             for b in s["bns"]]}
        lg, new = fn(pp, ss, P_e.to(dev), L_e.to(dev), fusion, train=True, dropout=rate,
                     seed=seed.to(dev), label_mask=lm.to(dev), remat=remat,
                     compute_dtype=dtype)
        (lg * w.to(dev)).sum().backward()
        grads = [t.grad for v in pp.values() for d in (v if isinstance(v, list) else [v])
                 for t in d.values()]
        runs.append((lg.detach(), new, grads))
    (lg, new, grads), (lg0, new0, grads0), (_, _, grads32) = runs
    assert float((lg - lg0).abs().max()) <= 3e-2 and float(lg0.std()) > 0.3
    if bn:
        for a, b in zip(new["bns"], new0["bns"]):
            for k in ("mean", "var"):
                _close(a[k], b[k], 1e-3)
    for a, b, f in zip(grads, grads0, grads32):
        assert bool(torch.isfinite(a).all())
        far, near = float((a - f).abs().max()), float((b - f).abs().max())
        assert far <= 2 * near + 2.0 ** -6 * float(f.abs().max()), (far, near)


@pytest.mark.cuda
def test_int8_zero_hidden_runs_k1_head_on_card():
    """``PAIR_BACKEND tiled_int8`` with no hidden layer has no int8 product:
    its wrapper runs K1's head (``pair_mlp_head``), logits to 2e-2 of the
    plain int8 chain's."""
    dev = _card()
    rng = np.random.default_rng(91)
    q = ps.quantize_folded(_folded(rng, 128, 256, 0, dev))
    P_e = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 128)).astype(np.float32)).to(dev,
                                                                               torch.bfloat16)
    before = ps.HEAD_LAUNCHES
    got = ps.pair_logits_tiled_int8(q, P_e, L_e)
    want = ps.pair_logits_tiled_int8_reference(q, P_e, L_e)
    assert ps.HEAD_LAUNCHES > before
    assert float((got - want).abs().max()) <= 2e-2 and float(want.std()) > 0.1


# ----------------------------------------------------------------------
# K1 and K2 in float32 (MIXED_PRECISION False)

F32_REL_TOL = 1e-5


def _f32_folded(rng, d, width, n_hidden, device, prod=False):
    """:func:`_folded`'s weights in float32 (b_out float32), with a w1_prod."""
    f = _folded(rng, d, width, n_hidden, device)
    f32 = lambda t: t.float()  # noqa: E731
    w1_prod = None
    if prod:
        w1_prod = torch.from_numpy(rng.uniform(-1, 1, (d, width)).astype(np.float32)
                                   * np.float32(np.sqrt(6.0 / (3 * d)))).to(device)
    return ps.FoldedOutputMLP(w1_p=f32(f.w1_p), w1_l=f32(f.w1_l), b1=f32(f.b1), w1_prod=w1_prod,
                              hidden=[(f32(W), f32(b)) for W, b in f.hidden],
                              w_out=f32(f.w_out), b_out=f.b_out)


def _f32_close(got, want):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= F32_REL_TOL * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("width", [128, 384])
@pytest.mark.parametrize("n_hidden", [0, 1, 2, 3])
@pytest.mark.parametrize("prod", [False, True])
def test_f32_kernel_matches_plain_on_card(monkeypatch, prod, n_hidden, width, batch):
    """K1 in float32: every launch mode of ``pair_mlp_layer_f32`` (the first
    layer from a and c or the prod layer from P_e and L_e, workspaces
    between, the dot with w_out) and ``pair_mlp_head_f32`` with no hidden
    layer, at d 128, on 3 chunks of 300 labels (the last ragged), against
    ``pair_logits_tiled_reference`` in float32; no bf16 kernel runs."""
    dev = _card()
    monkeypatch.setattr(ps, "TARGET_ROWS", 128 * batch)
    rng = np.random.default_rng(1000 + 100 * n_hidden + width + batch + prod)
    folded = _f32_folded(rng, 128, width, n_hidden, dev, prod)
    P_e = torch.from_numpy(rng.normal(size=(batch, 128)).astype(np.float32)).to(dev)
    L_e = torch.from_numpy(rng.normal(size=(300, 128)).astype(np.float32)).to(dev)
    before = dict(ps.F32_LAUNCHES), ps.LAUNCHES, ps.HEAD_LAUNCHES
    got = ps.pair_logits_tiled(folded, P_e, L_e, label_tile=128, compute_dtype=torch.float32)
    want = ps.pair_logits_tiled_reference(folded, P_e, L_e, label_tile=128,
                                          compute_dtype=torch.float32)
    torch.cuda.synchronize()
    counts = {k: v - before[0][k] for k, v in ps.F32_LAUNCHES.items()}
    chunks = len(ps.launch_plan(batch, 300, width, max(n_hidden, 1)).chunks)
    assert counts["pair_mlp_layer_f32"] == chunks * n_hidden
    assert counts["pair_mlp_layer_f32_prod"] == (chunks if prod else 0)
    assert counts["pair_mlp_head_f32"] == (0 if n_hidden else (chunks if prod else 1))
    assert (ps.LAUNCHES, ps.HEAD_LAUNCHES) == before[1:]  # no bf16 kernel
    assert float(want.std()) > 0.1
    _f32_close(got, want)


@pytest.mark.cuda
def test_f32_kernel_at_full_width_on_card():
    """K1 in float32 at the default widths (d 1024, H 3072, two hidden
    layers) on 5 sequences x 300 labels, the plain chain's workspaces over
    the kernel's plan too (``pair_logits_plan_reference``)."""
    dev = _card()
    rng = np.random.default_rng(31)
    folded = _f32_folded(rng, 1024, 3072, 2, dev)
    P_e = torch.from_numpy(rng.normal(size=(5, 1024)).astype(np.float32)).to(dev)
    L_e = torch.from_numpy(rng.normal(size=(300, 1024)).astype(np.float32)).to(dev)
    got = ps.pair_logits_tiled(folded, P_e, L_e, compute_dtype=torch.float32)
    plan = ps.launch_plan(5, 300, 3072, 2)
    want = ps.pair_logits_plan_reference(folded, P_e, L_e, plan, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    _f32_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True])
def test_int8_f32_matches_plain_on_card(monkeypatch, static):
    """K2's float32 form (float32 side products, the last layer's dot with a
    float32 w_out) against ``pair_logits_tiled_int8_reference`` in float32
    on 3 chunks: the logits to 1e-5 of their largest |value| where every
    carried code agrees (the same codes as the bf16 form's tests check)."""
    dev = _card()
    monkeypatch.setattr(ps, "TARGET_ROWS", 128 * 5)
    rng = np.random.default_rng(7 + static)
    folded = _f32_folded(rng, 128, 256, 2, dev)
    P_e = torch.from_numpy(rng.normal(size=(5, 128)).astype(np.float32)).to(dev)
    L_e = torch.from_numpy(rng.normal(size=(300, 128)).astype(np.float32)).to(dev)
    scales = ps.calibrate_act_scales(folded, P_e, L_e) if static else None
    q = ps.quantize_folded(folded, act_scales=scales)
    before = dict(ps.F32_LAUNCHES), ps.INT8_LAUNCHES["pair_int8_layer"]
    got = ps.pair_logits_tiled_int8(q, P_e, L_e, compute_dtype=torch.float32)
    want = ps.pair_logits_tiled_int8_reference(q, P_e, L_e, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    name = "pair_int8_layer_f32" if static else "pair_int8_layer_f32_dynamic"
    assert ps.F32_LAUNCHES[name] - before[0][name] == 3 * 2
    assert ps.INT8_LAUNCHES["pair_int8_layer"] == before[1]
    _f32_close(got, want)


# ----------------------------------------------------------------------
# K4, K4-bwd and K5 in float32 (MIXED_PRECISION False)


def _f32t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to("cuda")


def _dw_f32_tol(rows: int) -> float:
    """dW's figure at a pair depth of ``rows``: 2 x 2^-24 x sqrt(rows / 64),
    at least F32_REL_TOL."""
    return max(F32_REL_TOL, 2 * 2.0 ** -24 * float(np.sqrt(rows / 64)))


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


DW_PLAIN_REL_TOL = 1e-3


def _dw_vs_float64(a2, c2, dz, dw, tiles) -> float:
    """dW's largest |error| against float64 on the 128 x 128 ``tiles`` (k0,
    n0), over its largest |value|."""
    err = 0.0
    for k0, n0 in tiles:
        x1 = torch.relu(a2[:, None, k0:k0 + 128] + c2[None, :, k0:k0 + 128]).reshape(-1, 128)
        truth = x1.double().T @ dz[:, n0:n0 + 128].double()
        err = max(err, float((dw[k0:k0 + 128, n0:n0 + 128].double() - truth).abs().max()))
    return err / float(dw.abs().max())


F32_TRAIN_KERNELS = ("pair_train_hidden_f32", "pair_train_dx_f32", "pair_train_dw_f32")


def _pair_train_f32_check(B, L, K, N, seed):
    from protnote_tpu_torch.models.layers import gemm_precision

    gemm_precision(torch.float32)
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(seed)
    a2, c2 = _f32t(rng, B, K), _f32t(rng, L, K)
    w = _f32t(rng, K, N, scale=(2.0 / K) ** 0.5)
    rows = torch.from_numpy((rng.random((B * L, 1)) < 0.9).astype(np.float32)).cuda()
    dz = _f32t(rng, B * L, N) * rows  # zero at masked pairs, as K5's backward leaves it
    leaves = [t.clone().requires_grad_(True) for t in (a2, c2, w)]
    before = dict(st.LAUNCHES)
    z = st.pair_hidden(*leaves)
    z.backward(dz)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in st.LAUNCHES.items() if v != before[k]}
    assert counts == {k: 1 for k in F32_TRAIN_KERNELS}, counts
    z = z.detach()
    assert z.dtype == torch.float32 and z.shape == (B * L, N)
    assert _rel(z, st._pair_hidden_fwd_plain(a2, c2, w)) <= F32_REL_TOL
    assert torch.equal(st._pair_hidden_fwd_cuda(a2, c2, w), z)
    del z
    want = st._pair_hidden_backward_plain(a2, c2, w, dz)
    grads = [t.grad for t in leaves]
    for name, got, ref in zip(("da2", "dc2", "dw"), grads, want):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert float(ref.abs().max()) > 0
        tol = F32_REL_TOL
        if name == "dw":
            tol = _dw_f32_tol(B * L) if B * L <= 65536 else DW_PLAIN_REL_TOL
        assert _rel(got, ref) <= tol, (name, _rel(got, ref), tol)
    del want
    tiles = [(k0, n0) for k0 in range(0, K, 128) for n0 in range(0, N, 128)]
    if B * L > 65536:
        tiles = [(0, 0), (K - 128, 0), (0, N - 128), (K - 128, N - 128)]
    assert _dw_vs_float64(a2, c2, dz, grads[2], tiles) <= _dw_f32_tol(B * L)
    again = st._pair_hidden_backward_cuda(a2, c2, w, dz)
    for got, second in zip(grads, again):
        assert torch.equal(got, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,K,N", [(5, 301, 128, 256), (1, 301, 256, 384), (3, 1, 128, 128),
                                     (4, 200, 384, 512), (2, 130, 256, 128), (7, 129, 128, 256),
                                     (32, 40, 512, 256)])
def test_pair_train_f32_kernels_match_plain_on_card(B, L, K, N):
    """K4's float32 forward and both float32 backward kernels through
    ``pair_hidden`` (one launch each, no bf16 K4) against the plain float32
    versions (TF32 off): L not a multiple of 128 (each sequence's last label
    tile ragged, a store of it must not reach the next sequence's rows), one
    sequence, one label, K an odd multiple of 128, small L with many
    sequences, dz zero at masked pairs; the same bits on a second call."""
    _card()
    _pair_train_f32_check(B, L, K, N, seed=B * 1000 + L)


@pytest.mark.cuda
def test_pair_train_f32_kernels_at_full_width_on_card():
    """The same at the training path's width: 32 sequences x 32,102 labels,
    K = N = 3072 (dW's depth 1,027,264 pair rows)."""
    _card()
    _pair_train_f32_check(32, 32102, 3072, 3072, seed=23)
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_pair_train_f32_shared_memory_matches_the_sources_on_card():
    """The shared memory each float32 launch asks for, as
    ``f32_train_smem_bytes`` lays it out from the sources, within the 227 KB
    a block may use."""
    import ctypes

    from protnote_tpu_torch.ops.kernels import load_kernel_library

    _card()
    fn = load_kernel_library("pair_train_bwd_f32").lib.pair_train_bwd_f32_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    want = st.f32_train_smem_bytes()
    assert (fn(0), fn(1)) == (want["dx"], want["dw"])
    assert max(want.values()) <= st.SMEM_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("N,H", [(1505, 512), (40001, 256)])
def test_bn_relu_f32_kernels_match_plain_on_card(N, H):
    """K5's float32 forward (y, mean, var) and backward (dz, dscale, dbias)
    against the plain versions on the same float32 inputs, with masked rows
    and a running mean far from the batch mean; the backward on the kernel's
    own statistics on both sides; no bf16 K5 launch."""
    _card()
    rng = np.random.default_rng(N + H)
    z = _f32t(rng, N, H) + 3.0
    rows = torch.from_numpy((rng.random((N, 1)) < 0.9).astype(np.float32)).cuda()
    n = rows.sum()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(0, 0.1, H).astype(np.float32)).cuda()
    running = torch.full((H,), 2.5, device="cuda")
    dy = _f32t(rng, N, H)
    before = dict(st.LAUNCHES)
    y, mean, var, istd, inv, shift = st._bn_relu_fwd_cuda(z, rows, n, scale, bias, running)
    y0, mean0, var0 = st._bn_relu_fwd_plain(z, rows, n, scale, bias, running)[:3]
    stats = (mean, istd, inv, shift)
    dz, ds, db = st._bn_relu_grads_cuda(z, dy, rows, n, scale, *stats)
    dz0, ds0, db0 = st._bn_relu_grads(z, dy, rows, n, scale, *stats)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in st.LAUNCHES.items() if v != before[k]}
    assert counts == {"bn_relu_forward_f32": 1, "bn_relu_backward_f32": 1}, counts
    assert y.dtype == dz.dtype == torch.float32
    for got, want in ((y, y0), (mean, mean0), (var, var0), (dz, dz0), (ds, ds0), (db, db0)):
        assert _rel(got, want) <= F32_REL_TOL
    assert float((y > 0).float().mean()) > 0.2
    again = st._bn_relu_grads_cuda(z, dy, rows, n, scale, *stats)
    assert all(torch.equal(a, b) for a, b in zip((dz, ds, db), again))


# ----------------------------------------------------------------------
# K6, the dense scorer's first layer and prod GEMMs, and K5's dense forms in
# float32 (MIXED_PRECISION False)


def _f32_launched(module, before):
    return {k: v - before[k] for k, v in module.LAUNCHES.items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1505, 8])
def test_streamed_bn_f32_kernels_match_plain_on_card(N):
    """K6's float32 forms, forward and backward through autograd, against
    their plain float32 versions on the same inputs (masked rows, a shift
    far from the mean, a quarter of the gates shut, the head's w float32):
    every output within 1e-5 of its largest |value|, one launch of each
    ``_f32`` entry and none of the bf16 forms; the sums the same bits on a
    second call."""
    _card()
    rng = np.random.default_rng(20 + N)
    H = 512
    z = _f32t(rng, N, H) + 1.0
    rows = torch.from_numpy((rng.random((N, 1)) < 0.9).astype(np.float32)).cuda()
    vec = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, H).astype(np.float32)).cuda()  # noqa
    r, inv, shift = vec(2.0, 3.0), vec(0.5, 1.5), vec(-1.2, 0.2)
    w = _f32t(rng, H)
    b = torch.tensor(0.3, device="cuda")
    cts = [_f32t(rng, H) for _ in range(2)]
    dy, dout = _f32t(rng, N, H), _f32t(rng, N)
    outs = {}
    before = dict(st.LAUNCHES)
    for ref in (False, True):
        sfx = "_reference" if ref else ""
        leaves = [t.clone().requires_grad_(True) for t in (z, inv, shift, w, b)]
        s1, s2 = getattr(st, "stream_moments" + sfx)(leaves[0], rows, r)
        y = getattr(st, "affine_relu" + sfx)(leaves[0], leaves[1], leaves[2])
        logits = getattr(st, "stream_head" + sfx)(*leaves)
        torch.autograd.backward((s1, s2, y, logits), (cts[0], cts[1], dy, dout))
        outs[ref] = [s1, s2, y, logits] + [t.grad for t in leaves]
        if not ref:
            counts = _f32_launched(st, before)
    torch.cuda.synchronize()
    assert counts == {f"{k}_f32": 1 for k in ("stream_moments", "stream_moments_backward",
                                              "affine_relu", "affine_relu_backward",
                                              "stream_head", "stream_head_backward")}, counts
    again = st._stream_moments_cuda(z, rows, r)
    assert torch.equal(again[0], outs[False][0]) and torch.equal(again[1], outs[False][1])
    for k, (a, b_) in enumerate(zip(outs[False], outs[True])):
        assert a.dtype == torch.float32 and a.shape == b_.shape
        assert _rel(a, b_) <= F32_REL_TOL, (k, _rel(a, b_))
    assert float((outs[False][2] > 0).float().mean()) > 0.2


@pytest.mark.cuda
def test_streamed_head_f32_takes_w_of_z_dtype_on_card():
    """The head's w has z's dtype: a bf16 w beside float32 z raises."""
    _card()
    z, v = torch.zeros(4, 256, device="cuda"), torch.zeros(256, device="cuda")
    with pytest.raises(ValueError, match="the head takes w"):
        st._stream_head_cuda(z, v, v, v.to(torch.bfloat16), torch.tensor(0.0, device="cuda"))


def _f32_output_mlp(d, H, seed, fusion="concatenation", bn=True):
    cfg = ProtNoteConfig(protein_embedding_dim=24, label_embedding_dim=16, latent_dim=d,
                         projection_head_num_layers=2, output_mlp_num_layers=3,
                         output_mlp_hidden_dim_scale_factor=H // d, feature_fusion=fusion,
                         output_mlp_batchnorm=bn)
    p, s = init_protnote(torch.Generator().manual_seed(seed), cfg)
    from protnote_tpu_torch.models.layers import tree_to

    p = tree_to(p["output_mlp"], "cuda")
    s = tree_to(s["output_mlp"], "cuda") if bn else None
    for lin in p["layers"] + [p["out"]]:
        lin["kernel"] = lin["kernel"] * 6 ** 0.5
    return p, s


def _f32_grads_close(grads, grads0, tol=1e-4):
    """Each gradient within ``tol`` of its plain float32 gradient's largest
    |value| (float32 sums in other orders, through train-mode BatchNorm's
    backward)."""
    for i, (a, b) in enumerate(zip(grads, grads0)):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert _rel(a, b) <= tol, (i, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("cache", [False, True])
def test_streamed_scorer_f32_matches_plain_on_card(cache):
    """``pair_logits_streaming_train`` in float32 through K4 f32, K4-bwd f32
    and K6 f32 against its plain float32 version (tiles of 64 over 203
    labels, a masked sequence and masked labels, H 256): logits and new
    running statistics within 1e-5 of their largest |value|, gradients
    within 1e-4; the launches ``streamed_launches(..., float32)`` says and
    no bf16 kernel."""
    _card()
    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.train.optim import tree_leaves, tree_map

    gemm_precision(torch.float32)
    rng = np.random.default_rng(12)
    d, H, B, L, tile = 32, 256, 6, 203, 64
    p, s = _f32_output_mlp(d, H, 3)
    P_e, L_e = _f32t(rng, B, d), _f32t(rng, L, d)
    em = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.float32, device="cuda")
    lm = (torch.arange(L, device="cuda") < 190).float()
    res = {}
    for ref in (False, True):
        before = dict(st.LAUNCHES)
        pp = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        Pg, Lg = P_e.clone().requires_grad_(True), L_e.clone().requires_grad_(True)
        fn = st.pair_logits_streaming_train_reference if ref else st.pair_logits_streaming_train
        logits, new = fn(pp, s, Pg, Lg, example_mask=em, label_mask=lm, label_tile=tile,
                         compute_dtype=torch.float32, cache_first=cache)
        (torch.sigmoid(logits) * em[:, None] * lm[None, :]).square().sum().backward()
        torch.cuda.synchronize()
        res[ref] = (logits, new, [Pg.grad, Lg.grad] + [t.grad for t in tree_leaves(pp)],
                    _f32_launched(st, before))
    (lg, new, grads, launches), (lg0, new0, grads0, launches0) = res[False], res[True]
    assert not launches0
    want = st.streamed_launches(3, -(-L // tile), cache, torch.float32)
    assert launches == {k: v for k, v in want.items() if v}, launches
    assert lg.dtype == torch.float32 and _rel(lg, lg0) <= F32_REL_TOL
    for a, b in zip(new["bns"], new0["bns"]):
        for k in ("mean", "var"):
            assert _rel(a[k], b[k]) <= F32_REL_TOL
    _f32_grads_close(grads, grads0)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_dense_act_f32_kernels_match_plain_on_card(bn, rate):
    """K5's dense float32 forms against their plain float32 versions on the
    same inputs, 3,001 rows x 512 with masked rows: y (and the moments), dz
    and dscale/dbias within 1e-5 of their largest |value|; the kept values
    and the mask the same bits as the plain version's on the kernel's own
    affine (the true float32 division), forward and backward."""
    dev = _card()
    gen = torch.Generator().manual_seed(61 + int(bn) + int(10 * rate))
    N, H = 3001, 512
    z = (torch.randn(N, H, generator=gen) + 0.5).to(dev)
    rows = (torch.rand(N, 1, generator=gen) < 0.9).float().to(dev)
    n = rows.sum()
    scale = (0.5 + torch.rand(H, generator=gen)).to(dev)
    bias = (0.2 * torch.randn(H, generator=gen)).to(dev)
    dy = torch.randn(N, H, generator=gen).to(dev)
    seed = torch.tensor([11, 22], dtype=torch.int64, device=dev)
    before = dict(ds.LAUNCHES)
    outs = []
    for fn in ((ds.bn_relu_dropout, ds.bn_relu_dropout_reference) if bn else
               (ds.bias_relu_dropout, ds.bias_relu_dropout_reference)):
        zz = z.clone().requires_grad_(True)
        sc, bi = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        if bn:
            y, mean, var = fn(zz, rows, n, sc, bi, seed, 1, rate)
            stats = [mean, var]
        else:
            y, stats = fn(zz, bi, seed, 1, rate), []
            sc = None
        y.backward(dy)
        outs.append((y.detach(), stats, zz.grad, None if sc is None else sc.grad, bi.grad))
        if len(outs) == 1:
            counts = _f32_launched(ds, before)
    name = "bn_relu_dropout" if bn else "bias_relu_dropout"
    assert counts == {f"{name}_forward_f32": 1, f"{name}_backward_f32": 1}, counts
    (y, st_k, dz, dsc, dbi), (y0, st_p, dz0, dsc0, dbi0) = outs
    assert y.dtype == dz.dtype == torch.float32
    for a, b in [(y, y0), (dz, dz0)] + list(zip(st_k, st_p)) + [(dsc, dsc0), (dbi, dbi0)]:
        if b is not None:
            assert _rel(a, b) <= F32_REL_TOL
    # the mask and the kept values, bit for bit, on the kernel's own affine
    if bn:
        f = ds._bn_relu_dropout_fwd_cuda(z, rows, n, scale, bias, seed, 1, rate)
        plain = ds._drop_plain(torch.relu(z * f[4] + f[5]), seed, 1, rate)
        assert torch.equal(f[0], plain)
    else:
        assert torch.equal(y, y0)
        dz1 = ds._bias_relu_dropout_grads_cuda(z, dy, bias, seed, 1, rate)[0]
        assert torch.equal(dz1, ds._bias_relu_dropout_grads_plain(z, dy, bias, seed, 1, rate)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_dense_bn_offset_columns_on_card(dtype, rate):
    """K5's dense BN forms on 3,001 rows x 512 whose second 256-column block
    sits 1e3 times its spread from 0 (either sign), with masked rows and a
    masked run covering whole tiles: the forward's moments the bits of
    ``dense_moments_emulation`` (the kernel's order of work on the CPU) and
    within 1e-5 of the plain version's largest |mean| (each var of its own
    column's); y, dz, dscale and dbias against the plain versions as
    ``test_dense_act*`` hold them (bf16 2^-6, the sums 1e-3; float32 1e-5,
    y on the kernel's own affine, the same bits: at |mean| / std = 1e3
    float32's z * inv + shift cancels ten bits, so the plain version's own
    moments, an ulp from any other sum's, move its y by ~1e-5 of its largest
    value); every output the same bits on a second run."""
    dev = _card()
    gen = torch.Generator().manual_seed(71 + int(dtype == torch.float32) + int(10 * rate))
    N, H = 3001, 512
    z = torch.randn(N, H, generator=gen) + 0.3
    spread = 10.0 ** (4 * torch.rand(256, generator=gen) - 2)
    sign = torch.where(torch.arange(256) % 2 == 0, 1.0, -1.0)
    z[:, 256:] = z[:, 256:] * spread + 1e3 * spread * sign
    z = z.to(dev, dtype)
    rows = (torch.rand(N, 1, generator=gen) < 0.9).float()
    rows[1000:1200] = 0.0
    rows = rows.to(dev)
    n = rows.sum()
    scale = (0.5 + torch.rand(H, generator=gen)).to(dev)
    bias = (0.2 * torch.randn(H, generator=gen)).to(dev)
    dy = torch.randn(N, H, generator=gen).to(dev, dtype)
    seed = torch.tensor([5, 6], dtype=torch.int64, device=dev)
    fwd = [ds._bn_relu_dropout_fwd_cuda(z, rows, n, scale, bias, seed, 1, rate) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    y, mean, var, istd, inv, shift = fwd[0]
    em, ev = ds.dense_moments_emulation(z.cpu(), rows.cpu(), n.cpu())
    assert torch.equal(mean.cpu(), em) and torch.equal(var.cpu(), ev)
    y0, mean0, var0 = ds._bn_relu_dropout_fwd_plain(z, rows, n, scale, bias, seed, 1, rate)[:3]
    for sl in (slice(0, 256), slice(256, 512)):
        assert float((mean[sl] - mean0[sl]).abs().max()) <= F32_REL_TOL * float(
            mean0[sl].abs().max())
        assert bool(((var[sl] - var0[sl]).abs() <= F32_REL_TOL * var0[sl]).all())
    if dtype == torch.bfloat16:
        _close(y, y0)
    else:
        assert torch.equal(y, ds._drop_plain(torch.relu(z * inv + shift), seed, 1, rate))
    stats = (mean, istd, inv, shift)
    bwd = [ds._bn_relu_dropout_grads_cuda(z, dy, rows, n, scale, *stats, seed, 1, rate)
           for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*bwd))
    want = ds._bn_relu_dropout_grads_plain(z, dy, rows, n, scale, *stats, seed, 1, rate)
    for got, ref, frac in zip(bwd[0], want, (2.0 ** -6, 1e-3, 1e-3)):
        if dtype == torch.bfloat16:
            _close(got, ref, frac)
        else:
            assert _rel(got, ref) <= F32_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("prod", [False, True])
def test_dense_first_layer_f32_matches_plain_on_card(prod):
    """The float32 first layer (pair_first_add_f32, or pair_train_prod_f32)
    and its backward (pair_side_sums_f32, pair_train_dw_prod_f32, dJ's
    weighted side sums) against the plain float32 version, 5 sequences x
    301 labels, d 256, H 512: each within 1e-5 of its largest |value|;
    dW_prod against float64; the side sums and dW_prod the same bits on a
    second call; no bf16 form launched."""
    dev = _card()
    from protnote_tpu_torch.models.layers import gemm_precision

    gemm_precision(torch.float32)
    gen = torch.Generator().manual_seed(71 + int(prod))
    B, L, d, H = 5, 301, 256, 512
    a = torch.randn(B, H, generator=gen).to(dev)
    c = torch.randn(L, H, generator=gen).to(dev)
    P_e = torch.randn(B, d, generator=gen).to(dev)
    L_e = torch.randn(L, d, generator=gen).to(dev)
    w = (torch.randn(d, H, generator=gen) / 16).to(dev) if prod else None
    dz = torch.randn(B * L, H, generator=gen).to(dev)
    before = dict(ds.LAUNCHES)
    outs = []
    for fn in (ds.pair_first_layer, ds.pair_first_layer_reference):
        leaves = [t.clone().requires_grad_(True) for t in (a, c, P_e, L_e)]
        wg = None if w is None else w.clone().requires_grad_(True)
        z = fn(*leaves, wg)
        z.backward(dz)
        outs.append([z.detach()] + [t.grad for t in leaves] + [None if wg is None else wg.grad])
        if len(outs) == 1:
            counts = _f32_launched(ds, before)
    want = ({"pair_train_prod_f32": 1, "pair_side_sums_f32": 2, "pair_train_dw_prod_f32": 1}
            if prod else {"pair_first_add_f32": 1, "pair_side_sums_f32": 1})
    assert counts == want, counts
    for i, (k, p) in enumerate(zip(*outs)):
        if p is None:
            assert k is None or not prod
            continue
        assert k.dtype == torch.float32 and _rel(k, p) <= F32_REL_TOL, (i, _rel(k, p))
    sb, sl = ds.side_sums_cuda(dz, B, L)
    sb2, sl2 = ds.side_sums_cuda(dz, B, L)
    assert torch.equal(sb, sb2) and torch.equal(sl, sl2)
    if prod:
        dw = outs[0][5]
        truth = (P_e.double()[:, None] * L_e.double()[None]).reshape(B * L, d).T @ dz.double()
        assert float((dw.double() - truth).abs().max() / truth.abs().max()) <= _dw_f32_tol(B * L)
        assert torch.equal(ds.dw_prod_cuda(P_e, L_e, dz), ds.dw_prod_cuda(P_e, L_e, dz))


@pytest.mark.cuda
@pytest.mark.parametrize("fusion,bn,rate,remat", [
    ("concatenation", True, 0.1, False), ("concatenation_prod", False, 0.1, True),
    ("concatenation_prod", True, 0.0, False), ("concatenation_diff", True, 0.0, True),
])
def test_dense_scorer_f32_matches_plain_on_card(fusion, bn, rate, remat):
    """The whole dense scorer in float32 through its kernels against its
    plain float32 version on the same device tensors, 4 sequences x 300
    labels, d 256, H 512: logits and running statistics within 1e-5 of
    their largest |value|, gradients within 1e-4; the launches
    ``dense_launches(..., float32)`` says; evaluation (BN from the running
    statistics through K6 f32, or the bias form) within 1e-5."""
    dev = _card()
    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.train.optim import tree_leaves, tree_map

    gemm_precision(torch.float32)
    p, s = _f32_output_mlp(256, 512, 5, fusion, bn)
    gen = torch.Generator().manual_seed(6)
    P_e = torch.randn(4, 256, generator=gen).to(dev)
    L_e = torch.randn(300, 256, generator=gen).to(dev)
    lm = (torch.arange(300) < 290).float().to(dev)
    w = torch.randn(4, 300, generator=gen).to(dev)
    seed = torch.tensor([5, 6], dtype=torch.int64, device=dev)
    runs = []
    for fn in (ds.pair_logits_dense, ds.pair_logits_dense_reference):
        before = dict(ds.LAUNCHES)
        pp = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        lg, new = fn(pp, s, P_e, L_e, fusion, train=True, dropout=rate, seed=seed,
                     label_mask=lm, remat=remat, compute_dtype=torch.float32)
        (lg * w).sum().backward()
        torch.cuda.synchronize()
        runs.append((lg.detach(), new, [t.grad for t in tree_leaves(pp)],
                     _f32_launched(ds, before)))
    (lg, new, grads, counts), (lg0, new0, grads0, counts0) = runs
    want = ds.dense_launches(3, True, bn, fusion == "concatenation_prod", remat=remat,
                             dtype=torch.float32)
    assert not counts0 and counts == {k: v for k, v in want.items() if v}, counts
    assert lg.dtype == torch.float32 and float(lg0.std()) > 0.3
    assert _rel(lg, lg0) <= F32_REL_TOL
    if bn:
        for a, b in zip(new["bns"], new0["bns"]):
            for k in ("mean", "var"):
                assert _rel(a[k], b[k]) <= F32_REL_TOL
    _f32_grads_close(grads, grads0)
    with torch.no_grad():
        ev = ds.pair_logits_dense(p, s, P_e, L_e, fusion, compute_dtype=torch.float32)[0]
        ev0 = ds.pair_logits_dense_reference(p, s, P_e, L_e, fusion,
                                             compute_dtype=torch.float32)[0]
    assert _rel(ev, ev0) <= F32_REL_TOL
