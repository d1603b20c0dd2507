"""The port's CUDA kernels on the card: the pair scorer (K1), its int8 form
(K2), the eval accumulator (K3), the training pair GEMM (K4) and BN+ReLU (K5)
against their plain PyTorch versions, and the serving engine on CUDA against
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
K2: the carried layer-1 rows (int8 codes or bf16) exactly equal, the logits
to 2e-2 (only the w_out dot sums in another order).
K4 and K5 on the same bf16 inputs on both sides: bf16 outputs to two bf16
steps (rtol 2^-6, atol 1e-2: the GEMM sums in another order, and the BN
affine's float32 inverse square root may differ by an ulp), float32 moments
to 1e-5 relative, the float32 column sums of the backward to 1e-3 relative
(other summation orders over ~1,500 rows of bf16 products).
"""

import numpy as np
import pytest
import torch

from protnote_tpu_torch.evaln.metrics import DeviceEvalAccumulator
from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer
from protnote_tpu_torch.ops import eval_accumulator as k3
from protnote_tpu_torch.ops import pair_scorer as ps
from protnote_tpu_torch.ops import streaming_train as st
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
@pytest.mark.parametrize("n_hidden", [1, 2, 3])
def test_kernel_matches_plain_on_card(n_hidden):
    """1-3 hidden layers (every launch mode), a ragged last label chunk and
    a partial last row block."""
    dev = _card()
    rng = np.random.default_rng(n_hidden)
    folded = _folded(rng, 16, 256, n_hidden, dev)
    P_e = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    before = ps.LAUNCHES
    got = ps.pair_logits_tiled(folded, P_e, L_e, label_tile=128)
    want = ps.pair_logits_tiled_reference(folded, P_e, L_e, label_tile=128)
    torch.cuda.synchronize()
    assert ps.LAUNCHES - before == 3 * n_hidden  # 3 label chunks
    assert float(want.std()) > 0.3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-2, rtol=0)


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
    assert k3.LAUNCHES["update"] - before["update"] == 6
    assert k3.LAUNCHES["row_tail"] - before["row_tail"] == 6
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
@pytest.mark.parametrize("chunk_rows", [None, 256])
def test_pair_train_kernel_matches_plain_on_card(monkeypatch, chunk_rows):
    """K4's forward on a ragged pair count (5 x 301 rows), in one launch and
    in label chunks; its backward is the plain one on both sides."""
    _card()
    rng = np.random.default_rng(7)
    a2, c2 = _bf16(rng, 5, 64), _bf16(rng, 301, 64)
    w = _bf16(rng, 64, 256, scale=0.2)
    if chunk_rows is not None:  # force several label chunks
        monkeypatch.setattr(st, "_K4_MAX_ROW_BLOCKS", 1)
        monkeypatch.setattr(st, "_K4_BLOCK_M", chunk_rows)
    before = st.LAUNCHES["pair_train_hidden"]
    got = st.pair_hidden(a2, c2, w)
    want = st.pair_hidden_reference(a2, c2, w)
    torch.cuda.synchronize()
    launches = st.LAUNCHES["pair_train_hidden"] - before
    assert launches == (1 if chunk_rows is None else -(-301 // (chunk_rows // 5)))
    assert float(want.float().std()) > 0.3
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)


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


def _int8(folded, P_e, L_e, static, label_tile):
    """The folded MLP quantized for K2, static scales calibrated on the
    inputs or dynamic."""
    scales = ps.calibrate_act_scales(folded, P_e, L_e, label_tile) if static else None
    return ps.quantize_folded(folded, act_scales=scales)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 1024])
@pytest.mark.parametrize("n_hidden", [1, 2, 3])
@pytest.mark.parametrize("static", [True, False])
def test_int8_kernel_matches_plain_on_card(static, n_hidden, width):
    """K2, static and dynamic scales, 1-3 hidden layers (every launch mode),
    width 256 (every column in the row scales) and 1024 (the 1/8 subsample),
    a ragged last label chunk and a partial last row block: the carried
    layer-1 rows equal the plain version's bit for bit, the logits within
    2e-2 (the w_out dot sums in another order, with atomics)."""
    dev = _card()
    rng = np.random.default_rng(10 * n_hidden + int(static))
    folded = _folded(rng, 16, width, n_hidden, dev)
    P_e = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    q = _int8(folded, P_e, L_e, static, 128)
    before = dict(ps.INT8_LAUNCHES)
    got = ps.pair_logits_tiled_int8(q, P_e, L_e, label_tile=128)
    want = ps.pair_logits_tiled_int8_reference(q, P_e, L_e, label_tile=128)
    torch.cuda.synchronize()
    assert ps.INT8_LAUNCHES["pair_int8_layer"] - before["pair_int8_layer"] == 3 * n_hidden
    scale_launches = ps.INT8_LAUNCHES["pair_int8_row_scale"] - before["pair_int8_row_scale"]
    assert scale_launches == (0 if static else 3 * n_hidden)
    assert float(want.std()) > 0.3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-2, rtol=0)
    if n_hidden >= 2:
        for l0, nl in ((0, 128), (256, 44)):
            mine = ps.int8_carry_cuda(q, P_e, L_e, l0, nl)
            theirs = ps.int8_carry_reference(q, P_e, L_e, l0, nl)
            torch.cuda.synchronize()
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
            assert torch.equal(mine, theirs)


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
