"""K1 and K2 in float32 (``MIXED_PRECISION: False``) on the CPU: the port's
plain float32 chains against the JAX package's float32 scorers on the same
numpy inputs, and the arithmetic of the float32 kernel
(``csrc/pair_scorer_f32.cu``: every product split into three bf16 pieces,
six products a k-step summed a stage at a time,
``ops/pair_scorer.py:bf16x3_product_emulation``)
against JAX's float32 products.

Tolerances:
* K1 float32: 1e-5 absolute on logits of std ~0.1 or more.  JAX runs its
  products at Precision.HIGHEST and the port in full float32 (TF32 off);
  only the summation order differs.
* K2 float32: the int8 tests' 1e-5 (``tests/test_torch_pair_scorer_int8.py``)
  with the first-layer inputs on a dyadic grid, so that ``a`` and ``c`` are
  exact in float32 on both sides and both quantize the same values.
* The split: within 1e-5 of the largest |value| of JAX's float32 product at
  K1's full depth (K 3072).  Left out are the products of the two smaller
  pieces (x1 w2, x2 w1, x2 w2, below 2^-24 of |x w|); the rest is float32
  summation in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.ops import pair_scorer as jps
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import pair_scorer as tps

D, H, B = 128, 256, 3
CHUNK = 128  # labels a chunk of the plans below (target rows B x 128)
L = CHUNK + 3  # three labels past the first chunk's edge
ATOL = 1e-5
SPLIT_REL_TOL = 1e-5


def _output_mlp(rng, fusion, n_layers):
    """Random output-MLP params and BN state (numpy, JAX layout) with
    statistics far from identity, He-scaled so the logits spread."""
    in_dim = 2 * D if fusion == "concatenation" else 3 * D
    layers, bns, stats = [], [], []
    for i in range(n_layers):
        fan_in = in_dim if i == 0 else H
        layers.append({"kernel": rng.uniform(-1, 1, (fan_in, H)).astype(np.float32)
                       * np.float32(np.sqrt(6.0 / fan_in))})
        bns.append({"scale": rng.uniform(0.5, 1.5, H).astype(np.float32),
                    "bias": rng.normal(0, 0.1, H).astype(np.float32)})
        stats.append({"mean": rng.normal(0, 0.1, H).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, H).astype(np.float32)})
    out = {"kernel": rng.uniform(-1, 1, (H, 1)).astype(np.float32) * np.float32(np.sqrt(3.0 / H)),
           "bias": np.array([-0.3], np.float32)}
    return {"layers": layers, "bns": bns, "out": out}, {"bns": stats}


def _folded_pair(fusion, n_layers, seed):
    rng = np.random.default_rng(seed)
    p, s = _output_mlp(rng, fusion, n_layers)
    jt = jax.tree_util.tree_map(jnp.asarray, (p, s))
    tt = from_jax_tree({"p": p, "s": s})
    j = jps.fold_output_mlp(jt[0], jt[1], fusion, D, dtype=jnp.float32)
    t = tps.fold_output_mlp(tt["p"], tt["s"], fusion, D, dtype=torch.float32)
    P_e = rng.normal(size=(B, D)).astype(np.float32)
    L_e = rng.normal(size=(L, D)).astype(np.float32)
    return j, t, P_e, L_e


def _emulated_kernel_chain(t, P_e, L_e, plan):
    """The float32 kernel's chain over its plan, each product through the
    split's emulation: a and c in float32 (the side products stay
    ``torch.matmul``), per chunk ``relu(a + c)`` or the prod layer
    ``relu((a + c) + (p * l) @ w1_prod)`` (label rows past L zero), the
    hidden layers ``relu(x @ W + b)`` kept in float32, the dot with float32
    w_out into logits pre-filled with b_out."""
    a, c = tps._side_partials(t, P_e, L_e, torch.float32)
    logits = torch.full((P_e.shape[0], L_e.shape[0]), float(t.b_out))

    def padded(x, ch):
        x = x[ch.l0 : ch.l0 + ch.nl_pad]
        return torch.cat([x, x.new_zeros(ch.nl_pad - x.shape[0], x.shape[1])])

    for ch in plan.chunks:
        rows = P_e.shape[0] * ch.nl_pad
        pre = (a[:, None] + padded(c, ch)[None]).reshape(rows, -1)
        if t.w1_prod is not None:
            prod = (P_e[:, None] * padded(L_e, ch)[None]).reshape(rows, -1)
            pre = pre + tps.bf16x3_product_emulation(prod, t.w1_prod)
        x = torch.relu(pre)
        for W, b in t.hidden:
            x = torch.relu(tps.bf16x3_product_emulation(x, W) + b)
        out = (x @ t.w_out).reshape(P_e.shape[0], ch.nl_pad)[:, : ch.nl]
        logits[:, ch.l0 : ch.l0 + ch.nl] += out
    return logits


@pytest.mark.parametrize("n_layers", [1, 3])  # no hidden layer, two hidden layers
@pytest.mark.parametrize("fusion", ["concatenation", "concatenation_prod"])
def test_k1_float32_matches_jax(fusion, n_layers):
    """``pair_logits_tiled`` (the CPU path), ``pair_logits_plan_reference``
    over the float32 kernel's plan (float32 workspaces, padded chunks, the
    last one ragged) and the kernel's arithmetic emulated, each against
    JAX's float32 ``pair_logits_tiled``."""
    j, t, P_e, L_e = _folded_pair(fusion, n_layers, seed=10 * n_layers + len(fusion))
    want = np.asarray(jps.pair_logits_tiled(j, jnp.asarray(P_e), jnp.asarray(L_e),
                                            label_tile=64, compute_dtype=jnp.float32))
    Pt, Lt = torch.from_numpy(P_e), torch.from_numpy(L_e)
    plan = tps.launch_plan(B, L, H, max(n_layers - 1, 1), target_rows=B * CHUNK)
    assert [(ch.nl, ch.nl_pad) for ch in plan.chunks] == [(CHUNK, CHUNK), (3, CHUNK)]
    got = {
        "tiled": tps.pair_logits_tiled(t, Pt, Lt, label_tile=64, compute_dtype=torch.float32),
        "plan": tps.pair_logits_plan_reference(t, Pt, Lt, plan, compute_dtype=torch.float32),
        "kernel_arithmetic": _emulated_kernel_chain(t, Pt, Lt, plan),
    }
    for name, logits in got.items():
        assert logits.dtype == torch.float32 and logits.shape == (B, L), name
        np.testing.assert_allclose(logits.numpy(), want, atol=ATOL, rtol=0, err_msg=name)
    assert np.std(want) > 0.1  # the check is not on near-constant logits
    assert len(t.hidden) == n_layers - 1 and (t.w1_prod is not None) == (fusion != "concatenation")


def _grid(rng, shape, step, lim):
    return (np.clip(np.round(rng.normal(size=shape) * lim / 3), -lim, lim)
            * step).astype(np.float32)


def _int8_pair(seed):
    """The same float32 weights as a JAX and a port ``FoldedOutputMLP``,
    the first layer's inputs on a dyadic grid (``a``, ``c`` exact)."""
    rng = np.random.default_rng(seed)
    w1_p, w1_l = _grid(rng, (D, H), 2.0 ** -8, 127), _grid(rng, (D, H), 2.0 ** -8, 127)
    b1 = _grid(rng, (H,), 2.0 ** -8, 127)
    hidden = [((rng.normal(size=(H, H)) * np.sqrt(2.0 / H)).astype(np.float32),
               (rng.normal(size=H) * 0.1).astype(np.float32)) for _ in range(2)]
    w_out = (rng.normal(size=H) / np.sqrt(H)).astype(np.float32)
    j = jps.FoldedOutputMLP(w1_p=jnp.asarray(w1_p), w1_l=jnp.asarray(w1_l), b1=jnp.asarray(b1),
                            w1_prod=None,
                            hidden=[(jnp.asarray(W), jnp.asarray(b)) for W, b in hidden],
                            w_out=jnp.asarray(w_out), b_out=jnp.asarray(np.float32(-0.5)))
    t = tps.FoldedOutputMLP(w1_p=torch.from_numpy(w1_p), w1_l=torch.from_numpy(w1_l),
                            b1=torch.from_numpy(b1), w1_prod=None,
                            hidden=[(torch.from_numpy(W), torch.from_numpy(b)) for W, b in hidden],
                            w_out=torch.from_numpy(w_out), b_out=torch.tensor(-0.5))
    P_e, L_e = _grid(rng, (B, D), 2.0 ** -4, 15), _grid(rng, (L, D), 2.0 ** -4, 15)
    return j, t, P_e, L_e


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_k2_float32_matches_jax(scales):
    """K2's float32 form: the port's plain int8 chain (``pair_logits_tiled_int8``
    on the CPU, and over the kernel's plan) against JAX's
    ``pair_logits_tiled_int8`` at ``compute_dtype=float32``: float32 side
    products, the bf16 int8 chain, the float32 dot of bf16 activations with
    a float32 ``w_out``."""
    j, t, P_e, L_e = _int8_pair(seed=3)
    act = None
    if scales == "static":
        act = jps.calibrate_act_scales(j, jnp.asarray(P_e), jnp.asarray(L_e), label_tile=64)
    jq, tq = jps.quantize_folded(j, act_scales=act), tps.quantize_folded(t, act_scales=act)
    assert tq.w_out.dtype == torch.float32
    want = np.asarray(jps.pair_logits_tiled_int8(jq, jnp.asarray(P_e), jnp.asarray(L_e),
                                                 label_tile=64, compute_dtype=jnp.float32))
    Pt, Lt = torch.from_numpy(P_e), torch.from_numpy(L_e)
    plan = tps.launch_plan(B, L, H, 2, target_rows=B * CHUNK)
    for name, got in (
            ("tiled", tps.pair_logits_tiled_int8(tq, Pt, Lt, label_tile=64,
                                                 compute_dtype=torch.float32)),
            ("plan", tps.pair_logits_int8_plan_reference(tq, Pt, Lt, plan,
                                                         compute_dtype=torch.float32))):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=name)
    assert np.std(want) > 0.05


def test_split_is_exact():
    """``split_bf16x3``: three bf16 pieces that add up to the float32 value
    exactly (in float64), over every exponent a float32 activation or weight
    takes here, with full 24-bit significands, signs and zeros."""
    rng = np.random.default_rng(0)
    mant = rng.integers(1 << 23, 1 << 24, size=20000).astype(np.float64) / (1 << 23)
    x = (mant * np.exp2(rng.integers(-60, 60, size=mant.size)) *
         rng.choice([-1.0, 1.0], size=mant.size)).astype(np.float32)
    x[:3] = [0.0, -0.0, 1.0]
    pieces = tps.split_bf16x3(torch.from_numpy(x))
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, torch.from_numpy(x).double())
    # the pieces shrink: each at most half an ulp of bf16 of the one before
    for hi, lo in zip(pieces, pieces[1:]):
        assert bool((lo.float().abs() <= hi.float().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("operand", ["activations", "signed"])
def test_split_product_accuracy_at_full_depth(operand):
    """The kernel's product at K1's full depth (K 3072, 256 rows): the six
    bf16 products of the split, summed in float32 a k-step of 16 at a time,
    within 1e-5 of the largest |value| of JAX's float32 product at
    Precision.HIGHEST; one bf16 pass (what K1's bf16 kernel computes) is
    not, so the tolerance tells the two apart."""
    rng = np.random.default_rng(7)
    K, N, R = 3072, 128, 256
    x = rng.normal(size=(R, K)).astype(np.float32)
    if operand == "activations":
        x = np.maximum(x, 0)  # a ReLU'd layer input
    w = (rng.normal(size=(K, N)) * np.sqrt(2.0 / K)).astype(np.float32)
    want = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w),
                              precision=jax.lax.Precision.HIGHEST))
    got = tps.bf16x3_product_emulation(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= SPLIT_REL_TOL * scale, (err, scale)
    one_pass = (torch.from_numpy(x).to(torch.bfloat16).float()
                @ torch.from_numpy(w).to(torch.bfloat16).float()).numpy()
    assert np.abs(one_pass - want).max() > 10 * SPLIT_REL_TOL * scale


def test_kernel_layout_of_the_pieces():
    """The float32 wrapper lays each weight out as its three pieces, each
    transposed to K-major and stacked (3N, K): rows p N + n of the stack are
    piece p of W[:, n]."""
    rng = np.random.default_rng(4)
    W = torch.from_numpy(rng.normal(size=(256, 384)).astype(np.float32))
    stack = tps._K1Kernel.pieces(W)
    assert stack.shape == (3 * 384, 256) and stack.dtype == torch.bfloat16
    assert stack.is_contiguous()
    back = sum(stack[p * 384 : (p + 1) * 384].double().t() for p in range(3))
    assert torch.equal(back, W.double())


def _refuse_unported(argv, device):
    """``cli/main.py:refuse_unported`` on the CLI's parsed ``argv`` and the
    overrides it names, on ``device``: raises for what the port does not
    run."""
    from protnote_tpu_torch.cli import main as tmain

    args = tmain.build_argparser().parse_args([*argv, "--device", device])
    over = args.override or []
    tmain.refuse_unported(args, dict(zip(over[::2], over[1::2])))


@pytest.mark.parametrize("setting", [
    # item 16d, the label tower in float32, runs on the card since its kernels took float32
    pytest.param(dict(LABEL_ENCODER_NUM_TRAINABLE_LAYERS=2), id="setting0-item 16d"),
    # item 16c, training the encoder in float32, runs on the card now
    pytest.param(dict(train=True, TRAIN_SEQUENCE_ENCODER=True, ENCODER_BN_TRAIN_MODE=True),
                 id="setting1-item 16c"),
])
def test_cli_refuses_float32_on_the_card_before_any_work(setting, tmp_path, monkeypatch):
    """``cli/main.py`` with ``MIXED_PRECISION False`` on the card once
    refused, before any work, the settings whose float32 kernels were not
    ported: the label tower (16d) and training the encoder and its
    BatchNorm (16c).  Both are ported: each passes the check and goes on to
    read the label cache, and ``refuse_unported`` passes them on the card,
    on the CPU, with ``MIXED_PRECISION True``, and beside the encoder
    settings."""
    from protnote_tpu_torch.cli import main as tmain
    from protnote_tpu_torch.data import label_cache

    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(tmp_path / "outputs"))

    class CacheRead(Exception):
        pass

    def first_read(*args, **kwargs):
        raise CacheRead

    monkeypatch.setattr(label_cache.LabelEmbeddingCache, "load", first_read)
    setting = dict(setting)
    train = setting.pop("train", False)
    override = ["MIXED_PRECISION", "False"] + [str(x) for kv in setting.items() for x in kv]
    argv = ["--test-paths-names", "TEST_DATA_PATH", "--override", *override]
    if train:
        argv = ["--train-path-name", "TRAIN_DATA_PATH", *argv]
    with pytest.raises(CacheRead):
        tmain.main(argv)
    for device in ("cuda", "cpu"):
        _refuse_unported(argv, device)
    _refuse_unported([*argv, "MIXED_PRECISION", "True"], "cuda")
    _refuse_unported([*argv, "TRAIN_SEQUENCE_ENCODER", "True", "LABEL_ENCODER_NUM_TRAINABLE_LAYERS",
                      "2"], "cuda")


@pytest.mark.parametrize("setting", [
    dict(train=True, TRAIN_STREAMING_LABEL_TILE=2048),
    dict(train=True, TRAIN_STREAMING_LABEL_TILE=2048, TRAIN_STREAMING_CACHE=False),
    dict(PAIR_BACKEND="dense"),
    dict(train=True, PAIR_BACKEND="dense"),
    dict(train=True, PAIR_BACKEND="tiled"),
    dict(train=True, OUTPUT_MLP_DROPOUT=0.1),
    dict(train=True, OUTPUT_MLP_BATCHNORM=False),
    dict(train=True, FEATURE_FUSION="concatenation_prod"),
    dict(train=True, OUTPUT_MLP_DROPOUT=0.1, GRADIENT_CHECKPOINTING=True),
])
def test_cli_passes_float32_scorers_on_the_card_and_reads_the_label_cache(setting, tmp_path,
                                                                          monkeypatch):
    """``cli/main.py`` with ``MIXED_PRECISION False`` on ``cuda`` passes the
    check and goes on to read the label cache for the streamed scorer (with
    and without its z1 cache), the dense scorer in evaluation and in
    training (``PAIR_BACKEND dense``, ``tiled`` without a tile, dropout, no
    BatchNorm, ``concatenation_prod``, remat): their float32 kernels run on
    the card.  So does ``refuse_unported`` alone on the same arguments, with
    and without the label tower."""
    from protnote_tpu_torch.cli import main as tmain
    from protnote_tpu_torch.data import label_cache

    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(tmp_path / "outputs"))

    class CacheRead(Exception):
        pass

    def first_read(*args, **kwargs):
        raise CacheRead

    monkeypatch.setattr(label_cache.LabelEmbeddingCache, "load", first_read)
    setting = dict(setting)
    train = setting.pop("train", False)
    override = ["MIXED_PRECISION", "False"] + [str(x) for kv in setting.items() for x in kv]
    argv = ["--test-paths-names", "TEST_DATA_PATH", "--override", *override]
    if train:
        argv = ["--train-path-name", "TRAIN_DATA_PATH", *argv]
    with pytest.raises(CacheRead):
        tmain.main(argv)
    _refuse_unported(argv, "cuda")
    _refuse_unported([*argv, "LABEL_ENCODER_NUM_TRAINABLE_LAYERS", "2"], "cuda")


def test_cli_passes_default_float32_training_on_the_card(tmp_path, monkeypatch):
    """Default training (``PAIR_BACKEND auto``, BatchNorm, no dropout, no
    label tile: the decomposed scorer, K4, K4-bwd and K5 in float32) with
    ``MIXED_PRECISION False`` on ``cuda`` passes the check and goes on to
    read the label cache; so do ``concatenation_diff``, ``tiled_int8`` and
    ``GRADIENT_CHECKPOINTING``, which take the same scorer; ``refuse_unported``
    passes each, and the label tower beside them."""
    from protnote_tpu_torch.cli import main as tmain
    from protnote_tpu_torch.data import label_cache

    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(tmp_path / "outputs"))

    class CacheRead(Exception):
        pass

    def first_read(*args, **kwargs):
        raise CacheRead

    monkeypatch.setattr(label_cache.LabelEmbeddingCache, "load", first_read)
    with pytest.raises(CacheRead):
        tmain.main(["--train-path-name", "TRAIN_DATA_PATH", "--test-paths-names",
                    "TEST_DATA_PATH", "--override", "MIXED_PRECISION", "False"])
    argv = ["--train-path-name", "TRAIN_DATA_PATH", "--override", "MIXED_PRECISION", "False"]
    for extra in ([], ["FEATURE_FUSION", "concatenation_diff"], ["PAIR_BACKEND", "tiled_int8"],
                  ["GRADIENT_CHECKPOINTING", "True"], ["LABEL_ENCODER_NUM_TRAINABLE_LAYERS", "2"]):
        _refuse_unported([*argv, *extra], "cuda")
