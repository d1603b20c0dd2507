"""The port's materialised dense scorer (protnote_tpu_torch/ops/dense_scorer.py)
against the JAX package on the CPU.

The same numpy inputs and JAX-initialised weights (random BatchNorm
parameters and running statistics, He-scaled linears, random biases without
BatchNorm) go through the JAX ``pair_logits_dense`` and the port's, the
port on the plain versions of its kernels: the first layer from per-side
products (the prod block from ``bf16(p * l)``), K5 with centred moments and
dropout, and the bias + ReLU + dropout form.  Dropout takes the same masks
on both sides: the port's counter hash (:func:`keep_mask`) gives them, and a
test-local ``monkeypatch`` of ``protnote_tpu.ops.pair_scorer.dropout_fn``
feeds them to JAX (the JAX package is not changed).

Tolerances:
* float32: 1e-5 absolute on logits, new running statistics and gradients,
  the `TOL` of tests/test_reference_parity.py (the two sides sum in other
  orders: the port's first layer is the sum of per-side products, and K5's
  backward is the closed form of the BatchNorm's vjp).
* bfloat16: against JAX run eagerly (``jax.disable_jit``; compiled on the
  CPU, XLA drops bf16 roundings between fused operations), at 6 sequences x
  40 labels, d 24, H 96: logits within 2^-6 of their largest |value|, the
  new running statistics to 1e-3 of theirs, every gradient within 2^-6 of
  its largest |value| (the port rounds the first layer's float32 sum once,
  in another order than JAX's joint product, and sums the prod block's
  backward in float32, so a pre-activation can land one bf16 step away and
  move what follows).  ``concatenation_diff`` is held in bf16 by its logits
  only: the port folds the diff block into the side products (as the
  decomposed scorer and the folded eval MLP do), where JAX's dense chain
  rounds ``p - l`` to bf16 first, so from there the two bf16 chains carry
  independent rounding noise (each 10-15% of a gradient's largest |value|
  from the float32 chain at these widths, the port's and JAX's alike);
  float32 holds its gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import fusion as jfu
from protnote_tpu.ops import pair_scorer as jps
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import dense_scorer as tds
from protnote_tpu_torch.ops import pair_scorer as tps

TOL = 1e-5
B, L, D, H_SCALE = 5, 21, 12, 2
RATE = 0.25
SEED = torch.tensor([123456789, 987654321], dtype=torch.int64)


def _weights(fusion="concatenation", bn=True, depth=3, seed=0, d=D, h_scale=H_SCALE):
    """Output-MLP (params, state or None) as numpy."""
    cfg = jfu.ProtNoteConfig(protein_embedding_dim=20, label_embedding_dim=20, latent_dim=d,
                             projection_head_num_layers=2, output_mlp_num_layers=depth,
                             output_mlp_hidden_dim_scale_factor=h_scale, feature_fusion=fusion,
                             output_mlp_batchnorm=bn)
    params, state = jfu.init_protnote(jax.random.PRNGKey(seed), cfg)
    p = jax.tree_util.tree_map(np.asarray, params["output_mlp"])
    s = jax.tree_util.tree_map(np.asarray, state["output_mlp"]) if bn else None
    rng = np.random.default_rng(seed)
    for i in range(depth if bn else 0):
        n = s["bns"][i]["mean"].shape[0]
        p["bns"][i] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                       "bias": rng.normal(0, 0.2, n).astype(np.float32)}
        s["bns"][i] = {"mean": rng.normal(0, 0.3, n).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    for lin in p["layers"] + [p["out"]]:
        lin["kernel"] = lin["kernel"] * np.float32(6 ** 0.5)
        if "bias" in lin:
            lin["bias"] = rng.normal(0, 0.3, lin["bias"].shape).astype(np.float32)
    return p, s


def _inputs(seed=1, b=B, n_labels=L, d=D):
    """(P_e, L_e, example mask with the last sequence masked, label mask
    with the last three labels masked)."""
    rng = np.random.default_rng(seed)
    P_e = rng.normal(size=(b, d)).astype(np.float32)
    L_e = rng.normal(size=(n_labels, d)).astype(np.float32)
    em = (np.arange(b) < b - 1).astype(np.float32)
    lm = (np.arange(n_labels) < n_labels - 3).astype(np.float32)
    return P_e, L_e, em, lm


def _loss_weights(shape, seed=2):
    """The loss is ``sum(logits * w)`` with w = +-1/16: the logits' cotangent
    is exact in bf16, and so is every partial sum of it (multiples of 1/16
    below 16 for fewer than 256 pairs), so the output bias's gradient does
    not depend on the order in which either side sums it."""
    assert shape[0] * shape[1] < 256
    return (np.random.default_rng(seed).choice([-1.0, 1.0], size=shape) / 16).astype(np.float32)


def _masks(depth, n_rows=B * L, width=D * H_SCALE, rate=RATE, seed=SEED):
    """The keep masks of the dropout layers (every layer but the last), as
    the port's hash gives them: numpy (rows, H) bools."""
    rows, cols = torch.arange(n_rows)[:, None], torch.arange(width)[None, :]
    return [tds.keep_mask(seed, i, rate, rows, cols).numpy() for i in range(depth - 1)]


def _feed_masks(monkeypatch, masks):
    """JAX's output-MLP dropout takes ``masks`` in call order: the JAX
    ``dropout`` formula with the mask given instead of drawn."""
    calls = []

    def dropout_fn(x, rate, rng, train):
        mask = jnp.asarray(masks[len(calls) % len(masks)])
        calls.append(rate)
        return jnp.where(mask, x / (1.0 - rate), 0.0).astype(x.dtype)

    monkeypatch.setattr(jps, "dropout_fn", dropout_fn)
    return calls


def _jax_dense(p, s, P_e, L_e, em, lm, fusion, train, rate=0.0, remat=False,
               dtype=jnp.float32, masks=True):
    w = jnp.asarray(_loss_weights((len(P_e), len(L_e))))
    pair_mask = (jnp.asarray(em)[:, None] * jnp.asarray(lm)[None, :]) if masks else None
    s_j = None if s is None else jax.tree_util.tree_map(jnp.asarray, s)

    def f(p_, P_, L_):
        lg, new = jps.pair_logits_dense(
            p_, s_j, P_.astype(dtype), L_.astype(dtype), fusion, train=train, dropout=rate,
            rng=jax.random.PRNGKey(0) if rate > 0 else None, pair_mask=pair_mask, remat=remat)
        return jnp.sum(lg.astype(jnp.float32) * w), (lg, new)

    (_, (lg, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(P_e), jnp.asarray(L_e))
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), (lg, new, grads))


def _port_dense(p, s, P_e, L_e, em, lm, fusion, train, rate=0.0, remat=False,
                dtype=torch.float32, masks=True):
    t = from_jax_tree({"p": p, "s": s} if s is not None else {"p": p})
    tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True), t["p"])
    Pg = torch.from_numpy(P_e).requires_grad_(True)
    Lg = torch.from_numpy(L_e).requires_grad_(True)
    lg, new = tds.pair_logits_dense(
        tp, t.get("s"), Pg, Lg, fusion, train=train, dropout=rate,
        seed=SEED if rate > 0 else None,
        example_mask=torch.from_numpy(em) if masks else None,
        label_mask=torch.from_numpy(lm) if masks else None, remat=remat, compute_dtype=dtype)
    (lg.float() * torch.from_numpy(_loss_weights(tuple(lg.shape)))).sum().backward()
    grads = (jax.tree_util.tree_map(lambda x: x.grad.float().numpy(), tp),
             Pg.grad.float().numpy(), Lg.grad.float().numpy())
    new = None if new is None else jax.tree_util.tree_map(lambda x: x.float().numpy(), new)
    return lg.detach().float().numpy(), new, grads


def _leaves(run):
    lg, new, grads = run
    return lg, jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(grads)


def _assert_close(got, want, atol=TOL):
    g, w = _leaves(got), _leaves(want)
    assert g[0].shape == w[0].shape and float(np.std(w[0])) > 0.3
    assert len(g[1]) == len(w[1]) and len(g[2]) == len(w[2])
    for a, b in [(g[0], w[0])] + list(zip(g[1], w[1])) + list(zip(g[2], w[2])):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


FUSIONS = ["concatenation", "concatenation_diff", "concatenation_prod"]


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("masks", [True, False])
def test_dense_train_matches_jax(fusion, bn, masks):
    """Training, float32: logits, new running statistics and the gradients of
    P_e, L_e and every output-MLP leaf, with and without BatchNorm, with pair
    masks (a masked sequence, three masked labels) and without."""
    p, s = _weights(fusion, bn)
    P_e, L_e, em, lm = _inputs()
    _assert_close(_port_dense(p, s, P_e, L_e, em, lm, fusion, True, masks=masks),
                  _jax_dense(p, s, P_e, L_e, em, lm, fusion, True, masks=masks))


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("bn", [True, False])
def test_dense_dropout_matches_jax(fusion, bn, monkeypatch):
    """Training with OUTPUT_MLP_DROPOUT: the same masks on both sides (the
    first two layers'; none after the last), float32 at 1e-5."""
    p, s = _weights(fusion, bn)
    P_e, L_e, em, lm = _inputs()
    calls = _feed_masks(monkeypatch, _masks(3))
    want = _jax_dense(p, s, P_e, L_e, em, lm, fusion, True, rate=RATE)
    assert calls == [RATE, RATE]
    _assert_close(_port_dense(p, s, P_e, L_e, em, lm, fusion, True, rate=RATE), want)


@pytest.mark.parametrize("fusion,bn,rate", [
    ("concatenation", True, 0.0), ("concatenation_prod", False, RATE),
    ("concatenation_diff", True, RATE),
])
def test_dense_remat_matches_jax(fusion, bn, rate, monkeypatch):
    """GRADIENT_CHECKPOINTING: the port's remat against JAX's
    ``remat=True`` (1e-5), and bit for bit against its own ``remat=False``
    (the backward recomputes the same kernels and regenerates the same
    dropout masks)."""
    p, s = _weights(fusion, bn)
    P_e, L_e, em, lm = _inputs()
    if rate:
        _feed_masks(monkeypatch, _masks(3))
    got = _port_dense(p, s, P_e, L_e, em, lm, fusion, True, rate=rate, remat=True)
    _assert_close(got, _jax_dense(p, s, P_e, L_e, em, lm, fusion, True, rate=rate, remat=True))
    plain = _port_dense(p, s, P_e, L_e, em, lm, fusion, True, rate=rate)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(plain)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("bn", [True, False])
def test_dense_eval_matches_jax(fusion, bn, monkeypatch):
    """Evaluation (``train=False``): eval BatchNorm from the running
    statistics on the materialised rows (or the biases), no dropout, the
    state returned unchanged, in label chunks of 4 pair rows' worth (the
    chain is row by row): logits 1e-5."""
    monkeypatch.setattr(tds, "EVAL_CHUNK_ROWS", 4 * B)  # 4 labels a chunk, the last of 1
    p, s = _weights(fusion, bn)
    P_e, L_e, em, lm = _inputs()
    t = from_jax_tree({"p": p, "s": s} if s is not None else {"p": p})
    got, new = tds.pair_logits_dense(t["p"], t.get("s"), torch.from_numpy(P_e),
                                     torch.from_numpy(L_e), fusion, train=False,
                                     dropout=RATE, seed=SEED)
    want, new_j = jps.pair_logits_dense(jax.tree_util.tree_map(jnp.asarray, p),
                                        None if s is None else
                                        jax.tree_util.tree_map(jnp.asarray, s),
                                        jnp.asarray(P_e), jnp.asarray(L_e), fusion, train=False,
                                        dropout=RATE)
    assert got.dtype == torch.float32 and float(np.std(want)) > 0.3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert new is t.get("s")


BF16_SHAPE = dict(b=6, n_labels=40, d=24)


@pytest.mark.parametrize("fusion,bn,rate", [
    ("concatenation", True, RATE), ("concatenation", False, 0.0),
    ("concatenation_prod", True, 0.0), ("concatenation_prod", False, RATE),
    ("concatenation_diff", True, RATE), ("concatenation_diff", False, 0.0),
])
def test_dense_bf16_matches_eager_jax(fusion, bn, rate, monkeypatch):
    """bfloat16 against the JAX function run eagerly (module docstring):
    logits and gradients within 2^-6 of their largest |value|, running
    statistics within 1e-3 of theirs (diff: the logits)."""
    p, s = _weights(fusion, bn, d=BF16_SHAPE["d"], h_scale=4)
    P_e, L_e, em, lm = _inputs(**BF16_SHAPE)
    if rate:
        _feed_masks(monkeypatch, _masks(3, 6 * 40, 96))
    got = _port_dense(p, s, P_e, L_e, em, lm, fusion, True, rate=rate, dtype=torch.bfloat16)
    with jax.disable_jit():
        want = _jax_dense(p, s, P_e, L_e, em, lm, fusion, True, rate=rate, dtype=jnp.bfloat16)
    g, w = _leaves(got), _leaves(want)
    valid = (em[:, None] * lm[None, :]) > 0
    assert float(np.std(w[0])) > 0.3
    assert np.abs(g[0] - w[0])[valid].max() <= 2.0 ** -6 * np.abs(w[0]).max()
    if fusion == "concatenation_diff":
        return
    assert len(g[1]) == len(w[1]) == (6 if bn else 0)
    for a, b in zip(g[1], w[1]):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    assert len(g[2]) == len(w[2]) == (2 + 3 * 3 + 2 if bn else 2 + 2 * 3 + 2)
    for a, b in zip(g[2], w[2]):
        assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max()


# ----------------------------------------------------------------------
# the keep mask: a counter hash of (seed, layer, row, column)


def _np_keep(seed, layer, rate, n_rows, width):
    """The kernels' hash in numpy uint32 arithmetic (wrapping products), an
    emulation independent of the torch int64 version."""
    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    with np.errstate(over="ignore"):
        s0, s1 = (np.uint32(int(v)) for v in seed)
        k0 = fmix(s0 ^ np.uint32(((layer + 1) * 0x9E3779B1) & 0xFFFFFFFF))
        k1 = fmix(np.uint32((int(s1) + int(k0)) & 0xFFFFFFFF))
        rows = np.arange(n_rows, dtype=np.uint32)[:, None]
        cols = np.arange(width, dtype=np.uint32)[None, :]
        h = fmix(rows * np.uint32(0x9E3779B1) ^ k0)
        h = fmix(h ^ cols * np.uint32(0x85EBCA77) ^ k1)
    return (h >> np.uint32(8)) < np.uint32(tds.keep_threshold(rate))


@pytest.mark.parametrize("seed,layer,rate", [
    ((0, 0), 0, 0.1), ((123456789, 987654321), 1, 0.25), ((2**31 - 2, 7), 5, 0.5),
])
def test_keep_mask_is_the_kernels_hash(seed, layer, rate):
    """The plain mask (int64 tensor operations) equals the uint32 hash the
    kernels compute, emulated in numpy with wrapping products."""
    got = tds.keep_mask(torch.tensor(seed), layer, rate, torch.arange(1000)[:, None],
                        torch.arange(300)[None, :])
    np.testing.assert_array_equal(got.numpy(), _np_keep(seed, layer, rate, 1000, 300))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    """Over 400 x 500 elements the keep rate is 1 - rate within 0.5%, and a
    kept element is bf16(y / bf16(1 - rate)) (JAX's weak-typed divisor)."""
    y = torch.full((400, 500), 1.5, dtype=torch.bfloat16)
    out = tds._drop_plain(y, SEED, 0, rate)
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5e-3
    keep_b = torch.tensor(1 - rate, dtype=torch.bfloat16).float()
    assert torch.equal(out[kept].float(), (1.5 / keep_b).to(torch.bfloat16).float()
                       .expand(int(kept.sum())))


def test_keep_mask_same_bits_and_independent_draws():
    """The same seed and layer give the same bits; another layer or seed
    agrees with it on about keep^2 + rate^2 of the elements (independent
    draws), not on all."""
    rows, cols = torch.arange(300)[:, None], torch.arange(200)[None, :]
    m = tds.keep_mask(SEED, 0, 0.5, rows, cols)
    assert torch.equal(m, tds.keep_mask(SEED.clone(), 0, 0.5, rows, cols))
    for other in (tds.keep_mask(SEED, 1, 0.5, rows, cols),
                  tds.keep_mask(SEED + 1, 0, 0.5, rows, cols)):
        assert abs(float((m == other).float().mean()) - 0.5) < 0.02


def test_seed_draw_follows_the_generator():
    """A step's seed comes from its generator: the same state, the same
    seed; two words in [0, 2^31)."""
    a = tds.draw_seed(torch.Generator().manual_seed(3))
    b = tds.draw_seed(torch.Generator().manual_seed(3))
    assert a.dtype == torch.int64 and a.shape == (2,) and torch.equal(a, b)
    assert bool(((a >= 0) & (a < 2**31)).all())


@pytest.mark.parametrize("bn", [True, False])
def test_backward_regenerates_the_forward_mask(bn):
    """The backward's mask is the forward's: with every pre-activation past
    the ReLU, z's gradient is 0 exactly where y is, and bf16(g / keep)
    elsewhere."""
    N, H = 60, 24
    z = torch.full((N, H), 2.0, requires_grad=True)
    if bn:
        z = (torch.arange(N * H, dtype=torch.float32).reshape(N, H) % 7 + 10.0)
        z.requires_grad_(True)
        rows = torch.ones(N, 1)
        y, _, _ = tds.bn_relu_dropout(z, rows, rows.sum(), torch.ones(H), torch.full((H,), 5.0),
                                      SEED, 1, RATE)
    else:
        y = tds.bias_relu_dropout(z, torch.zeros(H), SEED, 1, RATE)
    y.backward(torch.ones_like(y))
    mask = tds.keep_mask(SEED, 1, RATE, torch.arange(N)[:, None], torch.arange(H)[None, :])
    assert torch.equal(y != 0, mask)
    if not bn:
        assert torch.equal(z.grad != 0, mask)
        np.testing.assert_allclose(z.grad[mask].numpy(), 1 / 0.75, rtol=1e-6)


# ----------------------------------------------------------------------
# the C entry points' ctypes signatures


@pytest.mark.parametrize("library,symbol", sorted(tds.SIGNATURES))
def test_dense_signatures_match_the_c_entry_points(library, symbol):
    """Each ctypes signature of the dense scorer's wrappers against its
    ``extern "C"`` prototype, parameter by parameter (a pointer cut to a
    32-bit int, or a float passed as a double, would break on the card)."""
    import ctypes
    import re

    from protnote_tpu_torch.ops.kernels import CSRC_DIR

    src = (CSRC_DIR / f"{library}.cu").read_text()
    protos = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    kinds = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float}
    types = [kinds[" ".join(p.replace("const ", "").split()[:-1]).replace(" *", "*")]
             for p in protos[symbol].split(",")]
    assert types == tds.SIGNATURES[(library, symbol)]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers raise for CPU tensors: they never fall back."""
    a, c = torch.zeros(2, 128), torch.zeros(3, 128)
    P, Lx = torch.zeros(2, 128, dtype=torch.bfloat16), torch.zeros(3, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tds._first_fwd_cuda(a, c, P, Lx, None)
    with pytest.raises(ValueError, match="card"):
        tds.side_sums_cuda(torch.zeros(6, 256, dtype=torch.bfloat16), 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tds._bias_relu_dropout_fwd_cuda(torch.zeros(4, 256, dtype=torch.bfloat16),
                                        torch.zeros(256), None, 0, 0.0)


@pytest.mark.parametrize("widths,d,fusion,train,refused", [
    ([3072, 3072, 3072], 1024, "concatenation_prod", True, False),
    ([384, 384], 1024, "concatenation", True, True),
    ([640], 1024, "concatenation_diff", False, True),
    ([3072, 3072], 640, "concatenation_prod", True, True),
    ([3072, 3072], 640, "concatenation_prod", False, False),
    ([3072], 640, "concatenation", True, False),
])
def test_card_widths_are_checked_before_any_launch(widths, d, fusion, train, refused):
    """The card's dense scorer refuses, before its first launch, a layer
    width that is not a multiple of 256 and, with concatenation_prod, a
    latent width that the backward's side sums (256) or the eval prod layer
    (128) do not take."""
    if refused:
        with pytest.raises(ValueError, match="multiples? of"):
            tds.check_card_widths(widths, d, fusion, train)
    else:
        tds.check_card_widths(widths, d, fusion, train)


# ----------------------------------------------------------------------
# K1's forms: w1_prod and no hidden layer, and the padded chunk layout

K1_D, K1_H = 16, 128


def _k1_weights(rng, fusion, n_layers):
    in_dim = 2 * K1_D if fusion == "concatenation" else 3 * K1_D
    p = {"layers": [], "bns": [], "out": {
        "kernel": (rng.normal(size=(K1_H, 1)) / np.sqrt(K1_H)).astype(np.float32),
        "bias": np.array([0.1], np.float32)}}
    s = {"bns": []}
    for i in range(n_layers):
        fan = in_dim if i == 0 else K1_H
        p["layers"].append({"kernel": (rng.normal(size=(fan, K1_H)) * np.sqrt(2 / fan))
                            .astype(np.float32)})
        p["bns"].append({"scale": rng.uniform(0.5, 1.5, K1_H).astype(np.float32),
                         "bias": rng.normal(0, 0.2, K1_H).astype(np.float32)})
        s["bns"].append({"mean": rng.normal(0, 0.1, K1_H).astype(np.float32),
                         "var": rng.uniform(0.5, 2.0, K1_H).astype(np.float32)})
    return p, s


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fusion", FUSIONS)
def test_k1_zero_hidden_plain_matches_jax(fusion, dtype):
    """OUTPUT_MLP_NUM_LAYERS 1 in evaluation: the plain K1 chain (the first
    ReLU straight into w_out, bf16-rounded) against JAX's
    ``pair_logits_tiled`` with a ragged last tile: 1e-5 in float32, 5e-3 in
    bf16 (the test_torch_pair_scorer tolerances)."""
    rng = np.random.default_rng(5)
    p, s = _k1_weights(rng, fusion, 1)
    P_e = rng.normal(size=(3, K1_D)).astype(np.float32)
    L_e = rng.normal(size=(70, K1_D)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jf = jps.fold_output_mlp(jax.tree_util.tree_map(jnp.asarray, p),
                             jax.tree_util.tree_map(jnp.asarray, s), fusion, K1_D, dtype=jdt)
    want = np.asarray(jps.pair_logits_tiled(jf, jnp.asarray(P_e).astype(jdt),
                                            jnp.asarray(L_e).astype(jdt), label_tile=32,
                                            compute_dtype=jdt))
    t = from_jax_tree({"p": p, "s": s})
    tf = tps.fold_output_mlp(t["p"], t["s"], fusion, K1_D, dtype=tdt)
    assert not tf.hidden
    got = tps.pair_logits_tiled(tf, torch.from_numpy(P_e).to(tdt), torch.from_numpy(L_e).to(tdt),
                                label_tile=32, compute_dtype=tdt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 if dtype == "f32" else 5e-3, rtol=0)
    assert np.std(want) > 0.05


@pytest.mark.parametrize("fusion,n_layers", [
    ("concatenation_prod", 1), ("concatenation_prod", 2), ("concatenation_prod", 3),
    ("concatenation", 1),
])
def test_k1_plan_layout_with_prod_and_zero_hidden_matches_jax(fusion, n_layers):
    """The plain chain over K1's padded chunk layout (rows b * nl_pad + l,
    c and the label rows past L zero), with w1_prod and with no hidden
    layer, against JAX's ``pair_logits_tiled``: bf16, 5e-3; L 300 in chunks
    of 128, the last ragged."""
    rng = np.random.default_rng(20 + n_layers)
    p, s = _k1_weights(rng, fusion, n_layers)
    P_e = rng.normal(size=(3, K1_D)).astype(np.float32)
    L_e = rng.normal(size=(300, K1_D)).astype(np.float32)
    jf = jps.fold_output_mlp(jax.tree_util.tree_map(jnp.asarray, p),
                             jax.tree_util.tree_map(jnp.asarray, s), fusion, K1_D,
                             dtype=jnp.bfloat16)
    want = np.asarray(jps.pair_logits_tiled(jf, jnp.asarray(P_e).astype(jnp.bfloat16),
                                            jnp.asarray(L_e).astype(jnp.bfloat16),
                                            label_tile=64, compute_dtype=jnp.bfloat16))
    t = from_jax_tree({"p": p, "s": s})
    tf = tps.fold_output_mlp(t["p"], t["s"], fusion, K1_D, dtype=torch.bfloat16)
    plan = tps.launch_plan(3, 300, K1_H, max(n_layers - 1, 1), target_rows=3 * 128)
    assert [ch.nl for ch in plan.chunks] == [128, 128, 44]
    got = tps.pair_logits_plan_reference(tf, torch.from_numpy(P_e).to(torch.bfloat16),
                                         torch.from_numpy(L_e).to(torch.bfloat16), plan)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


@pytest.mark.parametrize("prod,n_hidden", [(True, 2), (False, 0), (True, 0)])
def test_kernel_inputs_take_prod_and_zero_hidden(prod, n_hidden):
    """``check_kernel_inputs`` takes w1_prod and an MLP with no hidden layer
    (the kernels run them), in bfloat16 and in float32 (the float32 kernel's
    prod layer and head); it raises for another dtype and for a w1_prod of
    another shape."""
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    folded = tps.FoldedOutputMLP(w1_p=t(128, 256), w1_l=t(128, 256), b1=t(256),
                                 w1_prod=t(128, 256) if prod else None,
                                 hidden=[(t(256, 256), t(256)) for _ in range(n_hidden)],
                                 w_out=t(256), b_out=torch.tensor(0.0))
    P_e, L_e = torch.zeros(2, 128), torch.zeros(5, 128)
    tps.check_kernel_inputs(folded, P_e, L_e, torch.bfloat16)
    tps.check_kernel_inputs(folded, P_e, L_e, torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        tps.check_kernel_inputs(folded, P_e, L_e, torch.float16)
    if prod:
        folded.w1_prod = t(128, 128)
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="w1_prod"):
                tps.check_kernel_inputs(folded, P_e, L_e, dtype)


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.5, 0.7])
def test_kernel_division_is_the_true_division(rate):
    """The kernels divide a kept bf16 value v by keep = bf16(1 - rate) as
    ``q = v r; q + fma(-q, keep, v) r`` with ``r = rn(1 / keep)``
    (csrc/bn_relu.cu:drop).  Emulated here (the fma's exact residual in
    float64), its bf16 rounding equals that of the true float32 quotient for
    every finite bf16 v below 2^120 (larger ones overflow the quotient),
    subnormals included."""
    bits = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    v = bits[np.isfinite(bits) & (np.abs(bits) < 2.0 ** 120)]
    keep = np.float32(torch.tensor(1.0 - rate, dtype=torch.bfloat16).float())
    assert np.float32(tds.keep_scale(rate, torch.bfloat16)) == keep
    r = np.float32(1.0) / keep
    q = v * r
    e = (v.astype(np.float64) - q.astype(np.float64) * np.float64(keep)).astype(np.float32)
    q1 = (q.astype(np.float64) + e.astype(np.float64) * np.float64(r)).astype(np.float32)
    got = torch.from_numpy(q1).to(torch.bfloat16)
    want = torch.from_numpy(v / keep).to(torch.bfloat16)
    assert len(v) > 60000 and torch.equal(got, want)


@pytest.mark.parametrize("prod", [False, True])
@pytest.mark.parametrize("n_hidden", [0, 1, 2, 3, 4])
def test_k1_workspace_chain(prod, n_hidden):
    """K1's launches of one chunk, walked as the wrapper runs them: every
    workspace a launch reads was written by the launch before it in the
    chunk (x1 by ``pair_train_prod`` for prod), every index lies within
    the workspaces the call allocates, and only the last layer writes
    none (it dots into the logits)."""
    from types import SimpleNamespace

    k = SimpleNamespace(wt=[None] * n_hidden, prod=prod)
    modes = tps._K1Kernel.modes(k)
    assert [i for i, _ in modes] == list(range(n_hidden))
    spaces = tps.k1_workspace_count(n_hidden, prod) if n_hidden or prod else 0
    written = {0: "x1"} if prod else {}
    for i, mode in modes:
        x_in, x_out = tps.k1_workspaces(i, mode, prod)
        assert (mode & 1) == (i == 0 and not prod) and (mode & 2) == (2 if i == n_hidden - 1
                                                                      else 0)
        if x_in is None:
            assert mode & 1
        else:
            assert x_in < spaces and written.get(x_in) == ("x1" if i == 0 else i - 1)
        if x_out is None:
            assert i == n_hidden - 1
        else:
            assert x_out < spaces and x_out != x_in
            written[x_out] = i
