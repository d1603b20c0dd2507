"""The float32 forms of the streamed scorer's kernels (K6: the ``_f32``
entries of ``csrc/streamed_bn.cu``) and of the dense scorer's (the ``_f32``
entries of ``csrc/bn_relu.cu`` and ``csrc/pair_dense.cu``,
``pair_scorer_f32.cu:pair_train_prod_f32``,
``pair_train_bwd_f32.cu:pair_train_dw_prod_f32``) against the JAX package on
the CPU (MIXED_PRECISION False).

The kernels cannot run here, so their arithmetic is emulated in their order
of work, every product and sum rounded to float32 on its own: K6's and K5's
column sums a warp every 8th row of a row chunk, the 8 warps in order, then
the chunks in order (``_kernel_sums``); the head's dot a warp a row, lane l
on columns 8l + 256j summed in column order, then a butterfly over the
lanes; db one block of 256 threads and a tree; the side sums over the
sequences in order and over the labels as the column sums; the prod GEMM and
dW_prod through the split of a float32 value into three bf16 pieces, stages
64 deep added in float32 (``bf16x3_product_emulation``, K4-bwd f32's dW
order on ``pair_dw_plan``'s 128-column tiles); dropout's kept value the true
float32 quotient.

Tolerances: the emulated chains within 1e-5 of each tensor's largest |value|
of JAX's float32 function at Precision.HIGHEST (logits, new running
statistics, every gradient), as tests/test_torch_pair_train_f32.py holds
the decomposed scorer.  dW_prod at a pair depth of 65,536 against float64
within 2 x 2^-24 x sqrt(rows / 64) of its largest |value| (that file's
figure for dW).  Dropout's float32 division: the same bits as the correctly
rounded quotient on 2^24 values a rate.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models.fusion import ProtNoteConfig as JaxConfig
from protnote_tpu.models.fusion import init_protnote as jax_init
from protnote_tpu.ops import pair_scorer as jps
from protnote_tpu.ops import streaming_train as jst
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import dense_scorer as tds
from protnote_tpu_torch.ops import streaming_train as tst
from protnote_tpu_torch.ops.pair_scorer import bf16x3_product_emulation
from test_torch_dense_scorer import _feed_masks
from test_torch_pair_train_f32 import (
    _kernel_sums,
    dw_depth_tol,
    emulated_pair_hidden,
    k4_dw,
    k5_grads,
)

REL_TOL = 1e-5
EPS = np.float32(1e-5)
TILE = tst.F32_TILE
LANES, VEC = 32, 8


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


# ----------------------------------------------------------------------
# K6's float32 kernels, emulated


def k6_moments(z, rows, r):
    """``stream_moments_f32``: the column sums of rows * zc and rows * zc^2,
    zc = z - r."""
    zc = _np(z) - _np(r)
    zm = zc * _np(rows)
    s1, s2 = _kernel_sums([zm, zm * zc], zc.shape[0])
    return _t(s1), _t(s2)


def k6_moments_grad(z, rows, r, g1, g2):
    """``stream_moments_backward_f32``: rows * (g1 + (2 g2) (z - r))."""
    zc = _np(z) - _np(r)
    return _t(_np(rows) * (_np(g1) + (np.float32(2) * _np(g2)) * zc))


def k6_affine_relu(z, inv, shift):
    return _t(np.maximum(_np(z) * _np(inv) + _np(shift), np.float32(0)))


def k6_affine_relu_grads(z, dy, inv, shift):
    """``affine_relu_backward_f32``: the gate the forward expression, dz =
    g inv, dinv and dshift the column sums of g z and g."""
    z, iv = _np(z), _np(inv)
    g = np.where(z * iv + _np(shift) > 0, _np(dy).astype(np.float32), np.float32(0))
    dinv, dshift = _kernel_sums([g * z, g], z.shape[0])
    return _t(g * iv), _t(dinv), _t(dshift)


def _lane_butterfly(products):
    """A warp's dot over a row: ``products`` (N, H) float32; lane l adds its
    columns 8l + 256j + e in (j, e) order, then five xor-shuffle adds; lane
    0's sum."""
    N, H = products.shape
    v = products.reshape(N, H // (LANES * VEC), LANES, VEC)
    acc = np.zeros((N, LANES), np.float32)
    for j in range(v.shape[1]):
        for e in range(VEC):
            acc = acc + v[:, j, :, e]
    lanes = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    return acc[:, 0]


def k6_head(z, inv, shift, w, b):
    """``stream_head_f32``: h = relu(z inv + shift) (not rounded) dotted with
    w (float32) by :func:`_lane_butterfly`, plus b."""
    h = np.maximum(_np(z) * _np(inv) + _np(shift), np.float32(0))
    return _t(_lane_butterfly(h * _np(w)) + np.float32(_np(b)))


def _block_sum(x):
    """db: one block of 256 threads, thread t adding rows t, t + 256, ... in
    order, then a tree over the threads."""
    n = -(-x.shape[0] // 256) * 256
    pad = np.zeros(n, np.float32)
    pad[:x.shape[0]] = x
    t = np.zeros(256, np.float32)
    for row in pad.reshape(-1, 256):
        t = t + row
    half = 128
    while half:
        t = t[:half] + t[half:2 * half]
        half //= 2
    return t[0]


def k6_head_grads(z, inv, shift, w, dout):
    """``stream_head_backward_f32``: dh = dout w (float32, not rounded), g
    = dh where the gate is open, dz = g inv; dinv, dshift, dw the column
    sums of g z, g and h dout; db the block sum of dout."""
    z, iv, d = _np(z), _np(inv), _np(dout).astype(np.float32)
    x = z * iv + _np(shift)
    h = np.maximum(x, np.float32(0))
    g = np.where(x > 0, d[:, None] * _np(w)[None, :], np.float32(0))
    dinv, dshift, dw = _kernel_sums([g * z, g, h * d[:, None]], z.shape[0])
    return _t(g * iv), _t(dinv), _t(dshift), _t(dw), torch.tensor(_block_sum(d))


def emulated_moments(z, rows, r):
    return tst._StreamMoments.apply(z, rows, r, k6_moments, k6_moments_grad)


def emulated_affine_relu(z, inv, shift):
    return tst._AffineRelu.apply(z, inv, shift, k6_affine_relu, k6_affine_relu_grads)


def emulated_head(z, inv, shift, w, b):
    return tst._StreamHead.apply(z, inv, shift, w, b, k6_head, k6_head_grads)


def _k6_inputs(N, H, seed):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(N, H)) + 1.0).astype(np.float32)
    rows = (rng.random((N, 1)) < 0.9).astype(np.float32)
    vec = lambda lo, hi: rng.uniform(lo, hi, H).astype(np.float32)  # noqa: E731
    return dict(z=z, rows=rows, r=vec(0.5, 1.5), inv=vec(0.5, 1.5), shift=vec(-1.2, 0.2),
                w=(rng.normal(size=H) * (6.0 / H) ** 0.5).astype(np.float32),
                b=np.float32(0.3), dy=rng.normal(size=(N, H)).astype(np.float32),
                dout=rng.normal(size=N).astype(np.float32),
                g=rng.normal(size=(2, H)).astype(np.float32))


@pytest.mark.parametrize("N,H", [(1505, 512), (3001, 256), (8, 256)])
def test_k6_f32_emulation_matches_jax(N, H):
    """Each K6 float32 kernel, emulated, against JAX's float32 expressions of
    the streamed sweeps (``_shifted_moments``, the affine + ReLU of
    ``forward_to``, the loss pass's dot at Precision.HIGHEST) and their
    vjp: every output within 1e-5 of its largest |value|."""
    x = _k6_inputs(N, H, N + H)
    z, rows, r = (jnp.asarray(x[k]) for k in ("z", "rows", "r"))
    inv, shift, w = (jnp.asarray(x[k]) for k in ("inv", "shift", "w"))

    def moments(z_):
        zc = z_ - r
        return jnp.sum(zc * rows, 0), jnp.sum(zc * zc * rows, 0)

    (m1, m2), vjp_m = jax.vjp(moments, z)
    dz_m = vjp_m((jnp.asarray(x["g"][0]), jnp.asarray(x["g"][1])))[0]
    y, vjp_a = jax.vjp(lambda z_, i_, s_: jax.nn.relu(z_ * i_ + s_), z, inv, shift)
    dz_a, dinv_a, dshift_a = vjp_a(jnp.asarray(x["dy"]))

    def head(z_, i_, s_, w_, b_):
        h = jax.nn.relu(z_ * i_ + s_)
        return jnp.dot(h, w_, precision=jax.lax.Precision.HIGHEST) + b_

    lg, vjp_h = jax.vjp(head, z, inv, shift, w, jnp.float32(x["b"]))
    want_h = vjp_h(jnp.asarray(x["dout"]))
    t = {k: _t(v) for k, v in x.items()}
    got = [*k6_moments(t["z"], t["rows"], t["r"]),
           k6_moments_grad(t["z"], t["rows"], t["r"], t["g"][0], t["g"][1]),
           k6_affine_relu(t["z"], t["inv"], t["shift"]),
           *k6_affine_relu_grads(t["z"], t["dy"], t["inv"], t["shift"]),
           k6_head(t["z"], t["inv"], t["shift"], t["w"], t["b"]),
           *k6_head_grads(t["z"], t["inv"], t["shift"], t["w"], t["dout"])]
    want = [m1, m2, dz_m, y, dz_a, dinv_a, dshift_a, lg, *want_h]
    names = ["s1", "s2", "dz_moments", "y", "dz_affine", "dinv", "dshift", "logits", "dz_head",
             "dinv_head", "dshift_head", "dw", "db"]
    assert tst._chunks(N)[0] == -(-N // 1000)
    for name, g, w_ in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(np.shape(w_)), name
        assert _rel(g, w_) <= REL_TOL, (name, _rel(g, w_))


def test_k6_f32_head_rounds_nothing_to_bf16():
    """The float32 head keeps h, w and dh = dout * w in float32: on values
    that bf16 cannot hold its logits and dz are the float32 expressions'
    (the bf16 head would round them 2^-9 away)."""
    N, H = 64, 256
    z = torch.full((N, H), 1.0 + 2.0 ** -12)
    one, zero = torch.ones(H), torch.zeros(H)
    w = torch.full((H,), 1.0 + 2.0 ** -13)
    dout = torch.full((N,), 1.0 + 2.0 ** -11)
    lg = k6_head(z, one, zero, w, torch.tensor(0.0))
    want = np.float32(256) * (np.float32(1.0 + 2.0 ** -12) * np.float32(1.0 + 2.0 ** -13))
    assert torch.equal(lg, torch.full((N,), float(want)))
    dz = k6_head_grads(z, one, zero, w, dout)[0]
    assert torch.equal(dz, torch.full((N, H), float(np.float32(1.0 + 2.0 ** -11)
                                                   * np.float32(1.0 + 2.0 ** -13))))
    assert torch.equal(tst._stream_head_plain(z, one, zero, w, torch.tensor(0.0)), lg)


# ----------------------------------------------------------------------
# the streamed scorer through the emulated kernels against JAX

SB, SL, SD, S_TILE = 5, 150, 128, 64  # H 256; 150 labels: three tiles, the last ragged


def _stream_weights(fusion, seed=0):
    cfg = JaxConfig(protein_embedding_dim=20, label_embedding_dim=20, latent_dim=SD,
                    projection_head_num_layers=2, output_mlp_num_layers=3,
                    output_mlp_hidden_dim_scale_factor=2, feature_fusion=fusion)
    params, state = jax_init(jax.random.PRNGKey(seed), cfg)
    p = jax.tree_util.tree_map(np.asarray, params["output_mlp"])
    s = jax.tree_util.tree_map(np.asarray, state["output_mlp"])
    rng = np.random.default_rng(seed)
    for i, st in enumerate(s["bns"]):
        n = st["mean"].shape[0]
        p["bns"][i] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                       "bias": rng.normal(0, 0.2, n).astype(np.float32)}
        s["bns"][i] = {"mean": rng.normal(0, 0.3, n).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    for lin in p["layers"] + [p["out"]]:
        lin["kernel"] = lin["kernel"] * np.float32(6 ** 0.5)
    return p, s


def _stream_inputs(seed=1):
    rng = np.random.default_rng(seed)
    em = np.ones(SB, np.float32)
    em[-1] = 0
    lm = (rng.random(SL) < 0.9).astype(np.float32)
    return (rng.normal(size=(SB, SD)).astype(np.float32),
            rng.normal(size=(SL, SD)).astype(np.float32), em, lm,
            rng.normal(size=(SB, SL)).astype(np.float32))


EMULATED_STREAM = (emulated_pair_hidden, emulated_moments, emulated_affine_relu, emulated_head)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("fusion", ["concatenation", "concatenation_diff"])
def test_streamed_f32_through_emulated_kernels_matches_jax(fusion, cache):
    """``pair_logits_streaming_train``'s float32 chain with K4, K4-bwd and K6
    replaced by their emulations (the card's launches) against JAX's
    ``pair_logits_streaming_train(compute_dtype=float32)``, with the z1
    cache and without, masked sequences and labels, H 256 in tiles of 64:
    the logits, the new running statistics, and the gradients of P_e, L_e
    and every output-MLP parameter, each within 1e-5 of its largest
    |value|."""
    p, s = _stream_weights(fusion)
    P_e, L_e, em, lm, wts = _stream_inputs()
    w = wts * em[:, None] * lm[None, :]

    def f(p_, P_, L_):
        lg, new = jst.pair_logits_streaming_train(
            p_, jax.tree_util.tree_map(jnp.asarray, s), P_, L_, fusion,
            example_mask=jnp.asarray(em), label_mask=jnp.asarray(lm), label_tile=S_TILE,
            compute_dtype=jnp.float32, cache_first=cache)
        return jnp.sum(jax.nn.sigmoid(lg) * jnp.asarray(w)), (lg, new)

    (_, (want_lg, want_new)), want_g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(P_e), jnp.asarray(L_e))
    t = from_jax_tree({"p": p, "s": s})
    tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True), t["p"])
    Pg, Lg = _t(P_e).requires_grad_(True), _t(L_e).requires_grad_(True)
    lg, new = tst._streaming(tp, t["s"], Pg, Lg, fusion, _t(em), _t(lm), S_TILE, torch.float32,
                             cache, EMULATED_STREAM)
    (torch.sigmoid(lg) * _t(w)).sum().backward()
    assert lg.dtype == torch.float32 and float(np.std(np.asarray(want_lg))) > 0.5
    assert _rel(lg.detach(), want_lg) <= REL_TOL
    got_new = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: x.numpy(), new))
    want_new = jax.tree_util.tree_leaves(want_new)
    assert len(got_new) == len(want_new) == 6
    for a, b in zip(got_new, want_new):
        assert _rel(a, b) <= REL_TOL
    got_g = jax.tree_util.tree_leaves((jax.tree_util.tree_map(lambda x: x.grad.numpy(), tp),
                                       Pg.grad.numpy(), Lg.grad.numpy()))
    want_leaves = jax.tree_util.tree_leaves(want_g)
    assert len(got_g) == len(want_leaves) == 13
    for i, (a, b) in enumerate(zip(got_g, want_leaves)):
        assert _rel(a, b) <= REL_TOL, (i, _rel(a, b))


# ----------------------------------------------------------------------
# the dense scorer's float32 kernels, emulated


def _drop(y, seed, layer, rate, keep):
    """Dropout as the float32 kernels apply it: the counter hash's mask, the
    kept value the true float32 quotient y / keep."""
    if rate <= 0:
        return y
    N, H = y.shape
    mask = tds.keep_mask(seed, layer, rate, torch.arange(N)[:, None],
                         torch.arange(H)[None, :]).numpy()
    return np.where(mask, y / np.float32(keep), np.float32(0)).astype(np.float32)


def k5_dense_forward(z, rows, n, scale, bias, seed, layer, rate):
    """``bn_relu_dropout_forward_f32``: the centred moments in two passes of
    the column sums (mean = sum(rows z) / n, then var = sum(rows (z -
    mean)^2) / n), the affine, y = dropout(relu(z inv + shift))."""
    z, m = _np(z), _np(rows)
    t1, _ = _kernel_sums([z * m, z * m * z], z.shape[0])
    nf = np.float32(_np(n))
    mean = t1 / nf
    zc = z - mean
    _, t2 = _kernel_sums([zc * m, zc * m * zc], z.shape[0])
    var = t2 / nf
    istd = np.float32(1) / np.sqrt(var + EPS)
    inv = istd * _np(scale).astype(np.float32)
    shift = _np(bias).astype(np.float32) - mean * inv
    y = _drop(np.maximum(z * inv + shift, np.float32(0)), seed, layer, rate,
              tds.keep_scale(rate, torch.float32))
    return tuple(_t(v) for v in (y, mean, var, istd, inv, shift))


def k5_dense_grads(z, dy, rows, n, scale, mean, istd, inv, shift, seed, layer, rate):
    """``bn_relu_dropout_backward_f32``: dy through dropout's transpose (the
    mask drawn again), then K5's two-pass backward."""
    dy = _drop(_np(dy).astype(np.float32), seed, layer, rate,
               tds.keep_scale(rate, torch.float32))
    return k5_grads(z, _t(dy), rows, _np(n), scale, mean, istd, inv, shift)


def k5_bias_forward(z, bias, seed, layer, rate):
    """``bias_relu_dropout_forward_f32``: dropout(relu(z + bias))."""
    return _t(_drop(np.maximum(_np(z) + _np(bias), np.float32(0)), seed, layer, rate,
                    tds.keep_scale(rate, torch.float32)))


def k5_bias_grads(z, dy, bias, seed, layer, rate):
    """``bias_relu_dropout_backward_f32``: dz = dropout^T(dy) where z + bias
    > 0; dbias its column sums."""
    g = _drop(_np(dy).astype(np.float32), seed, layer, rate, tds.keep_scale(rate, torch.float32))
    dz = np.where(_np(z) + _np(bias) > 0, g, np.float32(0))
    return _t(dz), _t(_kernel_sums([dz], dz.shape[0])[0])


def side_sums(x, B, L, u=None, v=None):
    """``pair_side_sums_f32``: sl[l] = sum_b x[b, l] u[b] over b in order;
    sb[b] = sum_l x[b, l] v[l] in the wrapper's label chunks
    (``side_sums_plan``, 64 labels): in a chunk, warp w of its 8 adds labels
    w, w + 8, ... below L in order, the warps are added in order, then the
    chunks in order."""
    x = _np(x).reshape(B, L, -1)
    xu = x if u is None else x * _np(u)[:, None, :]
    sl = np.zeros(x.shape[1:], np.float32)
    for b in range(B):
        sl = sl + xu[b]
    xv = x if v is None else x * _np(v)[None, :, :]
    chunks, per = tds.side_sums_plan(L)
    warps = per // 8
    sb = np.zeros((B, x.shape[2]), np.float32)
    for c in range(chunks):
        t = np.zeros_like(sb)
        for w in range(warps):
            acc = np.zeros_like(sb)
            for i in range(8):
                lab = c * per + w + warps * i
                if lab < L:
                    acc = acc + xv[:, lab]
            t = t + acc
        sb = sb + t
    return _t(sb), _t(sl)


def prod_forward(a, c, P_e, L_e, w_prod):
    """``pair_train_prod_f32``: the split product of p[b] * l[l] with W_prod,
    plus a[b] + c[l], rows b * L + l."""
    B, L = a.shape[0], c.shape[0]
    prod = (P_e[:, None, :] * L_e[None, :, :]).reshape(B * L, -1)
    return bf16x3_product_emulation(prod, w_prod.float()) + \
        (a[:, None, :] + c[None, :, :]).reshape(B * L, -1)


def dw_prod(P_e, L_e, dz, sms=3):
    """``pair_train_dw_prod_f32``: K4-bwd f32's dW order with x1 = p * l."""
    B, K = P_e.shape
    plan = tst.pair_dw_plan(B, L_e.shape[0], K, dz.shape[1], sms, block_n=TILE)
    return k4_dw(P_e, L_e, dz, plan, x1_of=lambda p, lr: p * lr)


def first_forward(a, c, P_e, L_e, w_prod):
    if w_prod is not None:
        return prod_forward(a, c, P_e, L_e, w_prod)
    B, L = a.shape[0], c.shape[0]
    return (a[:, None, :] + c[None, :, :]).reshape(B * L, -1)


def first_backward(a, c, P_e, L_e, w_prod, dz):
    """The first layer's backward as the card runs it: the side sums of dz;
    for prod dW_prod, dJ = dz @ W_prod^T (cuBLAS float32) and dJ's side sums
    weighted by the other side's rows."""
    B, L = a.shape[0], c.shape[0]
    da, dc = side_sums(dz, B, L)
    if w_prod is None:
        return da, dc, None, None, None
    dw = dw_prod(P_e, L_e, dz)
    dJ = dz @ w_prod.t()
    dP, dL = side_sums(dJ, B, L, u=P_e, v=L_e)
    return da, dc, dP, dL, dw


def emulated_first(a, c, P_e, L_e, w_prod=None):
    return tds._PairFirst.apply(a, c, P_e, L_e, w_prod, first_forward, first_backward)


def emulated_bn_dropout(z, rows, n, scale, bias, seed=None, layer=0, rate=0.0):
    return tds._BnReluDropout.apply(z, rows, n, scale, bias, tds._no_seed(seed, z.device),
                                    layer, float(rate), k5_dense_forward, k5_dense_grads)


def emulated_bias_dropout(z, bias, seed=None, layer=0, rate=0.0):
    return tds._BiasReluDropout.apply(z, bias, tds._no_seed(seed, z.device), layer, float(rate),
                                      k5_bias_forward, k5_bias_grads)


EMULATED_DENSE = (emulated_first, emulated_bn_dropout, emulated_bias_dropout,
                  emulated_affine_relu)
DB, DL, DD, D_SCALE = 5, 21, 128, 2  # H 256
RATE = 0.25
SEED = torch.tensor([123456789, 987654321], dtype=torch.int64)


def _dense_weights(fusion, bn, seed=0):
    cfg = JaxConfig(protein_embedding_dim=20, label_embedding_dim=20, latent_dim=DD,
                    projection_head_num_layers=2, output_mlp_num_layers=3,
                    output_mlp_hidden_dim_scale_factor=D_SCALE, feature_fusion=fusion,
                    output_mlp_batchnorm=bn)
    params, state = jax_init(jax.random.PRNGKey(seed), cfg)
    p = jax.tree_util.tree_map(np.asarray, params["output_mlp"])
    s = jax.tree_util.tree_map(np.asarray, state["output_mlp"]) if bn else None
    rng = np.random.default_rng(seed)
    for i in range(3 if bn else 0):
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


def _dense_inputs(seed=1):
    rng = np.random.default_rng(seed)
    em = (np.arange(DB) < DB - 1).astype(np.float32)
    lm = (np.arange(DL) < DL - 3).astype(np.float32)
    return (rng.normal(size=(DB, DD)).astype(np.float32),
            rng.normal(size=(DL, DD)).astype(np.float32), em, lm,
            (rng.choice([-1.0, 1.0], size=(DB, DL)) / 16).astype(np.float32))


def _jax_dense(p, s, P_e, L_e, em, lm, wts, fusion, train, rate, remat):
    pair_mask = jnp.asarray(em)[:, None] * jnp.asarray(lm)[None, :]
    s_j = None if s is None else jax.tree_util.tree_map(jnp.asarray, s)

    def f(p_, P_, L_):
        lg, new = jps.pair_logits_dense(p_, s_j, P_, L_, fusion, train=train, dropout=rate,
                                        rng=jax.random.PRNGKey(0) if rate > 0 else None,
                                        pair_mask=pair_mask if train else None, remat=remat)
        return jnp.sum(lg * jnp.asarray(wts)), (lg, new)

    (_, (lg, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(P_e), jnp.asarray(L_e))
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), (lg, new, grads))


def _port_dense(p, s, P_e, L_e, em, lm, wts, fusion, train, rate, remat):
    t = from_jax_tree({"p": p, "s": s} if s is not None else {"p": p})
    tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True), t["p"])
    Pg, Lg = _t(P_e).requires_grad_(True), _t(L_e).requires_grad_(True)
    lg, new = tds._dense(tp, t.get("s"), Pg, Lg, fusion, train, rate,
                         SEED if rate > 0 else None, _t(em) if train else None,
                         _t(lm) if train else None, remat, torch.float32, EMULATED_DENSE)
    (lg * _t(wts)).sum().backward()
    grads = (jax.tree_util.tree_map(lambda x: x.grad.numpy(), tp), Pg.grad.numpy(),
             Lg.grad.numpy())
    new = None if new is None else jax.tree_util.tree_map(lambda x: x.detach().numpy(), new)
    return lg.detach().numpy(), new, grads


def _dense_masks(rate):
    """The keep masks of the two dropout layers, as the port's hash gives
    them (fed to JAX's dropout)."""
    rows, cols = torch.arange(DB * DL)[:, None], torch.arange(DD * D_SCALE)[None, :]
    return [tds.keep_mask(SEED, i, rate, rows, cols).numpy() for i in range(2)]


@pytest.mark.parametrize("fusion,bn,rate,remat", [
    (fusion, bn, rate, False) for fusion in ("concatenation", "concatenation_diff",
                                             "concatenation_prod")
    for bn in (True, False) for rate in (0.0, RATE)
] + [("concatenation", True, RATE, True), ("concatenation_prod", False, RATE, True),
     ("concatenation_prod", True, 0.0, True)])
def test_dense_f32_train_through_emulated_kernels_matches_jax(fusion, bn, rate, remat,
                                                              monkeypatch):
    """The dense scorer's float32 training chain with its kernels replaced
    by their emulations (the first layer and its backward, K5's dense forms
    with dropout) against JAX's ``pair_logits_dense`` in float32, dropout on
    the port's masks fed to JAX, 5 sequences x 21 labels (one sequence and
    three labels masked), d 128, H 256: logits, new running statistics and
    every gradient within 1e-5 of its largest |value|."""
    if rate > 0:
        _feed_masks(monkeypatch, _dense_masks(rate))
    p, s = _dense_weights(fusion, bn)
    P_e, L_e, em, lm, wts = _dense_inputs()
    want = _jax_dense(p, s, P_e, L_e, em, lm, wts, fusion, True, rate, remat)
    got = _port_dense(p, s, P_e, L_e, em, lm, wts, fusion, True, rate, remat)
    assert float(np.std(want[0])) > 0.3
    assert _rel(got[0], want[0]) <= REL_TOL
    pairs = list(zip(jax.tree_util.tree_leaves(got[1]), jax.tree_util.tree_leaves(want[1])))
    pairs += list(zip(jax.tree_util.tree_leaves(got[2]), jax.tree_util.tree_leaves(want[2])))
    assert len(pairs) == (6 + 13 if bn else 10)
    for i, (a, b) in enumerate(pairs):
        assert a.shape == b.shape and _rel(a, b) <= REL_TOL, (i, _rel(a, b))


@pytest.mark.parametrize("fusion", ["concatenation", "concatenation_diff", "concatenation_prod"])
@pytest.mark.parametrize("bn", [True, False])
def test_dense_f32_eval_through_emulated_kernels_matches_jax(fusion, bn):
    """``PAIR_BACKEND dense`` evaluation in float32 through the emulated
    kernels (the first layer, K6's affine + ReLU on the running statistics
    or the bias form) against JAX's ``pair_logits_dense(train=False)``: the
    logits within 1e-5 of their largest |value|."""
    p, s = _dense_weights(fusion, bn)
    P_e, L_e, _, _, _ = _dense_inputs()
    want, _ = jps.pair_logits_dense(jax.tree_util.tree_map(jnp.asarray, p),
                                    None if s is None else jax.tree_util.tree_map(jnp.asarray, s),
                                    jnp.asarray(P_e), jnp.asarray(L_e), fusion, train=False)
    t = from_jax_tree({"p": p, "s": s} if s is not None else {"p": p})
    got, state = tds._dense(t["p"], t.get("s"), _t(P_e), _t(L_e), fusion, False, 0.0, None,
                            None, None, False, torch.float32, EMULATED_DENSE)
    assert float(np.std(np.asarray(want))) > 0.3
    assert _rel(got, want) <= REL_TOL


# ----------------------------------------------------------------------
# the prod GEMMs, the side sums and dropout's division


@pytest.mark.parametrize("B,L,d,H", [(5, 150, 128, 256), (2, 301, 256, 128), (3, 1, 128, 128)])
def test_prod_gemms_emulation_matches_jax(B, L, d, H):
    """``pair_train_prod_f32`` and ``pair_train_dw_prod_f32`` (dW's tiles cut
    into pieces on 3 SMs) and the side sums of dJ, emulated, against JAX's
    float32 prod block through the first Linear and its vjp (HIGHEST): z,
    dP_e, dL_e and dW_prod within 1e-5 of their largest |value|."""
    rng = np.random.default_rng(B * 1000 + L)
    P_e, L_e = (rng.normal(size=(B, d)).astype(np.float32),
                rng.normal(size=(L, d)).astype(np.float32))
    a, c = rng.normal(size=(B, H)).astype(np.float32), rng.normal(size=(L, H)).astype(np.float32)
    w = (rng.normal(size=(d, H)) / np.sqrt(d)).astype(np.float32)
    dz = rng.normal(size=(B * L, H)).astype(np.float32)

    def f(P_, L_, w_):
        prod = (P_[:, None, :] * L_[None, :, :]).reshape(B * L, d)
        ac = (jnp.asarray(a)[:, None, :] + jnp.asarray(c)[None, :, :]).reshape(B * L, H)
        return jnp.dot(prod, w_, precision=jax.lax.Precision.HIGHEST) + ac

    z, vjp = jax.vjp(f, jnp.asarray(P_e), jnp.asarray(L_e), jnp.asarray(w))
    want = [z, *vjp(jnp.asarray(dz))]
    got_z = prod_forward(_t(a), _t(c), _t(P_e), _t(L_e), _t(w))
    _, _, dP, dL, dw = first_backward(_t(a), _t(c), _t(P_e), _t(L_e), _t(w), _t(dz))
    for name, g, w_ in zip(("z", "dP_e", "dL_e", "dW_prod"), (got_z, dP, dL, dw), want):
        assert tuple(g.shape) == tuple(w_.shape)
        assert _rel(g, w_) <= REL_TOL, (name, _rel(g, w_))


def test_dw_prod_emulation_at_depth_against_float64():
    """dW_prod at a pair depth of 65,536 (2 sequences x 32,768 labels, one
    tile, 1,024 steps added in float32) against float64: within the depth's
    figure, which the plain float32 product also meets."""
    B, L, K = 2, 32768, 128
    rng = np.random.default_rng(6)
    P_e, L_e = rng.normal(size=(B, K)).astype(np.float32), rng.normal(size=(L, K)).astype(
        np.float32)
    dz = (1e-3 * rng.normal(size=(B * L, K))).astype(np.float32)
    got = dw_prod(_t(P_e), _t(L_e), _t(dz), sms=1)
    x1 = (P_e[:, None, :] * L_e[None, :, :]).reshape(B * L, K)  # one float32 rounding
    truth = x1.astype(np.float64).T @ dz.astype(np.float64)
    tol = dw_depth_tol(B * L)
    assert _rel(got, truth) <= tol
    assert _rel(_t(x1).t() @ _t(dz), truth) <= tol


@pytest.mark.parametrize("B,L,K", [(5, 3001, 256), (3, 7, 512)])
def test_side_sums_emulation_matches_the_plain_sums(B, L, K):
    """``pair_side_sums_f32``'s order of work (over the sequences in order;
    over the labels in the wrapper's chunks, their warps and the chunks, L
    not a multiple of the chunk) against the plain float32 sums and a
    float64 truth, weighted and not: within 1e-5."""
    _check_side_sums(B, L, K)


@pytest.mark.parametrize("B,L,K", [(5, 3001, 256), (2, 200, 256), (3, 64, 512), (2, 63, 256),
                                   (2, 65, 256), (4, 128, 256)])
def test_side_sums_emulation_at_chunk_edges(B, L, K):
    """The same where L is a multiple of the 64-label chunk, one label
    more or fewer, shorter than a chunk, or none of these."""
    _check_side_sums(B, L, K)


def _check_side_sums(B, L, K):
    rng = np.random.default_rng(L)
    x = rng.normal(size=(B * L, K)).astype(np.float32)
    u, v = rng.normal(size=(B, K)).astype(np.float32), rng.normal(size=(L, K)).astype(np.float32)
    for uu, vv in ((None, None), (u, v)):
        sb, sl = side_sums(_t(x), B, L, None if uu is None else _t(uu),
                           None if vv is None else _t(vv))
        x3 = x.astype(np.float64).reshape(B, L, K)
        wl = 1.0 if vv is None else vv.astype(np.float64)[None]
        wb = 1.0 if uu is None else uu.astype(np.float64)[:, None]
        assert _rel(sb, (x3 * wl).sum(1)) <= REL_TOL
        assert _rel(sl, (x3 * wb).sum(0)) <= REL_TOL
        x3f = torch.from_numpy(x).view(B, L, K)
        plain_b = (x3f * (1.0 if vv is None else torch.from_numpy(vv)[None])).sum(1)
        plain_l = (x3f * (1.0 if uu is None else torch.from_numpy(uu)[:, None])).sum(0)
        assert _rel(sb, plain_b) <= REL_TOL
        assert _rel(sl, plain_l) <= REL_TOL


@pytest.mark.parametrize("B,L", [(4, 301), (3, 64)])
def test_side_sums_emulation_of_bf16_x_matches_the_plain_version(B, L):
    """``pair_side_sums`` on bf16 x, u and v (each product exact in float32)
    in its order of work against the plain version the wrapper takes on the
    CPU (``_first_bwd_plain``'s float32 sums of dz, and dJ's sums weighted
    by the other side's rows): within 1e-5; sl is the sum over the
    sequences in order, so it equals the plain float32 loop's bits."""
    K = 256
    rng = np.random.default_rng(L)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    x = bf(rng.normal(size=(B * L, K)))
    u, v = bf(rng.normal(size=(B, K))), bf(rng.normal(size=(L, K)))
    sb, sl = side_sums(x.float(), B, L)
    a, c = torch.zeros(B, K), torch.zeros(L, K)
    da, dc, *_ = tds._first_bwd_plain(a, c, u, v, None, x)
    assert _rel(sb, da) <= REL_TOL and _rel(sl, dc) <= REL_TOL
    wb, wl = side_sums(x.float(), B, L, u.float(), v.float())
    x3 = x.float().view(B, L, K)
    assert _rel(wb, (x3 * v.float()[None]).sum(1)) <= REL_TOL
    assert _rel(wl, (x3 * u.float()[:, None]).sum(0)) <= REL_TOL
    loop = torch.zeros(L, K)
    for b in range(B):
        loop = loop + x3[b] * u.float()[b]
    assert torch.equal(wl, loop)


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.25, 0.5])
def test_f32_dropout_division_is_the_true_division(rate):
    """The float32 kernels divide a kept element by keep_f = float32(1 -
    rate) with ``__fdiv_rn``: correctly rounded.  The plain version's
    division gives those bits on 2^24 float32 values (every significand of
    [1, 2), scaled across exponents, and their negatives): the quotient
    computed in float64 and rounded once to float32 (exact for +, -, x, /),
    and JAX's float32 ``x / keep`` on a slice of them."""
    keep = tds.keep_scale(rate, torch.float32)
    assert keep == float(np.float32(1.0 - rate))
    sig = (np.arange(2 ** 23, dtype=np.uint32) | np.uint32(127 << 23)).view(np.float32)
    exps = np.float32(2.0) ** np.array([-60, -3, 0, 5, 40], np.float32)
    y = np.concatenate([sig * e for e in exps] + [-sig[::4] * exps[1]])
    y = y[: 2 ** 24] if y.size >= 2 ** 24 else np.concatenate([y, -sig[1::4]])[: 2 ** 24]
    assert y.size == 2 ** 24 and y.dtype == np.float32
    want = (y.astype(np.float64) / np.float64(np.float32(keep))).astype(np.float32)
    yt = torch.from_numpy(y).reshape(-1, 256)
    got = (yt / torch.tensor(keep)).numpy().reshape(-1)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    j = np.asarray(jnp.asarray(y[:1 << 20]) / (1.0 - rate))
    assert np.array_equal(j.view(np.uint32), want[:1 << 20].view(np.uint32))
    # the plain dropout keeps those bits where its mask keeps
    seed = torch.tensor([7, 8], dtype=torch.int64)
    kept = tds._drop_plain(yt[:4096], seed, 0, rate)
    mask = kept != 0
    assert torch.equal(kept[mask], torch.from_numpy(want[:4096 * 256]).reshape(-1, 256)[mask])


# ----------------------------------------------------------------------
# the launch counts


def test_streamed_launches_in_float32():
    """In float32 the streamed scorer's schedule counts the ``_f32`` forms of
    K4, K4-bwd and K6 as the bf16 schedule counts their bf16 forms, and
    nothing else; K5 never."""
    for depth, tiles, cache in ((3, 16, True), (3, 16, False), (2, 3, True), (1, 4, False)):
        bf16 = tst.streamed_launches(depth, tiles, cache)
        f32 = tst.streamed_launches(depth, tiles, cache, torch.float32)
        assert set(f32) == set(bf16) == set(tst.LAUNCHES)
        assert {k: v for k, v in f32.items() if v} == \
            {f"{k}_f32": v for k, v in bf16.items() if v}
        assert f32["bn_relu_forward_f32"] == f32["bn_relu_backward_f32"] == 0
    assert tst.streamed_launches(3, 16, True, torch.float32)["stream_head_f32"] == 32


def test_streamed_f32_schedule_is_the_counted_chain():
    """The float32 streamed chain on CPU tensors, each kernel's plain version
    counted under its ``_f32`` name, calls each as often as
    ``streamed_launches(..., float32)`` says, with the z1 cache and
    without."""
    counts = {k: 0 for k in tst.LAUNCHES}

    def counted(names, fn):
        def f(*args):
            for name in names:
                counts[name] += 1
            return fn(*args)

        return f

    def hidden(a2, c2, w):
        return tst._PairHidden.apply(
            a2, c2, w, counted(["pair_train_hidden_f32"], tst._pair_hidden_fwd_plain),
            counted(["pair_train_dx_f32", "pair_train_dw_f32"],
                    tst._pair_hidden_backward_plain))

    def k6(fn, name, plain, grads):
        return lambda *args: fn.apply(*args, counted([f"{name}_f32"], plain),
                                      counted([f"{name}_backward_f32"], grads))

    ops = (hidden,
           k6(tst._StreamMoments, "stream_moments", tst._stream_moments_plain,
              tst._stream_moments_grad_plain),
           k6(tst._AffineRelu, "affine_relu", tst._affine_relu_plain,
              tst._affine_relu_grads_plain),
           k6(tst._StreamHead, "stream_head", tst._stream_head_plain,
              tst._stream_head_grads_plain))
    p, s = _stream_weights("concatenation")
    P_e, L_e, em, lm, _ = _stream_inputs()
    t = from_jax_tree({"p": p, "s": s})
    tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True), t["p"])
    for cache in (True, False):
        for k in counts:
            counts[k] = 0
        lg, _ = tst._streaming(tp, t["s"], _t(P_e), _t(L_e), "concatenation", _t(em), _t(lm),
                               S_TILE, torch.float32, cache, ops)
        lg.sum().backward()
        assert counts == tst.streamed_launches(3, -(-SL // S_TILE), cache, torch.float32)


@pytest.mark.parametrize("train,bn,prod,remat,chunks", [
    (True, True, False, False, 1), (True, False, True, True, 1), (True, True, True, False, 1),
    (False, True, False, False, 3), (False, False, True, False, 2),
])
def test_dense_launches_in_float32(train, bn, prod, remat, chunks):
    """In float32 the dense scorer's schedule counts the ``_f32`` forms as
    the bf16 schedule counts the bf16 forms, and every key of
    ``LAUNCHES``."""
    bf16 = tds.dense_launches(3, train, bn, prod, chunks, remat)
    f32 = tds.dense_launches(3, train, bn, prod, chunks, remat, dtype=torch.float32)
    assert set(f32) == set(tds.LAUNCHES)
    assert {k: v for k, v in f32.items() if v} == {f"{k}_f32": v for k, v in bf16.items() if v}
    assert sum(f32.values()) == sum(bf16.values()) > 0


def test_dense_f32_schedule_is_the_counted_chain():
    """The dense float32 chain on CPU tensors, each kernel's plain version
    counted under its ``_f32`` name, calls each as often as
    ``dense_launches(..., float32)`` says: training with prod, no BN,
    dropout and remat, and with BN; evaluation in label chunks."""
    counts = {k: 0 for k in tds.LAUNCHES}

    def count(name, fn):
        def f(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)

        return f

    def first_fwd(a, c, P_e, L_e, w_prod):
        counts["pair_train_prod_f32" if w_prod is not None else "pair_first_add_f32"] += 1
        return tds._first_fwd_plain(a, c, P_e, L_e, w_prod)

    def first_bwd(a, c, P_e, L_e, w_prod, dz):
        counts["pair_side_sums_f32"] += 1 if w_prod is None else 2
        counts["pair_train_dw_prod_f32"] += int(w_prod is not None)
        return tds._first_bwd_plain(a, c, P_e, L_e, w_prod, dz)

    def affine(z, inv, shift):
        # evaluation's BN runs K6's affine_relu: not a dense-scorer launch
        return tst.affine_relu_reference(z, inv, shift)

    ops = (lambda a, c, P, L, w=None: tds._PairFirst.apply(a, c, P, L, w, first_fwd, first_bwd),
           lambda z, rows, n, sc, bi, seed=None, layer=0, rate=0.0: tds._BnReluDropout.apply(
               z, rows, n, sc, bi, tds._no_seed(seed, z.device), layer, float(rate),
               count("bn_relu_dropout_forward_f32", tds._bn_relu_dropout_fwd_plain),
               count("bn_relu_dropout_backward_f32", tds._bn_relu_dropout_grads_plain)),
           lambda z, bi, seed=None, layer=0, rate=0.0: tds._BiasReluDropout.apply(
               z, bi, tds._no_seed(seed, z.device), layer, float(rate),
               count("bias_relu_dropout_forward_f32", tds._bias_relu_dropout_fwd_plain),
               count("bias_relu_dropout_backward_f32", tds._bias_relu_dropout_grads_plain)),
           affine)
    P_e, L_e, em, lm, wts = _dense_inputs()
    for fusion, bn, remat in (("concatenation_prod", False, True), ("concatenation", True, False)):
        p, s = _dense_weights(fusion, bn)
        t = from_jax_tree({"p": p, "s": s} if s is not None else {"p": p})
        tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True), t["p"])
        prod = fusion == "concatenation_prod"
        for k in counts:
            counts[k] = 0
        lg, _ = tds._dense(tp, t.get("s"), _t(P_e), _t(L_e), fusion, True, RATE, SEED, _t(em),
                           _t(lm), remat, torch.float32, ops)
        (lg * _t(wts)).sum().backward()
        assert counts == tds.dense_launches(3, True, bn, prod, remat=remat, dtype=torch.float32)
        for k in counts:
            counts[k] = 0
        old = tds.EVAL_CHUNK_ROWS
        tds.EVAL_CHUNK_ROWS = DB * 8  # label chunks of 8 labels
        try:
            tds._dense(t["p"], t.get("s"), _t(P_e), _t(L_e), fusion, False, 0.0, None, None,
                       None, False, torch.float32, ops)
        finally:
            tds.EVAL_CHUNK_ROWS = old
        assert counts == tds.dense_launches(3, False, bn, prod, -(-DL // 8),
                                            dtype=torch.float32)
