"""The port's int8 pair scorer (K2's plain version, protnote_tpu_torch/ops/
pair_scorer.py) against the JAX ``protnote_tpu.ops.pair_scorer`` on the same
inputs, on the CPU.

The first-layer inputs (``P_e``, ``L_e``, ``w1_p``, ``w1_l``, ``b1``) lie on a
dyadic grid (multiples of 2^-4 and 2^-8 with a few significant bits), so the
per-side products ``a`` and ``c`` are exact in float32 whatever order either
side sums in: both then quantize the same ``relu(a + c)``, and the int32
GEMMs are exact on both sides.  What may still differ:

* nothing else by construction: the compiled JAX chain multiplies by the
  float32 reciprocal of its constant scales (``h / s0``, ``h_b / s_{i+1}``,
  ``m / 127`` run as multiplies, see the first test), and so does the port.
  The tests still count the carried codes that differ and allow at most 1
  in 10^4, for a quotient that other float32 towers could put on a
  rounding edge;
* the logit dot with ``w_out`` sums in another order: logits within 1e-5
  (float32 and bfloat16 compute alike: the bf16 operands' products are
  exact in float32), where every carried code agrees.

Hidden weights are plain normal draws: ``quantize_folded`` must give the
same codes (exactly) and scales (1e-7 relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.ops import pair_scorer as jps
from protnote_tpu_torch.ops import pair_scorer as tps

B, L, D, TILE = 3, 21, 64, 8  # ragged last tile: 21 = 2 x 8 + 5
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_ATOL = 1e-5
MAX_CODE_FRACTION = 1e-4


def _grid(rng, shape, step, lim):
    return (np.clip(np.round(rng.normal(size=shape) * lim / 3), -lim, lim) * step).astype(np.float32)


def _weights(H, seed=0, n_hidden=2):
    rng = np.random.default_rng(seed)
    return dict(
        w1_p=_grid(rng, (D, H), 2.0 ** -8, 127), w1_l=_grid(rng, (D, H), 2.0 ** -8, 127),
        b1=_grid(rng, (H,), 2.0 ** -8, 127),
        hidden=[((rng.normal(size=(H, H)) * np.sqrt(2.0 / H)).astype(np.float32),
                 (rng.normal(size=H) * 0.1).astype(np.float32)) for _ in range(n_hidden)],
        w_out=(rng.normal(size=H) / np.sqrt(H)).astype(np.float32),
        b_out=np.float32(-0.5))


def _inputs(seed=1, b=B, n_labels=L):
    rng = np.random.default_rng(seed)
    return _grid(rng, (b, D), 2.0 ** -4, 15), _grid(rng, (n_labels, D), 2.0 ** -4, 15)


def _folded(w, dtype):
    """The same weights as a JAX and a port ``FoldedOutputMLP`` in the
    compute dtype (biases and b_out in float32, as ``fold_output_mlp``)."""
    jdt, tdt = DTYPES[dtype]
    j = jps.FoldedOutputMLP(
        w1_p=jnp.asarray(w["w1_p"], jdt), w1_l=jnp.asarray(w["w1_l"], jdt),
        b1=jnp.asarray(w["b1"], jdt), w1_prod=None,
        hidden=[(jnp.asarray(W, jdt), jnp.asarray(b, jdt)) for W, b in w["hidden"]],
        w_out=jnp.asarray(w["w_out"], jdt), b_out=jnp.asarray(w["b_out"]))
    t = tps.FoldedOutputMLP(
        w1_p=torch.from_numpy(w["w1_p"]).to(tdt), w1_l=torch.from_numpy(w["w1_l"]).to(tdt),
        b1=torch.from_numpy(w["b1"]).to(tdt), w1_prod=None,
        hidden=[(torch.from_numpy(W).to(tdt), torch.from_numpy(b).to(tdt))
                for W, b in w["hidden"]],
        w_out=torch.from_numpy(w["w_out"]).to(tdt), b_out=torch.tensor(w["b_out"]))
    return j, t


def _jax_carry(jq, P_e, L_e, l0, nl, compute_dtype):
    """What the JAX chain's first hidden layer carries for one label chunk,
    by the expressions of ``pair_logits_tiled_int8`` compiled as they are
    inside its ``lax.map`` (the scales are compile-time constants)."""
    static = jq.act_scales

    @jax.jit
    def carry(P_e, L_e):
        a = jnp.dot(P_e.astype(compute_dtype), jq.w1_p.astype(compute_dtype),
                    preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        c = jnp.dot(L_e.astype(compute_dtype), jq.w1_l.astype(compute_dtype),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST) + jq.b1.astype(jnp.float32)
        h = jax.nn.relu(a[:, None, :] + c[None, l0:l0 + nl, :]).reshape(P_e.shape[0] * nl, -1)
        Wq, s_w, b = jq.hidden_q[0]
        if static is not None:
            h = h.astype(jnp.bfloat16).astype(jnp.float32)
            hq = jnp.clip(jnp.round(h / jnp.float32(static[0])), -127, 127).astype(jnp.int8)
            y = jax.lax.dot_general(hq, Wq, (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.int32).astype(jnp.float32)
            h_b = jax.nn.relu(y * (jnp.float32(static[0]) * s_w)[None, :] + b).astype(
                jnp.bfloat16).astype(jnp.float32)
            return jnp.clip(jnp.round(h_b / jnp.float32(static[1])), 0, 127).astype(jnp.int8)
        h = h.astype(jnp.bfloat16)
        stride = 8 if h.shape[1] >= 1024 else 1
        m = jnp.max(jnp.abs(h[:, ::stride].astype(jnp.float32)), axis=1,
                    keepdims=True) * (1.3 if stride > 1 else 1.0)
        s_act = jnp.maximum(m, 1e-12) / 127.0
        hq = jnp.clip(jnp.round(h.astype(jnp.float32) / s_act), -127, 127).astype(jnp.int8)
        y = jax.lax.dot_general(hq, Wq, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
        return jax.nn.relu(y.astype(jnp.float32) * (s_act * s_w[None, :]) + b).astype(jnp.bfloat16)

    return np.asarray(carry(jnp.asarray(P_e), jnp.asarray(L_e)).astype(jnp.float32))


def test_xla_divides_by_a_constant_as_a_reciprocal_multiply():
    """The premise of the port's ``_inv``: jitted, ``x / c`` with ``c`` a
    compile-time constant is ``x * float32(1 / c)``, which differs from the
    true quotient on some inputs; a division by an argument stays a true
    division."""
    x = np.random.default_rng(0).uniform(0, 10, size=100_000).astype(np.float32)
    c = 0.0123456
    inv = (1.0 / torch.tensor(c, dtype=torch.float32)).numpy()
    assert float(tps._inv(c, "cpu")) == float(inv)
    got = np.asarray(jax.jit(lambda v: v / jnp.float32(c))(x))
    np.testing.assert_array_equal(got, x * inv)
    assert (x * inv != x / np.float32(c)).any()
    by_arg = np.asarray(jax.jit(lambda v, s: v / s)(x, jnp.float32(c)))
    np.testing.assert_array_equal(by_arg, x / np.float32(c))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_folded_matches_jax(dtype):
    jf, tf = _folded(_weights(256), dtype)
    jq, tq = jps.quantize_folded(jf), tps.quantize_folded(tf)
    assert tq.act_scales is None and len(tq.hidden_q) == 2
    for (jW, js, jb), (tW, ts_, tb) in zip(jq.hidden_q, tq.hidden_q):
        assert tW.dtype == torch.int8 and ts_.dtype == torch.float32
        np.testing.assert_array_equal(tW.numpy(), np.asarray(jW))
        np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-7, atol=0)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    scaled = tps.quantize_folded(tf, act_scales=[0.5, np.float32(0.25)])
    assert scaled.act_scales == (0.5, 0.25)
    with pytest.raises(ValueError, match="act_scales"):
        tps.quantize_folded(tf, act_scales=(1.0,))
    prod = tps.FoldedOutputMLP(**{**tf.__dict__, "w1_prod": tf.w1_p})
    with pytest.raises(ValueError, match="concatenation_prod"):
        tps.quantize_folded(prod)


@pytest.mark.parametrize("H", [256, 1024])
def test_act_scale_maxes_match_jax(H):
    """The per-layer max |GEMM input| over at most 4 label tiles (here 3 of
    8 labels, the last ragged), and the scales made from them."""
    jf, tf = _folded(_weights(H, seed=2), "f32")
    P_e, L_e = _inputs(seed=3)
    rng = np.random.default_rng(4)
    P_e, L_e = P_e + rng.normal(size=P_e.shape).astype(np.float32) * 0.01, L_e  # off the grid
    want = np.asarray(jps.act_scale_maxes(jf, jnp.asarray(P_e), jnp.asarray(L_e), TILE))
    got = tps.act_scale_maxes(tf, torch.from_numpy(P_e), torch.from_numpy(L_e), TILE)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    want_s = jps.calibrate_act_scales(jf, jnp.asarray(P_e), jnp.asarray(L_e), TILE)
    got_s = tps.calibrate_act_scales(tf, torch.from_numpy(P_e), torch.from_numpy(L_e), TILE)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=0)
    # max_tiles: one tile only
    one = tps.act_scale_maxes(tf, torch.from_numpy(P_e), torch.from_numpy(L_e), TILE, max_tiles=1)
    want_one = np.asarray(jps.act_scale_maxes(jf, jnp.asarray(P_e), jnp.asarray(L_e), TILE,
                                              max_tiles=1))
    np.testing.assert_allclose(one.numpy(), want_one, rtol=1e-6, atol=0)


def _pair(mode, dtype, H, seed=0):
    jf, tf = _folded(_weights(H, seed=seed), dtype)
    P_e, L_e = _inputs(seed=seed + 1)
    scales = None
    if mode == "static":
        scales = jps.calibrate_act_scales(jf, jnp.asarray(P_e), jnp.asarray(L_e), TILE)
    return (jps.quantize_folded(jf, act_scales=scales),
            tps.quantize_folded(tf, act_scales=scales), P_e, L_e)


@pytest.mark.parametrize("H", [256, 1024])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_int8_logits_and_carry_match_jax(mode, dtype, H):
    """Logits of every label tile (the last ragged) and the carried layer-1
    rows of each tile; H 1024 takes the dynamic path's 1/8-column
    subsample with the 1.3 margin, H 256 every column."""
    jq, tq, P_e, L_e = _pair(mode, dtype, H)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(jps.pair_logits_tiled_int8(jq, jnp.asarray(P_e), jnp.asarray(L_e),
                                                 label_tile=TILE, compute_dtype=jdt))
    got = tps.pair_logits_tiled_int8(tq, torch.from_numpy(P_e), torch.from_numpy(L_e),
                                     label_tile=TILE, compute_dtype=tdt)
    assert got.shape == (B, L) and got.dtype == torch.float32
    assert want.std() > 0.05  # the logits spread: the comparison is not vacuous
    differ = total = 0
    for l0 in range(0, L, TILE):
        nl = min(TILE, L - l0)
        mine = tps.int8_carry_reference(tq, torch.from_numpy(P_e), torch.from_numpy(L_e),
                                        l0, nl, tdt).float().numpy()
        theirs = _jax_carry(jq, P_e, L_e, l0, nl, jdt)
        assert mine.shape == theirs.shape == (B * nl, H)
        differ += int((mine != theirs).sum())
        total += mine.size
    assert differ <= MAX_CODE_FRACTION * total, (differ, total)
    if differ == 0:
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    else:  # pragma: no cover - a code on a rounding edge moves its logits
        assert np.abs(got.numpy() - want).max() < 1e-2


@pytest.mark.parametrize("H", [256, 1024])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_int8_launch_plan_layout_matches_plain(mode, H):
    """K2 on K1's launch plan: 300 labels in chunks of 128 a sequence, the
    last (44 labels) padded to a whole 128-row tile, so it ends mid-tile.
    The plain chain over the padded layout gives the plain int8 logits (the
    w_out dot sums over other row counts: 1e-5), and the launch sequence the
    kernels run on a chunk (layer 1's code pass, or the row-scale pass that
    also writes the codes; the int32 GEMM; its code or bf16 epilogue), read
    back through ``chunk_rows`` as the wrapper does, carries exactly
    ``int8_carry_reference``'s rows."""
    _, tf = _folded(_weights(H, seed=11), "bf16")
    P_e, L_e = map(torch.from_numpy, _inputs(seed=12, n_labels=300))
    scales = tps.calibrate_act_scales(tf, P_e, L_e, 128) if mode == "static" else None
    tq = tps.quantize_folded(tf, act_scales=scales)
    plan = tps.launch_plan(B, 300, H, 2, target_rows=128 * B)
    assert [(ch.l0, ch.nl, ch.nl_pad) for ch in plan.chunks] == \
        [(0, 128, 128), (128, 128, 128), (256, 44, 128)]
    want = tps.pair_logits_tiled_int8_reference(tq, P_e, L_e, 128)
    got = tps.pair_logits_int8_plan_reference(tq, P_e, L_e, plan)
    assert float(want.std()) > 0.05
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_ATOL, rtol=0)

    a, c = tps._side_partials(tq, P_e, L_e, torch.bfloat16)
    Wq, s_w, b = tq.hidden_q[0]
    for ch in plan.chunks + tps.single_chunk_plan(B, H, 2, 100, 77).chunks:
        if mode == "static":
            hq = tps.int8_codes_reference(a, c, ch, scales[0])
            alpha = (tps._f32(scales[0], "cpu") * s_w)[None, :]
        else:
            s_act, hq = tps.int8_row_scale_reference(tps._chunk_inputs(a, c, ch).to(torch.bfloat16))
            alpha = s_act[:, None] * s_w[None, :]
        assert hq.dtype == torch.int8 and hq.shape == (B * ch.nl_pad, H)
        h = torch.relu(tps._int_product(hq, Wq).float() * alpha + b).to(torch.bfloat16)
        carry = tps._codes(h.float() * tps._inv(scales[1], "cpu"), 0) if scales else h
        mine = tps.chunk_rows(carry, B, ch)
        theirs = tps.int8_carry_reference(tq, P_e, L_e, ch.l0, ch.nl)
        assert mine.dtype == theirs.dtype and torch.equal(mine, theirs)


def test_static_codes_stay_in_range_and_chain_is_int8():
    """The carried codes of the static chain lie in 0..127 (the carry clip);
    the dynamic carry is bf16."""
    jq, tq, P_e, L_e = _pair("static", "bf16", 256)
    codes = tps.int8_carry_reference(tq, torch.from_numpy(P_e), torch.from_numpy(L_e), 0, TILE)
    assert codes.dtype == torch.int8 and int(codes.min()) >= 0 and int(codes.max()) <= 127
    assert int(codes.max()) > 64  # the scales use the range
    _, dq, _, _ = _pair("dynamic", "bf16", 256)
    carry = tps.int8_carry_reference(dq, torch.from_numpy(P_e), torch.from_numpy(L_e), 0, TILE)
    assert carry.dtype == torch.bfloat16


def test_int8_close_to_bf16_scorer():
    """Static int8 against the port's own bf16 tiled scorer (the JAX unit
    bound of tests/test_int8_static.py: probabilities within 1.5e-2,
    correlation above 0.999)."""
    _, tq, P_e, L_e = _pair("static", "f32", 256, seed=5)
    _, tf = _folded(_weights(256, seed=5), "f32")
    ref = tps.pair_logits_tiled(tf, torch.from_numpy(P_e), torch.from_numpy(L_e), TILE,
                                torch.float32).numpy()
    got = tps.pair_logits_tiled_int8(tq, torch.from_numpy(P_e), torch.from_numpy(L_e), TILE,
                                     torch.float32).numpy()
    p_ref, p_got = 1 / (1 + np.exp(-ref)), 1 / (1 + np.exp(-got))
    assert np.abs(p_ref - p_got).max() < 1.5e-2
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.999


def test_dynamic_outlier_clip_matches_jax():
    """The adversarial row of tests/test_int8_static.py (one outlier in a
    column the 1/8 subsample skips, so it clips at 127): the port's logits
    equal the JAX ones on the same one-layer int8 MLP."""
    H = 2048
    rng = np.random.default_rng(7)
    W = rng.normal(size=(H, 32)).astype(np.float32) * 0.05
    s_w = (np.maximum(np.abs(W).max(axis=0), 1e-12) / 127.0).astype(np.float32)
    Wq = np.clip(np.round(W / s_w[None, :]), -127, 127).astype(np.int8)
    X = np.abs(rng.normal(size=(8, H))).astype(np.float32)
    X[5] = 0.01
    X[5, 3] = 50.0
    eye = np.eye(H, dtype=np.float32)
    jq = jps.Int8FoldedOutputMLP(
        w1_p=jnp.asarray(eye, jnp.bfloat16), w1_l=jnp.zeros((H, H), jnp.bfloat16),
        b1=jnp.zeros(H, jnp.float32), hidden_q=[(jnp.asarray(Wq), jnp.asarray(s_w),
                                                  jnp.zeros(32, jnp.float32))],
        w_out=jnp.ones(32, jnp.float32) / 32.0, b_out=jnp.float32(0.0))
    tq = tps.Int8FoldedOutputMLP(
        w1_p=torch.from_numpy(eye).to(torch.bfloat16), w1_l=torch.zeros(H, H, dtype=torch.bfloat16),
        b1=torch.zeros(H), hidden_q=[(torch.from_numpy(Wq), torch.from_numpy(s_w), torch.zeros(32))],
        w_out=torch.ones(32) / 32.0, b_out=torch.tensor(0.0))
    want = np.asarray(jps.pair_logits_tiled_int8(jq, jnp.asarray(X), jnp.zeros((1, H)),
                                                 label_tile=1, compute_dtype=jnp.float32))
    got = tps.pair_logits_tiled_int8(tq, torch.from_numpy(X), torch.zeros(1, H), label_tile=1,
                                     compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    s_act = max(np.max(X[5, ::8]) * 1.3, 1e-12) / 127.0
    assert 50.0 > 127.0 * s_act  # the outlier is clipped: the test exercises the clip


def test_kernel_path_refuses_what_it_does_not_take():
    """The CUDA wrapper checks before it builds anything; the dispatcher has
    no path for other devices.  The kernel takes side products in bfloat16
    and in float32 (its float32 form: a float32 w_out); another dtype
    raises."""
    _, tq, P_e, L_e = _pair("static", "bf16", 256)
    P, Lt = torch.from_numpy(P_e), torch.from_numpy(L_e)
    tps.check_int8_kernel_inputs(tq, P, Lt, torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        tps.check_int8_kernel_inputs(tq, P, Lt, torch.float16)
    with pytest.raises(ValueError, match="hidden layer"):
        tps.check_int8_kernel_inputs(tps.Int8FoldedOutputMLP(**{**tq.__dict__, "hidden_q": []}),
                                     P, Lt, torch.bfloat16)
    _, odd, _, _ = _pair("static", "bf16", 192)
    with pytest.raises(ValueError, match="multiple of 128"):
        tps.check_int8_kernel_inputs(odd, P, Lt, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        tps.pair_logits_tiled_int8_cuda(tq, P, Lt, TILE, torch.bfloat16)
    with pytest.raises(ValueError, match="no int8 pair scorer"):
        tps.pair_logits_tiled_int8(tq, P.to("meta"), Lt.to("meta"))
