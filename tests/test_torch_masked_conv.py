"""K7's plain versions (protnote_tpu_torch/ops/masked_conv.py) against the
JAX encoder's ``_masked_conv``, one residual block and the train-mode masked
BatchNorm, and numpy emulations of the CUDA kernels' order of work (tile and
tap ranges, sequence splits, the BatchNorm backward's closed form) against
JAX's autodiff.

Inputs are drawn with numpy from fixed seeds: T 40 with dilations 1, 3, 9
and 27 and kernel size 9, so that taps reach past both ends of a sequence
(at dilation 27 every tap but the centre lies outside for the rows of
length 7), a row of length 0, and lengths that end inside a tile.

Tolerances:
* float32: 1e-5 of the largest |value| of each tensor (forward, dX, dW,
  dbias, BatchNorm outputs, running statistics and gradients): only the
  summation order differs from XLA's.
* bfloat16 forward: 5e-3 absolute on outputs of order 0.1-1, as
  tests/test_torch_proteinfer.py (both round the conv output, the bias add,
  the BN output and the residual at the same points, but may sum the conv in
  other orders).
* bfloat16 backward: 2^-6 of each gradient's largest |value| (a gradient
  rounded to bf16 from a float32 sum in another order lands a bf16 step,
  2^-8 relative, away).  JAX's own bf16 ``_masked_conv`` cannot be
  differentiated (its conv's transpose mixes a float32 cotangent with a
  bf16 operand and raises TypeError, see
  ``test_jax_bf16_masked_conv_has_no_vjp``), so the port's bf16 gradients
  are held to JAX's float32 vjp on the same bf16 values, each gradient then
  rounded to bf16: where the transposed convs would round with the
  cotangent cast to bf16.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import layers as jlayers
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu_torch.models.layers import bn_affine
from protnote_tpu_torch.ops import masked_conv as k7

B, T, CIN, COUT, TAPS = 4, 40, 24, 16, 9
LENGTHS = np.array([40, 23, 7, 0], np.int32)
DILATIONS = [1, 3, 9, 27]
F32_REL = 1e-5
BF16_ATOL = 5e-3
BF16_GRAD_REL = 2.0 ** -6
EPS, MOMENTUM = jpi.BN_EPS, jpi.BN_MOMENTUM


def _conv_params(rng, cin=CIN, cout=COUT, taps=TAPS):
    bound = 1.0 / np.sqrt(cin * taps)
    return {"kernel": rng.uniform(-bound, bound, (taps, cin, cout)).astype(np.float32),
            "bias": rng.uniform(-0.3, 0.3, cout).astype(np.float32)}


def _x(rng, c=CIN):
    return rng.normal(0, 1, (B, T, c)).astype(np.float32)


def _jax_conv(p, x, dilation, dtype=jnp.float32):
    mask = jpi.length_mask(jnp.asarray(LENGTHS), T)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return jpi._masked_conv(jp, jnp.asarray(x).astype(dtype), mask, dilation)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=name)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dilation", DILATIONS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masked_conv_matches_jax(dilation, dtype):
    rng = np.random.default_rng(dilation)
    p, x = _conv_params(rng), _x(rng)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(_jax_conv(p, x, dilation, jdt).astype(jnp.float32))
    got = k7.masked_conv_reference(_t(x, tdt), _t(p["kernel"]), _t(p["bias"]),
                                   torch.from_numpy(LENGTHS), dilation)
    assert got.dtype == tdt and got.shape == (B, T, COUT)
    got = got.float().numpy()
    assert np.all(got[3] == 0) and np.all(got[2, 7:] == 0)  # masked rows are 0
    if dtype == "f32":
        _close(got, want, F32_REL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def _jax_block(bp, bs, feats, dilation, dtype=jnp.float32):
    """One residual block of the JAX ``proteinfer_embed`` in eval mode."""
    mask = jpi.length_mask(jnp.asarray(LENGTHS), T)
    jp = jax.tree_util.tree_map(jnp.asarray, bp)
    js = jax.tree_util.tree_map(jnp.asarray, bs)
    feats = jnp.asarray(feats).astype(dtype)
    out, _ = jlayers.batchnorm_apply(jp["bn1"], js["bn1"], feats, False, eps=EPS)
    out = jpi._masked_conv(jp["conv_dilated"], jax.nn.relu(out), mask, dilation)
    out, _ = jlayers.batchnorm_apply(jp["bn2"], js["bn2"], out, False, eps=EPS)
    out = jpi._masked_conv(jp["conv_1x1"], jax.nn.relu(out), mask, 1)
    return feats + out


def _block_weights(rng, c=CIN, cb=COUT):
    def bn(n):
        return ({"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                 "bias": rng.normal(0, 0.3, n).astype(np.float32)},
                {"mean": rng.normal(0, 0.2, n).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, n).astype(np.float32)})

    (bn1, s1), (bn2, s2) = bn(c), bn(cb)
    bp = {"bn1": bn1, "conv_dilated": _conv_params(rng, c, cb), "bn2": bn2,
          "conv_1x1": _conv_params(rng, cb, c, taps=1)}
    return bp, {"bn1": s1, "bn2": s2}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_with_bn_prologue_and_residual_matches_jax(dtype):
    """The eval-mode block as K7 fuses it: BN + ReLU in front of each conv's
    input mask (a padded position reads 0, not relu(shift)), the residual
    after the last conv's output mask."""
    rng = np.random.default_rng(5)
    bp, bs = _block_weights(rng)
    feats = _x(rng) * jpi.length_mask(jnp.asarray(LENGTHS), T)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(_jax_block(bp, bs, feats, 9, jdt).astype(jnp.float32))
    tb = jax.tree_util.tree_map(_t, bp)
    ts = jax.tree_util.tree_map(_t, bs)
    x, lengths = _t(feats, tdt), torch.from_numpy(LENGTHS)
    out = k7.masked_conv_reference(x, tb["conv_dilated"]["kernel"], tb["conv_dilated"]["bias"],
                                   lengths, 9, bn=bn_affine(tb["bn1"], ts["bn1"], EPS))
    got = k7.masked_conv_reference(out, tb["conv_1x1"]["kernel"], tb["conv_1x1"]["bias"],
                                   lengths, 1, bn=bn_affine(tb["bn2"], ts["bn2"], EPS),
                                   residual=x).float().numpy()
    assert float(bn_affine(tb["bn1"], ts["bn1"], EPS)[1].abs().max()) > 0.1
    if dtype == "f32":
        _close(got, want, F32_REL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def _torch_conv_grads(p, x, g, dilation, dtype):
    xt = _t(x, dtype).requires_grad_(True)
    w = _t(p["kernel"]).requires_grad_(True)
    b = _t(p["bias"]).requires_grad_(True)
    y = k7.masked_conv_reference(xt, w, b, torch.from_numpy(LENGTHS), dilation)
    y.backward(_t(g, dtype))
    return [t.grad.float().numpy() for t in (xt, w, b)]


@pytest.mark.parametrize("dilation", DILATIONS)
def test_plain_backward_matches_jax_vjp_f32(dilation):
    rng = np.random.default_rng(10 + dilation)
    p, x, g = _conv_params(rng), _x(rng), _x(rng, COUT)
    _, vjp = jax.vjp(lambda x, w, b: _jax_conv({"kernel": w, "bias": b}, x, dilation),
                     jnp.asarray(x), jnp.asarray(p["kernel"]), jnp.asarray(p["bias"]))
    for got, want, name in zip(_torch_conv_grads(p, x, g, dilation, torch.float32),
                               vjp(jnp.asarray(g)), ("dx", "dw", "db")):
        _close(got, want, F32_REL, name)


def test_jax_bf16_masked_conv_has_no_vjp():
    """The premise of the bf16 gradient tests: JAX cannot differentiate its
    own bf16 ``_masked_conv`` (preferred_element_type float32 makes the
    cotangent float32 and the transposed conv refuses mixed dtypes)."""
    rng = np.random.default_rng(0)
    p, x = _conv_params(rng), _x(rng)
    _, vjp = jax.vjp(lambda x: _jax_conv(p, x, 3, jnp.bfloat16), jnp.asarray(x))
    with pytest.raises(TypeError, match="same dtypes"):
        vjp(jnp.ones((B, T, COUT), jnp.bfloat16))


@pytest.mark.parametrize("dilation", DILATIONS)
def test_plain_backward_bf16_rounds_like_the_transposed_convs(dilation):
    rng = np.random.default_rng(20 + dilation)
    p, x, g = _conv_params(rng), _bf16(_x(rng)), _bf16(_x(rng, COUT))
    w16 = _bf16(p["kernel"])
    _, vjp = jax.vjp(lambda x, w, b: _jax_conv({"kernel": w, "bias": b}, x, dilation),
                     jnp.asarray(x), jnp.asarray(w16), jnp.asarray(_bf16(p["bias"])))
    got = _torch_conv_grads(p, x, g, dilation, torch.bfloat16)
    for got_g, want, name in zip(got, vjp(jnp.asarray(g)), ("dx", "dw", "db")):
        _close(got_g, _bf16(want), BF16_GRAD_REL, name)
        assert np.array_equal(got_g, _bf16(got_g))  # each gradient is a bf16 value


# ----------------------------------------------------------------------
# the kernels' order of work, emulated in numpy


def _tap_range(L, t0, taps, dilation, dx):
    """The kernel's tap rule (``conv_tile``): the taps whose shifted rows
    meet [0, L) for the tile's rows [t0, t0 + 128), none (jhi < jlo) for a
    tile past the length."""
    half, step = (taps - 1) // 2, (-dilation if dx else dilation)
    js = [j for j in range(taps) if t0 < L and t0 + step * (j - half) < L
          and t0 + k7.BLOCK_M + step * (j - half) > 0]
    return (js[0], js[-1]) if js else (taps, -1)


def _emulate_conv_rows(x, w, lengths, dilation, dx=False):
    """``conv_tma_kernel``'s loops in float64: the tiles of
    ``conv_tile_plan`` (128 rows of one sequence x 184 columns, the most
    taps first), each over the taps of the kernel's rule (the rest skipped)
    and K in 64-channel steps of the input, zero-padded to the weight
    layout's depth (the TMA box's zero fill), against the re-laid,
    zero-padded weights of ``conv_weight_layout``; rows read outside
    [0, length) are zero, the output mask last; rows of the tiles not in the
    plan stay 0 (the kernel's tail).  ``dx``: the transposed conv (shifts
    negated, the dX layout).  Each output element is written by one tile."""
    bm, bk = k7.BLOCK_M, k7.BLOCK_K
    Bn, Tn, kc = x.shape
    taps = w.shape[0]
    half, step = (taps - 1) // 2, (-dilation if dx else dilation)
    layout = k7.conv_weight_layout(torch.from_numpy(w), dx).double().numpy()
    n_out, k_pad = (w.shape[1] if dx else w.shape[2]), layout.shape[2]
    xp = np.zeros((Bn, Tn, k_pad))
    xp[..., :kc] = x
    y = np.zeros((Bn, Tn, layout.shape[1]))
    written = np.zeros(y.shape, np.int64)
    mtiles, ntiles = -(-Tn // bm), layout.shape[1] // k7.BLOCK_N
    for code in k7.conv_tile_plan(lengths, Tn, taps, dilation, n_out, dx):
        u, nt = divmod(int(code), ntiles)
        b, mt = divmod(u, mtiles)
        t0, cols = mt * bm, slice(nt * k7.BLOCK_N, (nt + 1) * k7.BLOCK_N)
        L = min(max(int(lengths[b]), 0), Tn)
        jlo, jhi = _tap_range(L, t0, taps, dilation, dx)
        rows = np.arange(t0, min(t0 + bm, Tn))
        for j in range(jlo, jhi + 1):
            src = rows + step * (j - half)
            ok = (src >= 0) & (src < L)
            for c0 in range(0, k_pad, bk):
                a = np.where(ok[:, None], xp[b, np.clip(src, 0, Tn - 1), c0:c0 + bk], 0.0)
                y[b, rows, cols] += a @ layout[j, cols, c0:c0 + bk].T
        y[b, rows[rows >= L], cols] = 0.0
        written[b, rows, cols] += 1
    assert written.max() <= 1
    return y[..., :n_out]


def _emulate_dw(x, g, lengths, taps, dilation, sms):
    """``conv_dw_kernel``'s loops in float64 over the plan of
    ``k7.dw_step_plan`` (``sms`` sets its split count): each tap's K steps,
    64 positions of one sequence whose rows past the step's valid count are
    zero, summed into the float32 partial of their split, then the splits'
    partials added in order; dbias from each sequence's column sums over
    its valid rows, added in sequence order."""
    Bn, Tn, cin = x.shape
    half = (taps - 1) // 2
    plan, splits, n_items = k7.dw_step_plan(lengths, Tn, taps, dilation, cin, g.shape[2], sms)
    offsets = plan[n_items:n_items + taps * splits + 1]
    steps = plan[n_items + taps * splits + 1:].reshape(-1, 2)
    partial = np.zeros((splits, taps, cin, g.shape[2]))
    for j in range(taps):
        s = dilation * (j - half)
        for sp in range(splits):
            for b, w in steps[offsets[j * splits + sp]:offsets[j * splits + sp + 1]]:
                t0, rows = int(w) & 0xFFFF, int(w) >> 16
                t = np.arange(t0, t0 + k7.DW_STEP)
                ok = (t - t0 < rows)[:, None]
                xs = np.where(ok, x[b, np.clip(t + s, 0, Tn - 1)], 0.0)
                gs = np.where(ok, g[b, np.clip(t, 0, Tn - 1)], 0.0)
                partial[sp, j] += xs.T @ gs
    db = sum(g[b, :min(max(int(lengths[b]), 0), Tn)].sum(0) for b in range(Bn))
    return partial.sum(0), db, splits


@pytest.mark.parametrize("dilation", DILATIONS)
def test_kernel_algorithm_matches_jax(dilation):
    """Forward, dX and dW (one, two and three splits of each tap's K steps)
    through the kernels' tile, tap and step ranges against JAX in float32."""
    rng = np.random.default_rng(30 + dilation)
    p, x, g = _conv_params(rng), _x(rng), _x(rng, COUT)
    want_y, vjp = jax.vjp(lambda x, w, b: _jax_conv({"kernel": w, "bias": b}, x, dilation),
                          jnp.asarray(x), jnp.asarray(p["kernel"]), jnp.asarray(p["bias"]))
    dx_w, dw_w, db_w = vjp(jnp.asarray(g))
    mask = np.arange(T)[None, :, None] < LENGTHS[:, None, None]
    y = _emulate_conv_rows(x, p["kernel"], LENGTHS, dilation) + p["bias"] * mask
    _close(y, want_y, F32_REL, "y")
    _close(_emulate_conv_rows(g, p["kernel"], LENGTHS, dilation, dx=True), dx_w, F32_REL, "dx")
    for sms, splits in ((9, 1), (18, 2), (27, 3)):  # 9 tiles: one a tap
        dw, db, got_splits = _emulate_dw(x, g, LENGTHS, TAPS, dilation, sms)
        assert got_splits == splits
        _close(dw, dw_w, F32_REL, "dw")
        _close(db, db_w, F32_REL, "db")


def test_launch_plans_cover_the_work():
    # dW: the most splits that keep the items within one wave, at least one
    assert k7.dw_splits(9, 1100, 550) == 1  # 243 tiles
    assert k7.dw_splits(1, 550, 1100) == 4  # 30 tiles
    assert k7.dw_splits(1, 16, 16) == 132
    for rows in (1, 255, 256, 16384, 32768, 1 << 20):
        chunks, per = k7.bn_chunks(rows)
        assert chunks * per >= rows > (chunks - 1) * per and per >= 256


# ----------------------------------------------------------------------
# train-mode masked BatchNorm (K7-BN)


def _bn_params(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.normal(0, 0.3, c).astype(np.float32)},
            {"mean": rng.normal(0, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)})


def _jax_bn_relu(p, s, x, em):
    """JAX ``proteinfer_embed``'s train-mode BN + ReLU with its count rule."""
    lengths = jnp.asarray(LENGTHS)
    mask = jpi.length_mask(lengths, T)
    lengths_f = lengths.astype(jnp.float32)
    if em is None:
        bn_mask, rows, t_ref = mask, jnp.float32(B), jnp.max(lengths_f)
    else:
        em = jnp.asarray(em)
        bn_mask, rows, t_ref = mask * em[:, None, None], jnp.sum(em), jnp.max(lengths_f * em)
    y, new = jlayers.batchnorm_apply(p, s, x, True, eps=EPS, momentum=MOMENTUM,
                                     reduce_axes=(0, 1), mask=bn_mask,
                                     count=jnp.maximum(rows * t_ref, 1.0))
    return jax.nn.relu(y), new


@pytest.mark.parametrize("em", [None, np.array([1, 1, 0, 1], np.float32),
                                np.array([0, 1, 1, 1], np.float32)])
def test_masked_bn_relu_train_matches_jax(em):
    """Output, new running statistics and the gradients of x, scale and bias
    (float32), with rows that the example mask drops: the first drops the
    length-7 row (the count falls to 3 rows), the second the longest (the
    count's max length falls to 23)."""
    rng = np.random.default_rng(40)
    p, s = _bn_params(rng, CIN)
    x = (_x(rng) * 0.7 + 0.4) * (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    g = _x(rng)
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(jnp.asarray, s)

    def f(x, p):
        y, new = _jax_bn_relu(p, js, x, em)
        return jnp.sum(y * jnp.asarray(g)), (y, new)

    (_, (want_y, want_new)), (dx_w, dp_w) = jax.value_and_grad(f, argnums=(0, 1),
                                                               has_aux=True)(jnp.asarray(x), jp)
    xt = _t(x).requires_grad_(True)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    y, new = k7.masked_bn_relu_train(xt, tp, {k: _t(v) for k, v in s.items()},
                                     torch.from_numpy(LENGTHS),
                                     None if em is None else torch.from_numpy(em), EPS, MOMENTUM)
    (y * _t(g)).sum().backward()
    _close(y.detach().numpy(), want_y, F32_REL, "y")
    for k in ("mean", "var"):
        _close(new[k].numpy(), want_new[k], F32_REL, k)
    _close(xt.grad.numpy(), dx_w, F32_REL, "dx")
    _close(tp["scale"].grad.numpy(), dp_w["scale"], F32_REL, "dscale")
    _close(tp["bias"].grad.numpy(), dp_w["bias"], F32_REL, "dbias")
    assert float((y > 0).float().mean()) > 0.3


@pytest.mark.parametrize("em", [None, np.array([1, 1, 0, 1], np.float32)])
def test_bn_backward_closed_form_matches_jax(em):
    """``masked_bn.cu``'s backward in float64 from the forward's statistics:
    gz = g where y > 0, G = sum gz, Gx = sum gz (x - mean) over every row,
    dscale = Gx rstd, dbias = G and
    dx = inv gz + m / n (-inv G - scale rstd^3 Gx (x - mean)),
    against JAX's autodiff, with nonzero cotangents on padded and dropped
    rows (they reach G and Gx, not the statistics)."""
    rng = np.random.default_rng(41)
    p, s = _bn_params(rng, CIN)
    x, g = _x(rng) * 0.8 + 0.3, _x(rng)
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(jnp.asarray, s)

    def f(x, p):
        y, _ = _jax_bn_relu(p, js, x, em)
        return jnp.sum(y * jnp.asarray(g)), y

    (_, y), (dx_w, dp_w) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jp)
    mask, count = k7.bn_mask_and_count(torch.from_numpy(LENGTHS),
                                       None if em is None else torch.from_numpy(em), T)
    m, n = mask.numpy().astype(np.float64), float(count)
    nv = max(m.sum(), 1.0)
    xf = x.astype(np.float64)
    mean = (xf * m).sum((0, 1)) / n
    var = (((xf - mean) ** 2 * m).sum((0, 1)) + (n - nv) * mean ** 2) / n
    rstd = 1.0 / np.sqrt(var + EPS)
    inv = rstd * p["scale"]
    gz = np.where(np.asarray(y) > 0, g, 0.0)
    G, Gx = gz.sum((0, 1)), (gz * (xf - mean)).sum((0, 1))
    dx = inv * gz + m / n * (-inv * G - p["scale"] * rstd ** 3 * Gx * (xf - mean))
    _close(dx, dx_w, F32_REL, "dx")
    _close(Gx * rstd, dp_w["scale"], F32_REL, "dscale")
    _close(G, dp_w["bias"], F32_REL, "dbias")


def test_masked_mean_pool_matches_jax():
    rng = np.random.default_rng(50)
    feats = _x(rng) * (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    denom = jnp.maximum(jnp.asarray(LENGTHS)[:, None].astype(jnp.float32), 1.0)
    want = jnp.sum(jnp.asarray(feats), axis=1) / denom
    got = k7.masked_mean_pool_reference(_t(feats), torch.from_numpy(LENGTHS)).numpy()
    _close(got, want, F32_REL)
    assert np.all(got[3] == 0)  # length 0: 0, not NaN


@pytest.mark.parametrize("call", ["conv", "bn", "pool"])
def test_cuda_call_in_float32_raises(call):
    """A CUDA tensor in another dtype than bfloat16 raises and names
    MIXED_PRECISION before anything runs; nothing falls back to cuDNN.  The
    tensor is a stub: only its device and dtype are read."""
    stub = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    rng = np.random.default_rng(0)
    lengths = torch.from_numpy(LENGTHS)
    p = {k: _t(v) for k, v in _conv_params(rng).items()}
    bp, bs = (jax.tree_util.tree_map(_t, t) for t in _bn_params(rng, CIN))
    with pytest.raises(ValueError, match="MIXED_PRECISION"):
        if call == "conv":
            k7.masked_conv(stub, p, lengths, 3)
        elif call == "bn":
            k7.masked_bn_relu_train(stub, bp, bs, lengths, None, EPS, MOMENTUM)
        else:
            k7.masked_mean_pool(stub, lengths)
