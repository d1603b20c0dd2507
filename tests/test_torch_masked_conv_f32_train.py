"""K7's float32 training kernels on the CPU: the order of work of
``masked_conv_dx_f32`` and ``masked_conv_dw_f32``
(protnote_tpu_torch/csrc/masked_conv_f32.cu), of K7-BN's ``_f32`` entry
points (csrc/masked_bn.cu) and of ``masked_mean_pool_backward_f32``
(csrc/masked_pool.cu), emulated in float32 against JAX's float32 vjp of
``_masked_conv``, of ``batchnorm_apply(train=True)`` + ReLU under the
encoder's count rule and of the masked mean pool; and the card dispatch of
a float32 conv and BatchNorm that want a gradient, through their autograd
branches (the CUDA wrappers replaced by their plain versions; the routing
of a float32 card tensor to those branches is
tests/test_torch_masked_conv.py::test_cuda_call_in_float32_raises).

The emulations follow the kernels, whose products take the bf16x3 split
(each 64-deep stage's six products from zero, added into float32 sums:
``test_torch_masked_conv_plan.split_stage``):
* dX is the forward's kernel with the taps reversed over the dX pieces
  (``conv_weight_layout_f32(w, dx=True)``): each tile of the dX plan at 128
  x 112 runs the taps its rows need, 64 channels of C_out a stage; rows
  outside [0, length) read as 0 and written as 0;
* dW splits dy once into its three bf16 pieces, then runs each item of
  ``dw_step_plan`` at the float32 kernel's 128 x 128 tile and 64 positions
  a step, A = (mask x)^T split, a stage a step added into float32 sums in
  order; the splits' partials are added in split order; dbias adds each
  sequence's rows in four interleaved sums, then the sequences in order;
* K7-BN's float32 forms are the bf16 kernels' arithmetic without the bf16
  roundings (its gate is v > 0), which
  ``tests/test_torch_masked_bn_plan.py`` emulates: its emulators run here
  at the small widths;
* the pool's transpose is g / max(length, 1) on the valid rows and that
  value times 0 past them.

Inputs are drawn with numpy from fixed seeds: T 64, C 24-40, dilations 1, 3
and 9 with 9 taps and a 1 x 1 conv, lengths 0, 1, 16, 17, 33 and 64 (the
dW steps' edges at 64 positions), and a wide-range case (activations and
cotangents offset by 300: every third piece carries bits).  Tolerances:
float32 within 1e-5 of each tensor's largest |value| of JAX's float32
result and of float64 (only the order of the sums differs); the pool's
transpose bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_masked_bn_plan as bnp
from protnote_tpu.models import layers as jlayers
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu_torch.ops import masked_conv as k7
from protnote_tpu_torch.ops.pair_scorer import split_bf16x3
from test_torch_masked_conv_plan import _emulate_f32_kernel, split_stage

T = 64
LENGTHS = np.array([64, 33, 17, 16, 1, 0], np.int32)
B = len(LENGTHS)
F32_REL = 1e-5
F32_SLOTS = 132  # an H100's persistent float32 dW blocks: one an SM
CONVS = [(9, 40, 24, 1), (9, 24, 40, 3), (9, 40, 24, 9), (1, 24, 40, 1)]  # taps, cin, cout, d
WIDE = 300.0  # the wide-range case's offset of x and dy


def _close(got, want, rel=F32_REL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=name)


def _conv_inputs(seed, taps, cin, cout, offset=0.0):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(cin * taps)
    p = {"kernel": rng.uniform(-bound, bound, (taps, cin, cout)).astype(np.float32),
         "bias": rng.uniform(-0.3, 0.3, cout).astype(np.float32)}
    x = (rng.normal(size=(B, T, cin)) + offset).astype(np.float32)
    g = (rng.normal(size=(B, T, cout)) + offset).astype(np.float32)
    return p, x, g


def _jax_conv_vjp(p, x, g, dilation):
    """JAX's float32 vjp of ``_masked_conv``: (dx, dkernel, dbias)."""
    mask = jpi.length_mask(jnp.asarray(LENGTHS), T)
    _, vjp = jax.vjp(lambda p_, x_: jpi._masked_conv(p_, x_, mask, dilation),
                     {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    return np.asarray(dx), np.asarray(dp["kernel"]), np.asarray(dp["bias"])


def _float64_conv_vjp(p, x, g, dilation):
    """The same vjp in float64, from the plain conv's autograd."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    return [v.numpy() for v in k7.masked_conv_backward_reference(
        t(x), t(p["kernel"]), t(p["bias"]), t(g), torch.from_numpy(LENGTHS), dilation)]


def _emulate_dx(g, w, dilation):
    """``masked_conv_dx_f32``: the float32 forward kernel's order of work
    (``_emulate_f32_kernel`` with ``dx``: the dX plan's tiles at 128 x 112
    over the dX pieces, a stage a tap's 64 channels of C_out, the masks on
    both sides, no bias).  Returns dX and how often each element was
    written."""
    taps, cin, cout = w.shape
    lay = k7.conv_weight_layout_f32(torch.from_numpy(w), dx=True)
    assert lay.shape == (3, taps, -(-cin // 112) * 112, -(-cout // 64) * 64)
    dx, written = _emulate_f32_kernel(g, w, None, LENGTHS, dilation, dx=True)
    return dx.astype(np.float32), written


def _emulate_dw(x, g, taps, dilation, sms):
    """``masked_conv_dw_f32``: dy split once into its three bf16 pieces;
    each item of the float32 dW plan (128 x 128 tiles, 64-position steps)
    summed over its steps in order, a step one stage of the split
    (:func:`split_stage`: A = (mask x)^T, the positions past the step's
    count zero, against dy's pieces) added into float32 sums; the splits'
    partials added in split order; dbias from four interleaved sums a
    sequence, the sequences added in order."""
    _, _, cin = x.shape
    cout = g.shape[2]
    bm = bn = k7.F32_DW_BLOCK
    step = k7.F32_DW_STEP
    plan, splits, n_items = k7.dw_step_plan(LENGTHS, T, taps, dilation, cin, cout, sms, bm, bn,
                                            step)
    items = plan[:n_items]
    offsets = plan[n_items:n_items + taps * splits + 1]
    steps = plan[n_items + taps * splits + 1:].reshape(-1, 2)
    mtiles, ntiles = -(-cin // bm), -(-cout // bn)
    xp = torch.zeros(B, T + step, mtiles * bm)  # rows past T read as zeros (TMA)
    xp[:, :T, :cin] = torch.from_numpy(x)
    gp = [torch.zeros(B, T + step, ntiles * bn, dtype=torch.bfloat16) for _ in range(3)]
    for pad, piece in zip(gp, split_bf16x3(torch.from_numpy(g))):
        pad[:, :T, :cout] = piece
    partial = np.full((splits, taps, mtiles * bm, ntiles * bn), np.nan, np.float32)
    for code in items:
        nt, u = code % ntiles, code // ntiles
        mt, v = u % mtiles, u // mtiles
        j, sp = v // splits, v % splits
        s = dilation * (j - (taps - 1) // 2)
        cols_m, cols_n = slice(mt * bm, (mt + 1) * bm), slice(nt * bn, (nt + 1) * bn)
        acc = torch.zeros(bm, bn)
        for b, w in steps[offsets[v]:offsets[v + 1]]:
            t0, rows = int(w) & 0xFFFF, int(w) >> 16
            assert 1 <= rows <= step and 0 <= t0 + s and t0 + s + rows <= T
            a = xp[b, t0 + s:t0 + s + step, cols_m].clone()
            a[rows:] = 0.0  # the select on the positions past the step's count
            acc += split_stage(a.t(), [piece[b, t0:t0 + step, cols_n] for piece in gp])
        tile = partial[sp, j, cols_m, cols_n]
        assert np.isnan(tile).all()  # each item writes its own tile once
        tile[...] = acc.numpy()
    dw = partial[0]
    for sp in range(1, splits):
        dw = dw + partial[sp]
    dbias = np.zeros(cout, np.float32)
    for b, L in enumerate(np.clip(LENGTHS, 0, T)):
        part = [g[b, e:L:4].sum(0, dtype=np.float32) if e < L else np.zeros(cout, np.float32)
                for e in range(4)]  # numpy's pairwise sum stands for the kernel's running one
        dbias = dbias + ((part[0] + part[1]) + (part[2] + part[3]))
    return dw[:, :cin, :cout], dbias, splits


@pytest.mark.parametrize("wide", [False, True], ids=["unit", "offset"])
@pytest.mark.parametrize("taps,cin,cout,dilation", CONVS)
def test_dx_kernel_algorithm_matches_jax_vjp(taps, cin, cout, dilation, wide):
    """dX's order of work (the forward's mainloop with the taps reversed
    over the dX pieces, the bf16x3 split) against JAX's float32 vjp of
    ``_masked_conv`` w.r.t. x and against float64, every element written
    once, zero past each sequence's length; also with dy offset by 300."""
    p, x, g = _conv_inputs(dilation * 10 + taps + cin, taps, cin, cout, WIDE if wide else 0.0)
    dx, written = _emulate_dx(g, p["kernel"], dilation)
    assert (written == 1).all()
    want, _, _ = _jax_conv_vjp(p, x, g, dilation)
    _close(dx, want, name="dx")
    _close(dx, _float64_conv_vjp(p, x, g, dilation)[0], name="dx f64")
    assert not dx[np.arange(T)[None, :] >= LENGTHS[:, None]].any()


@pytest.mark.parametrize("sms,wide", [(F32_SLOTS, False), (1, False), (F32_SLOTS, True)],
                         ids=["slots", "one", "offset"])
@pytest.mark.parametrize("taps,cin,cout,dilation", CONVS)
def test_dw_kernel_algorithm_matches_jax_vjp(taps, cin, cout, dilation, sms, wide):
    """dW and dbias in the kernel's K-step and split order (an H100's 132
    persistent blocks: many splits, some empty; and 1: one) against JAX's
    float32 vjp w.r.t. the kernel and the bias and against float64; also
    with x and dy offset by 300 (every third piece carries bits)."""
    p, x, g = _conv_inputs(dilation * 10 + taps + cin, taps, cin, cout, WIDE if wide else 0.0)
    dw, dbias, splits = _emulate_dw(x, g, taps, dilation, sms)
    assert splits == k7.dw_splits(taps, cin, cout, sms, 128, 128)
    assert (splits > 1) == (sms > 1)
    _, want_w, want_b = _jax_conv_vjp(p, x, g, dilation)
    _, f64_w, f64_b = _float64_conv_vjp(p, x, g, dilation)
    _close(dw, want_w, name="dW")
    _close(dw, f64_w, name="dW f64")
    _close(dbias, want_b, name="dbias")
    _close(dbias, f64_b, name="dbias f64")


def test_dw_f32_split_counts_of_a_full_width_step():
    """The float32 dW kernel's splits at the default widths on an H100 (one
    persistent block an SM, 128 x 128 tiles): conv1 81 tiles -> 1 split,
    the dilated convs 405 -> 1, the 1 x 1 convs 45 -> 2; a full-width
    plan's items are its splits times its tiles, its steps 64 positions of
    one sequence."""
    shapes = [(9, 20, 1100), (9, 1100, 550), (1, 550, 1100)]
    assert [k7.dw_tiles(*sh, 128, 128) for sh in shapes] == [81, 405, 45]
    assert [k7.dw_splits(*sh, F32_SLOTS, 128, 128) for sh in shapes] == [1, 1, 2]
    lens = np.full(32, 512, np.int32)
    lens[-1] = 30
    for taps, cin, cout in shapes:
        plan, splits, n_items = k7.dw_step_plan(lens, 512, taps, 3, cin, cout, F32_SLOTS,
                                                128, 128, k7.F32_DW_STEP)
        assert n_items == splits * k7.dw_tiles(taps, cin, cout, 128, 128)
        rows = plan[n_items + taps * splits + 1:].reshape(-1, 2)[:, 1] >> 16
        assert rows.max() == k7.F32_DW_STEP == 64 and rows.min() >= 1


def test_dx_layout_is_the_forward_layout_of_the_reversed_transposed_kernel():
    """The dX pieces (3, taps, C_in up to 112, C_out up to 64) sum to W[taps
    - 1 - j] (N = C_in, K-major: the forward's layout of the reversed,
    transposed kernel), zero-padded; the forward's pieces sum to W[j]^T."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(9, 40, 24)).astype(np.float32))
    lay = k7.conv_weight_layout_f32(w, dx=True)
    assert tuple(lay.shape) == (3, 9, 112, 64) and lay.is_contiguous()
    total = (lay[0].float() + lay[1].float()) + lay[2].float()
    for j in range(9):
        assert torch.equal(total[j, :40, :24], w[8 - j])
    assert not total[:, 40:].any() and not total[:, :, 24:].any()
    fwd = k7.conv_weight_layout_f32(w)
    assert torch.equal(fwd, k7.conv_weight_layout_f32(w, dx=False))
    assert torch.equal((fwd[0].float() + fwd[1].float()) + fwd[2].float(),
                       torch.nn.functional.pad(w.transpose(1, 2), (0, 24, 0, 88)))


@pytest.mark.parametrize("C", [24, 40])
@pytest.mark.parametrize("em", [None, bnp.EM], ids=["no_mask", "example_mask"])
def test_bn_f32_statistics_and_backward_match_jax_vjp(C, em):
    """K7-BN in float32 (the statistics in runs of the valid rows, moments
    about each run's first row, the ordered combine; y = relu(x inv + shift)
    unrounded; the closed-form backward with the gate x inv + shift > 0)
    against JAX's float32 ``batchnorm_apply(train=True)`` + ReLU and its
    vjp, with and without the example mask."""
    rng = np.random.default_rng(C + (0 if em is None else 1))
    p, s, x, g = bnp._inputs(rng, C, 0.4)
    jp, js = (jax.tree_util.tree_map(jnp.asarray, t) for t in (p, s))

    def f(x_, p_):
        y, new = bnp._jax_bn_relu(p_, js, x_, em)
        return jnp.sum(y * jnp.asarray(g)), (y, new)

    (_, (want_y, want_new)), (dx_w, dp_w) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp)
    fwd = bnp._emulate_forward(x, p, s, em)
    dx, dscale, dbias = bnp._emulate_backward(x, g, p, fwd, em)
    _close(fwd[0], want_y, name="y")
    _close(fwd[1], want_new["mean"], name="running mean")
    _close(fwd[2], want_new["var"], name="running var")
    _close(dx, dx_w, name="dx")
    _close(dscale, dp_w["scale"], name="dscale")
    _close(dbias, dp_w["bias"], name="dbias")
    # the plain version (the card's yardstick) agrees too
    lengths = torch.from_numpy(bnp.LENGTHS)
    xg = torch.from_numpy(x).requires_grad_(True)
    pg = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y0, new0 = k7.masked_bn_relu_reference(
        xg, pg, {k: torch.from_numpy(v) for k, v in s.items()}, lengths,
        None if em is None else torch.from_numpy(em), bnp.EPS, bnp.MOMENTUM)
    dx0, ds0, db0 = torch.autograd.grad(y0, [xg, pg["scale"], pg["bias"]], torch.from_numpy(g))
    # the backward kernel's plain version, on the (emulated) kernel's statistics
    _, _, _, mean, rstd, inv, shift, n = fwd
    stats = torch.from_numpy(np.stack([mean, rstd ** -2.0 - bnp.EPS, rstd, inv, shift]))
    dx1, ds1, db1 = k7.masked_bn_relu_backward_reference(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(p["scale"]), stats,
        torch.tensor([n, 0.0]), lengths, None if em is None else torch.from_numpy(em))
    for got, want, name in ((y0.detach(), want_y, "plain y"), (new0["var"], want_new["var"],
                                                              "plain var"),
                            (dx0, dx_w, "plain dx"), (ds0, dp_w["scale"], "plain dscale"),
                            (db0, dp_w["bias"], "plain dbias"), (dx1, dx_w, "stats plain dx"),
                            (ds1, dp_w["scale"], "stats plain dscale"),
                            (db1, dp_w["bias"], "stats plain dbias")):
        _close(got.numpy(), want, name=name)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("C", [24, 40])
def test_pool_transpose_f32_is_the_jax_vjp(C):
    """The float32 pool transpose (g / max(length, 1) on the valid rows,
    that value times 0 past them) bit for bit against JAX's vjp of the pool
    and the plain version, signed zeros included."""
    rng = np.random.default_rng(C)
    g = rng.normal(size=(B, C)).astype(np.float32)

    def pool(feats):
        feats = feats * jpi.length_mask(jnp.asarray(LENGTHS), T).astype(feats.dtype)
        denom = jnp.maximum(jnp.asarray(LENGTHS)[:, None].astype(jnp.float32), 1.0)
        return jnp.sum(feats.astype(jnp.float32), axis=1) / denom

    _, vjp = jax.vjp(pool, jnp.zeros((B, T, C), jnp.float32))
    (want,) = vjp(jnp.asarray(g))
    v = g / np.maximum(LENGTHS, 1).astype(np.float32)[:, None]
    valid = np.arange(T)[None, :, None] < LENGTHS[:, None, None]
    emulated = np.where(valid, v[:, None, :], v[:, None, :] * np.float32(0))
    plain = k7.masked_mean_pool_backward_reference(torch.from_numpy(g),
                                                   torch.from_numpy(LENGTHS), T, torch.float32)
    assert plain.dtype == torch.float32
    np.testing.assert_array_equal(_bits(emulated), _bits(want))
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(want))
    assert (_bits(want) == 0x80000000).any()  # the signed zeros are there to compare


# ----------------------------------------------------------------------
# the card dispatch


def _plain_wrappers(monkeypatch, calls):
    """The float32 CUDA wrappers replaced by their plain versions, each
    call recorded."""
    def record(name, fn):
        def run(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return run

    def conv_f32(x, kernel, bias, lengths, dilation, bn=None, residual=None, layout=None):
        return k7.masked_conv_reference(x, kernel, bias, lengths, dilation, bn, residual)

    def dx_f32(dy, kernel, lengths, dilation, layout=None):
        x = torch.zeros(*dy.shape[:2], kernel.shape[1])
        return k7.masked_conv_backward_reference(x, kernel, torch.zeros(kernel.shape[2]), dy,
                                                 lengths, dilation)[0]

    def dw_f32(x, dy, lengths, taps, dilation):
        kernel = torch.zeros(taps, x.shape[2], dy.shape[2])
        return k7.masked_conv_backward_reference(x, kernel, torch.zeros(dy.shape[2]), dy,
                                                 lengths, dilation)[1:]

    # the plain BatchNorm's backward recomputes the batch statistics from x:
    # the forward hands it the bias in place of the kernel's statistics
    def bn_fwd(x, scale, bias, run_mean, run_var, lengths, em, eps, momentum):
        y, new = k7.masked_bn_relu_reference(x, {"scale": scale, "bias": bias},
                                             {"mean": run_mean, "var": run_var}, lengths, em,
                                             eps, momentum)
        return y, new["mean"], new["var"], bias.detach()[None], None

    def bn_bwd(x, dy, scale, stats, counts, lengths, em):
        ones = torch.ones_like(scale)
        with torch.enable_grad():
            xg, sg, bg = (t.detach().requires_grad_(True) for t in (x, scale, stats[0]))
            y, _ = k7.masked_bn_relu_reference(xg, {"scale": sg, "bias": bg},
                                               {"mean": ones, "var": ones}, lengths, em,
                                               jpi.BN_EPS, 0.0)
            return torch.autograd.grad(y, [xg, sg, bg], dy)

    for name, fn in (("masked_conv_f32_cuda", conv_f32), ("masked_conv_dx_f32_cuda", dx_f32),
                     ("masked_conv_dw_f32_cuda", dw_f32),
                     ("masked_bn_relu_forward_cuda", bn_fwd),
                     ("masked_bn_relu_backward_cuda", bn_bwd)):
        monkeypatch.setattr(k7, name, record(name, fn))
    monkeypatch.setattr(k7, "_bn_activation", lambda name, t, shape, device, dtype=None: t)


def test_float32_autograd_branches_match_jax_through_plain_wrappers(monkeypatch):
    """A float32 residual block's pieces through the autograd branches --
    ``_MaskedBNRelu`` (float32 BatchNorm) and ``_MaskedConv`` (the float32
    forward, dX and dW wrappers; the second conv with a residual), then the
    pool -- with the CUDA wrappers replaced by their plain versions: the
    loss's gradients w.r.t. the input, both convs' weights and the
    BatchNorm's affine within 1e-5 of JAX's float32 gradients of the same
    block, and each float32 wrapper called."""
    calls = []
    _plain_wrappers(monkeypatch, calls)
    rng = np.random.default_rng(5)
    p1, x, _ = _conv_inputs(11, 9, 40, 24)
    p2, _, _ = _conv_inputs(12, 1, 24, 40)
    bn_p, bn_s, _, _ = bnp._inputs(rng, 40, 0.4)
    bn_p = {k: v[:40] for k, v in bn_p.items()}
    bn_s = {k: v[:40] for k, v in bn_s.items()}
    x = x * (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    cot = rng.normal(size=(B, 40)).astype(np.float32)
    lengths = torch.from_numpy(LENGTHS)
    em = np.ones(B, np.float32)
    em[2] = 0.0

    def port():
        t = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in (("x", x), ("k1", p1["kernel"]), ("b1", p1["bias"]),
                          ("k2", p2["kernel"]), ("b2", p2["bias"]), ("scale", bn_p["scale"]),
                          ("bias", bn_p["bias"]))}
        args = (lengths, torch.from_numpy(em), jpi.BN_EPS, jpi.BN_MOMENTUM)
        y, _, _ = k7._MaskedBNRelu.apply(t["x"], t["scale"], t["bias"],
                                         torch.from_numpy(bn_s["mean"]),
                                         torch.from_numpy(bn_s["var"]), *args)
        h = k7._MaskedConv.apply(y, t["k1"], t["b1"], None, lengths, 3)
        out = k7._MaskedConv.apply(h, t["k2"], t["b2"], t["x"], lengths, 1)
        pooled = k7._MaskedPool.apply(out, lengths)
        grads = torch.autograd.grad((pooled * torch.from_numpy(cot)).sum(), list(t.values()))
        return dict(zip(t, (g.numpy() for g in grads)))

    def jax_loss(v):
        lens = jnp.asarray(LENGTHS)
        mask = jpi.length_mask(lens, T)
        e = jnp.asarray(em)
        count = jnp.maximum(jnp.sum(e) * jnp.max(lens.astype(jnp.float32) * e), 1.0)
        y, _ = jlayers.batchnorm_apply({"scale": v["scale"], "bias": v["bias"]},
                                   {k: jnp.asarray(a) for k, a in bn_s.items()}, v["x"], True,
                                   eps=jpi.BN_EPS, momentum=jpi.BN_MOMENTUM, reduce_axes=(0, 1),
                                   mask=mask * e[:, None, None], count=count)
        h = jpi._masked_conv({"kernel": v["k1"], "bias": v["b1"]}, jax.nn.relu(y), mask, 3)
        out = v["x"] + jpi._masked_conv({"kernel": v["k2"], "bias": v["b2"]}, h, mask, 1)
        out = out * mask
        pooled = jnp.sum(out, axis=1) / jnp.maximum(lens[:, None].astype(jnp.float32), 1.0)
        return jnp.sum(pooled * jnp.asarray(cot))

    got = port()
    want = jax.grad(jax_loss)({"x": jnp.asarray(x), "k1": jnp.asarray(p1["kernel"]),
                               "b1": jnp.asarray(p1["bias"]), "k2": jnp.asarray(p2["kernel"]),
                               "b2": jnp.asarray(p2["bias"]), "scale": jnp.asarray(bn_p["scale"]),
                               "bias": jnp.asarray(bn_p["bias"])})
    for k in got:
        _close(got[k], np.asarray(want[k]), name=k)
    assert sorted(set(calls)) == sorted(
        ["masked_conv_f32_cuda", "masked_conv_dx_f32_cuda", "masked_conv_dw_f32_cuda",
         "masked_bn_relu_forward_cuda", "masked_bn_relu_backward_cuda"])
    assert calls.count("masked_conv_dw_f32_cuda") == 2
    assert calls.count("masked_conv_dx_f32_cuda") == 2  # both convs' inputs want a gradient
