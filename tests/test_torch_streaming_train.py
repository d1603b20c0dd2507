"""The port's training scorers (protnote_tpu_torch/ops/streaming_train.py) and
train-mode BatchNorm (models/layers.py) against the JAX package on the CPU.

The same numpy inputs and JAX-initialised weights (random BatchNorm
parameters and running statistics, He-scaled linears) go through the JAX
function and the port's plain versions of K4, K5 and K6: the decomposed
scorer and the streamed one (``pair_logits_streaming_train``, 21 labels in
tiles of 8, so the last tile is ragged, with masked sequences and labels).

Tolerances:
* float32: 1e-5 absolute on logits, new running statistics and gradients
  (of size ~1e-2..1 here), the `TOL` of tests/test_reference_parity.py: the
  two sides sum in other orders, and the port's K5 backward is the JAX
  custom VJP's formula where JAX's unfused setting differentiates the
  composition (the same function).
* bfloat16, decomposed: logits to 3e-2 absolute (both sides round a2, c2,
  x1 and every pre-activation to bf16 at the same points, but a sum in
  another order can land one bf16 step (2^-8 relative) away and move what
  follows).
* bfloat16, streamed: against the JAX function under ``jax.disable_jit``.
  Compiled, XLA on the CPU fuses the scan body and drops the bf16 roundings
  between fused operations (its gradients then lie 5-40% of their largest
  |value| from eager JAX's on these tiny widths); eager, JAX rounds where
  the port does, except that the port adds the per-tile gradients of a2
  and c2 in float32 and JAX's scan adds them in bf16.  Logits to 1e-3
  absolute, new running statistics to 1e-5, every gradient within 2^-6 of
  its largest |value| (a sum in another order lands one bf16 step away and
  moves what follows).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import layers as jlayers
from protnote_tpu.models.fusion import ProtNoteConfig as JaxConfig
from protnote_tpu.models.fusion import init_protnote as jax_init
from protnote_tpu.ops import streaming_train as jst
from protnote_tpu_torch.models import layers as tlayers
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import streaming_train as tst

TOL = 1e-5
B, L, D, H_SCALE = 5, 21, 12, 2


def _weights(fusion="concatenation", seed=0):
    """Output-MLP (params, state) as numpy, with random BN parameters and
    running statistics and He-scaled kernels."""
    cfg = JaxConfig(protein_embedding_dim=20, label_embedding_dim=20, latent_dim=D,
                    projection_head_num_layers=2, output_mlp_num_layers=3,
                    output_mlp_hidden_dim_scale_factor=H_SCALE, feature_fusion=fusion)
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


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    P_e = rng.normal(size=(B, D)).astype(np.float32)
    L_e = rng.normal(size=(L, D)).astype(np.float32)
    em = np.array([1, 1, 1, 1, 0], np.float32)
    lm = (np.arange(L) < 18).astype(np.float32)
    return P_e, L_e, em, lm


def _loss_weights(seed=2):
    return np.random.default_rng(seed).normal(size=(B, L)).astype(np.float32)


def _jax_run(p, s, P_e, L_e, em, lm, fusion, fused, dtype=jnp.float32, remat=False):
    w = jnp.asarray(_loss_weights()) * jnp.asarray(em)[:, None] * jnp.asarray(lm)[None, :]

    def f(p_, P_, L_):
        lg, new = jst.pair_logits_dense_decomposed(
            p_, jax.tree_util.tree_map(jnp.asarray, s), P_, L_, fusion,
            example_mask=jnp.asarray(em), label_mask=jnp.asarray(lm), compute_dtype=dtype,
            remat=remat, fused_bn_vjp=fused)
        return jnp.sum(jax.nn.sigmoid(lg) * w), (lg, new)

    (_, (lg, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(P_e), jnp.asarray(L_e))
    return jax.tree_util.tree_map(np.asarray, (lg, new, grads))


def _port_run(p, s, P_e, L_e, em, lm, fusion, dtype=torch.float32, remat=False):
    t = from_jax_tree({"p": p, "s": s})
    leaves = []

    def track(x):
        x = x.clone().requires_grad_(True)
        leaves.append(x)
        return x

    tp = jax.tree_util.tree_map(track, t["p"])
    Pg, Lg = track(torch.from_numpy(P_e)), track(torch.from_numpy(L_e))
    lg, new = tst.pair_logits_dense_decomposed(
        tp, t["s"], Pg, Lg, fusion, example_mask=torch.from_numpy(em),
        label_mask=torch.from_numpy(lm), compute_dtype=dtype, remat=remat)
    w = torch.from_numpy(_loss_weights()) * torch.from_numpy(em)[:, None] * \
        torch.from_numpy(lm)[None, :]
    (torch.sigmoid(lg) * w).sum().backward()
    grads = (jax.tree_util.tree_map(lambda x: x.grad.numpy(), tp), Pg.grad.numpy(),
             Lg.grad.numpy())
    return lg.detach().float().numpy(), jax.tree_util.tree_map(
        lambda x: x.numpy(), new), grads


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("fusion", ["concatenation", "concatenation_diff"])
def test_decomposed_matches_jax(fusion, fused):
    """Logits, new BN running statistics, and the gradients of P_e, L_e and
    every output-MLP parameter, float32."""
    p, s = _weights(fusion)
    P_e, L_e, em, lm = _inputs()
    want_lg, want_new, want_g = _jax_run(p, s, P_e, L_e, em, lm, fusion, fused)
    got_lg, got_new, got_g = _port_run(p, s, P_e, L_e, em, lm, fusion)
    assert got_lg.shape == (B, L) and float(np.std(want_lg)) > 0.5
    np.testing.assert_allclose(got_lg, want_lg, atol=TOL, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(got_new), jax.tree_util.tree_leaves(want_new)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    got_leaves = jax.tree_util.tree_leaves(got_g)
    want_leaves = jax.tree_util.tree_leaves(want_g)
    assert len(got_leaves) == len(want_leaves) == 13
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_decomposed_bf16_matches_jax():
    p, s = _weights()
    P_e, L_e, em, lm = _inputs()
    want_lg, _, _ = _jax_run(p, s, P_e, L_e, em, lm, "concatenation", False, jnp.bfloat16)
    got_lg, _, _ = _port_run(p, s, P_e, L_e, em, lm, "concatenation", torch.bfloat16)
    valid = (em[:, None] * lm[None, :]) > 0
    np.testing.assert_allclose(got_lg[valid], want_lg[valid], atol=3e-2, rtol=0)


@pytest.mark.parametrize("fusion", ["concatenation", "concatenation_diff"])
def test_remat_matches_jax(fusion):
    """GRADIENT_CHECKPOINTING: the port's ``remat=True`` (torch.utils.checkpoint
    around the post-layer-1 block) against the JAX ``remat=True``
    (``jax.checkpoint(post)``): logits, new running statistics and every
    gradient, float32."""
    p, s = _weights(fusion)
    P_e, L_e, em, lm = _inputs()
    want_lg, want_new, want_g = _jax_run(p, s, P_e, L_e, em, lm, fusion, False, remat=True)
    got_lg, got_new, got_g = _port_run(p, s, P_e, L_e, em, lm, fusion, remat=True)
    np.testing.assert_allclose(got_lg, want_lg, atol=TOL, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(got_new), jax.tree_util.tree_leaves(want_new)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    got_leaves, want_leaves = (jax.tree_util.tree_leaves(g) for g in (got_g, want_g))
    assert len(got_leaves) == len(want_leaves) == 13
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_remat_bf16_matches_jax():
    p, s = _weights()
    P_e, L_e, em, lm = _inputs()
    want_lg, _, _ = _jax_run(p, s, P_e, L_e, em, lm, "concatenation", False, jnp.bfloat16,
                             remat=True)
    got_lg, _, _ = _port_run(p, s, P_e, L_e, em, lm, "concatenation", torch.bfloat16,
                             remat=True)
    valid = (em[:, None] * lm[None, :]) > 0
    np.testing.assert_allclose(got_lg[valid], want_lg[valid], atol=3e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_equals_no_remat_on_cpu(dtype):
    """The recomputation runs the same plain functions on the same inputs:
    logits, running statistics and gradients come out bit for bit equal;
    the running statistics are the first forward's."""
    p, s = _weights()
    P_e, L_e, em, lm = _inputs()
    runs = [_port_run(p, s, P_e, L_e, em, lm, "concatenation", dtype, remat=r)
            for r in (False, True)]
    for a, b in zip(jax.tree_util.tree_leaves(runs[0]), jax.tree_util.tree_leaves(runs[1])):
        np.testing.assert_array_equal(a, b)


def test_bn_relu_function_matches_jax():
    """K5's plain Function against the JAX ``_bn_relu`` custom VJP: the
    outputs, and dz, dscale, dbias for one cotangent."""
    rng = np.random.default_rng(3)
    N, H = 64, 8
    z = (rng.normal(size=(N, H)) + 1.5).astype(np.float32)
    rows = (rng.random((N, 1)) < 0.8).astype(np.float32)
    n = np.float32(rows.sum())
    scale = rng.uniform(0.5, 1.5, H).astype(np.float32)
    bias = rng.normal(0, 0.3, H).astype(np.float32)
    running = rng.normal(1.0, 0.3, H).astype(np.float32)
    dy = rng.normal(size=(N, H)).astype(np.float32)
    (y, mean, var), vjp = jax.vjp(
        lambda z_, s_, b_: jst._bn_relu(z_, jnp.asarray(rows), n, s_, b_, jnp.asarray(running)),
        jnp.asarray(z), jnp.asarray(scale), jnp.asarray(bias))
    dz, dscale, dbias = vjp((jnp.asarray(dy), jnp.zeros(H), jnp.zeros(H)))
    zt, st_, bt = (torch.from_numpy(x).requires_grad_(True) for x in (z, scale, bias))
    ty, tmean, tvar = tst.bn_relu(zt, torch.from_numpy(rows), torch.tensor(n), st_, bt,
                                  torch.from_numpy(running))
    ty.backward(torch.from_numpy(dy))
    for got, want in ((ty, y), (tmean, mean), (tvar, var), (zt.grad, dz),
                      (st_.grad, dscale), (bt.grad, dbias)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert float((ty > 0).float().mean()) > 0.3


def test_pair_hidden_backward_matches_autograd():
    """K4's hand-written (plain) backward against autograd of the same
    composition, float32."""
    rng = np.random.default_rng(4)
    a2, c2, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((4, 16), (9, 16), (16, 24)))
    dz = torch.from_numpy(rng.normal(size=(36, 24)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (a2, c2, w)]
    tst.pair_hidden(*leaves).backward(dz)
    ref = [t.clone().requires_grad_(True) for t in (a2, c2, w)]
    (torch.relu(ref[0][:, None, :] + ref[1][None, :, :]).reshape(36, 16) @ ref[2]).backward(dz)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=TOL, rtol=0)


def test_shifted_moments_large_mean():
    """The case of tests/test_streaming_train.py::test_shifted_moments_large_mean:
    the shifted single-pass variance stays accurate at |mean| >> std, and
    the port matches the JAX function."""
    rng = np.random.default_rng(0)
    z = (2000.0 + 0.1 * rng.normal(size=(4096, 4))).astype(np.float32)
    rows = np.ones((4096, 1), np.float32)
    running = np.full((4,), 2000.0 * 1.001, np.float32)
    want_m, want_v = jst._shifted_moments(jnp.asarray(z), jnp.asarray(rows), 4096.0,
                                          jnp.asarray(running))
    mean, var = tst._shifted_moments(torch.from_numpy(z), torch.from_numpy(rows),
                                     torch.tensor(4096.0), torch.from_numpy(running))
    # the truth in float64 (a float32 sum down axis 0 accumulates in order:
    # numpy's and JAX's means are 2.2e-6 off here, the port's 1e-8)
    z64 = z.astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), z64.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), z64.var(axis=0), rtol=1e-2)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_m), rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_v), rtol=2e-2)
    # the naive formulation loses everything at this scale
    naive = float(np.mean(z[:, 0] ** 2) - np.mean(z[:, 0]) ** 2)
    assert not np.isclose(naive, 0.1 ** 2, rtol=0.5)


@pytest.mark.parametrize("case", ["plain", "mask", "mask_count", "rank3_mask_count"])
def test_batchnorm_train_matches_jax(case):
    """Train-mode BatchNorm: output and new running statistics, with a row
    mask and the reference's padded-width ``count``."""
    rng = np.random.default_rng(5)
    shape, axes = ((6, 5, 7), (0, 1)) if case.startswith("rank3") else ((9, 7), (0,))
    x = rng.normal(1.0, 2.0, size=shape).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32),
         "bias": rng.normal(size=7).astype(np.float32)}
    s = {"mean": rng.normal(size=7).astype(np.float32),
         "var": rng.uniform(0.5, 2, 7).astype(np.float32)}
    mask = count = None
    if case != "plain":
        mask = (rng.random(shape[:-1] + (1,)) < 0.7).astype(np.float32)
        if case.startswith("rank3"):
            mask = (np.arange(5)[None, :, None] < rng.integers(1, 6, (6, 1, 1))).astype(
                np.float32)
    if case.endswith("count"):
        count = np.float32(np.prod(shape[:-1]) + 3)
    jy, js = jlayers.batchnorm_apply(
        jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(jnp.asarray, s),
        jnp.asarray(x), True, reduce_axes=axes,
        mask=None if mask is None else jnp.asarray(mask),
        count=None if count is None else jnp.asarray(count))
    t = from_jax_tree({"p": p, "s": s})
    ty, ts = tlayers.batchnorm_train(
        t["p"], t["s"], torch.from_numpy(x), reduce_axes=axes,
        mask=None if mask is None else torch.from_numpy(mask),
        count=None if count is None else torch.tensor(count))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=TOL, rtol=0)


def test_dropout_keeps_scale_and_rate():
    """Dropout cannot match JAX's bits: its rate and its 1/keep scaling."""
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = tlayers.dropout(x, 0.25, gen, train=True)
    kept = y > 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert tlayers.dropout(x, 0.25, gen, train=False) is x


# ----------------------------------------------------------------------
# the streamed scorer (K6's plain versions around K4's)

TILE = 8  # 21 labels: tiles of 8, 8 and 5 real labels + 3 padded


def _depth(p, s, depth):
    """The output MLP cut to ``depth`` hidden layers."""
    return (dict(p, layers=p["layers"][:depth], bns=p["bns"][:depth]),
            dict(s, bns=s["bns"][:depth]))


def _jax_stream(p, s, P_e, L_e, em, lm, fusion, cache, dtype=jnp.float32):
    w = jnp.asarray(_loss_weights()) * jnp.asarray(em)[:, None] * jnp.asarray(lm)[None, :]

    def f(p_, P_, L_):
        lg, new = jst.pair_logits_streaming_train(
            p_, jax.tree_util.tree_map(jnp.asarray, s), P_, L_, fusion,
            example_mask=jnp.asarray(em), label_mask=jnp.asarray(lm), label_tile=TILE,
            compute_dtype=dtype, cache_first=cache)
        return jnp.sum(jax.nn.sigmoid(lg) * w), (lg, new)

    (_, (lg, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(P_e), jnp.asarray(L_e))
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), (lg, new, grads))


def _port_stream(p, s, P_e, L_e, em, lm, fusion, cache, dtype=torch.float32):
    t = from_jax_tree({"p": p, "s": s})
    tp = jax.tree_util.tree_map(lambda x: x.clone().requires_grad_(True), t["p"])
    Pg = torch.from_numpy(P_e).requires_grad_(True)
    Lg = torch.from_numpy(L_e).requires_grad_(True)
    lg, new = tst.pair_logits_streaming_train(
        tp, t["s"], Pg, Lg, fusion, example_mask=torch.from_numpy(em),
        label_mask=torch.from_numpy(lm), label_tile=TILE, compute_dtype=dtype,
        cache_first=cache)
    w = torch.from_numpy(_loss_weights()) * torch.from_numpy(em)[:, None] * \
        torch.from_numpy(lm)[None, :]
    (torch.sigmoid(lg) * w).sum().backward()
    grads = (jax.tree_util.tree_map(lambda x: x.grad.float().numpy(), tp),
             Pg.grad.float().numpy(), Lg.grad.float().numpy())
    return lg.detach().float().numpy(), jax.tree_util.tree_map(
        lambda x: x.float().numpy(), new), grads


def _assert_runs_close(got, want, depth, atol):
    """Logits, every new running statistic and every gradient leaf (P_e,
    L_e, and the output MLP's: two BN parameters a hidden layer, its kernel,
    the output kernel and bias)."""
    assert got[0].shape == (B, L) and float(np.std(want[0])) > 0.5
    new = list(zip(jax.tree_util.tree_leaves(got[1]), jax.tree_util.tree_leaves(want[1])))
    grads = list(zip(jax.tree_util.tree_leaves(got[2]), jax.tree_util.tree_leaves(want[2])))
    assert len(new) == 2 * depth and len(grads) == 3 * depth + 4
    for a, b in [(got[0], want[0])] + new + grads:
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("fusion,depth,cache", [
    ("concatenation", depth, cache) for depth in (1, 2, 3) for cache in (False, True, None)
] + [("concatenation_diff", 3, False), ("concatenation_diff", 3, True)])
def test_streaming_matches_jax(fusion, depth, cache):
    """``pair_logits_streaming_train`` against the JAX function in float32:
    logits, new running statistics and the gradients of P_e, L_e and every
    output-MLP leaf, with the z1 cache off, on and decided by the rule (on
    for these sizes; at depth 1 there is no hidden GEMM to cache), both
    fusions, a masked sequence and masked labels, and a ragged last tile."""
    p, s = _depth(*_weights(fusion), depth)
    P_e, L_e, em, lm = _inputs()
    _assert_runs_close(_port_stream(p, s, P_e, L_e, em, lm, fusion, cache),
                       _jax_stream(p, s, P_e, L_e, em, lm, fusion, cache), depth, TOL)


@pytest.mark.parametrize("cache", [False, True])
def test_streaming_bf16_matches_eager_jax(cache):
    """bfloat16 against the JAX function run eagerly (see the module
    docstring): logits 1e-3, running statistics 1e-5, gradients 2^-6 of
    each leaf's largest |value|."""
    p, s = _weights()
    P_e, L_e, em, lm = _inputs()
    got = _port_stream(p, s, P_e, L_e, em, lm, "concatenation", cache, torch.bfloat16)
    with jax.disable_jit():
        want = _jax_stream(p, s, P_e, L_e, em, lm, "concatenation", cache, jnp.bfloat16)
    valid = (em[:, None] * lm[None, :]) > 0
    np.testing.assert_allclose(got[0][valid], want[0][valid], atol=1e-3, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(got[1]), jax.tree_util.tree_leaves(want[1])):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    leaves = list(zip(jax.tree_util.tree_leaves(got[2]), jax.tree_util.tree_leaves(want[2])))
    assert len(leaves) == 13
    for a, b in leaves:
        assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_matches_decomposed(depth):
    """The port's streamed scorer against its decomposed one (the same
    function, the statistics summed tile by tile), float32, cache on: the
    same leaves at 1e-5."""
    p, s = _depth(*_weights(), depth)
    P_e, L_e, em, lm = _inputs()
    got = _port_stream(p, s, P_e, L_e, em, lm, "concatenation", True)
    want = _port_run(p, s, P_e, L_e, em, lm, "concatenation")
    _assert_runs_close(got, want, depth, TOL)


def _k6_case(name, dtype=torch.float32, seed=21):
    """Inputs of one K6 function: (plain function, its inputs, the indices
    of the differentiable ones).  Pre-activations ~N(1, 1) so that about a
    quarter of the gates are shut; padded rows have rows = 0."""
    rng = np.random.default_rng(seed)
    N, H = 40, 16
    z = torch.from_numpy((rng.normal(size=(N, H)) + 1.0).astype(np.float32)).to(dtype)
    vec = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, H).astype(np.float32))  # noqa: E731
    if name == "stream_moments":
        rows = torch.from_numpy((rng.random((N, 1)) < 0.8).astype(np.float32))
        return tst.stream_moments_reference, (z, rows, vec(0.5, 1.5)), (0,)
    if name == "affine_relu":
        return tst.affine_relu_reference, (z, vec(0.5, 1.5), vec(-1.2, 0.2)), (0, 1, 2)
    w = torch.from_numpy(rng.normal(size=H).astype(np.float32)).to(dtype)
    return (tst.stream_head_reference, (z, vec(0.5, 1.5), vec(-1.2, 0.2), w,
                                        torch.tensor(0.3)), (0, 1, 2, 3, 4))


def _plain_autograd(name, args):
    """The K6 function written out in plain differentiable torch."""
    if name == "stream_moments":
        z, rows, r = args
        zc = z.float() - r
        return (zc * rows).sum(0), (zc * rows * zc).sum(0)
    if name == "affine_relu":
        z, inv, shift = args
        return (torch.relu(z.float() * inv + shift).to(z.dtype),)
    z, inv, shift, w, b = args
    return (torch.relu(z.float() * inv + shift) @ w.float() + b,)


@pytest.mark.parametrize("name", ["stream_moments", "affine_relu", "stream_head"])
def test_k6_plain_backward_matches_autograd(name):
    """Each K6 function's hand-written (plain) backward against
    ``torch.autograd`` of its forward written out, float32, one cotangent on
    every output."""
    fn, args, diff = _k6_case(name)
    outs = {}
    for which, run in (("hand", fn), ("auto", lambda *a: _plain_autograd(name, a))):
        leaves = [a.clone().requires_grad_(i in diff) for i, a in enumerate(args)]
        out = run(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        cts = [torch.from_numpy(np.random.default_rng(22 + k).normal(size=o.shape).astype(
            np.float32)) for k, o in enumerate(out)]
        torch.autograd.backward(out, cts)
        outs[which] = [o.detach() for o in out] + [leaves[i].grad for i in diff]
    for a, b in zip(outs["hand"], outs["auto"]):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["stream_moments", "affine_relu", "stream_head"])
def test_k6_plain_bf16_matches_jax_vjp(name):
    """Each K6 plain version in bfloat16 against ``jax.vjp`` of the JAX
    expressions it replaces, at their cast points (``_shifted_moments``'
    sums; ``relu(f32(z) * inv + shift).astype(bf16)``; the head's
    ``jnp.dot(h, w_bf16, preferred_element_type=f32) + b_out``, whose
    transpose rounds dh and dw to bf16): outputs and gradients within 1e-5
    absolute or one bf16 step (2^-8) of the value."""
    fn, args, diff = _k6_case(name, torch.bfloat16)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                              else jnp.float32)  # noqa: E731
    jargs = [j(a) for a in args]

    def jax_fn(*d):
        a = list(jargs)
        for i, x in zip(diff, d):
            a[i] = x
        if name == "stream_moments":
            zc = a[0].astype(jnp.float32) - a[2]
            zm = zc * a[1]
            return jnp.sum(zm, axis=0), jnp.sum(zm * zc, axis=0)
        h = jax.nn.relu(a[0].astype(jnp.float32) * a[1] + a[2]).astype(a[0].dtype)
        if name == "affine_relu":
            return (h,)
        return (jnp.dot(h, a[3], preferred_element_type=jnp.float32) + a[4],)

    with jax.disable_jit():
        want, vjp = jax.vjp(jax_fn, *[jargs[i] for i in diff])
    leaves = [a.clone().requires_grad_(i in diff) for i, a in enumerate(args)]
    got = fn(*leaves)
    got = got if isinstance(got, tuple) else (got,)
    cts = [np.random.default_rng(23 + k).normal(size=o.shape).astype(np.float32)
           for k, o in enumerate(got)]
    torch.autograd.backward(got, [torch.from_numpy(c).to(o.dtype) for c, o in zip(cts, got)])
    want_grads = vjp(tuple(jnp.asarray(c, w.dtype) for c, w in zip(cts, want)))
    pairs = list(zip(got, want)) + [(leaves[i].grad, g) for i, g in zip(diff, want_grads)]
    for a, b in pairs:
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=2.0 ** -8)


@pytest.mark.parametrize("depth,cache", [(d, c) for d in (1, 2, 3) for c in (False, True)])
def test_streamed_launches_follow_the_schedule(monkeypatch, depth, cache):
    """One forward and backward of the streamed scorer calls each kernel's
    plain version as often as ``streamed_launches`` says the kernels launch
    (the count that the card's run holds its launches to): the forward of
    every tile twice (the backward's recomputation), each backward once a
    forward call, K5 never.  At the default depth and tile (3 hidden layers,
    16 tiles) that is 16 H x H GEMM passes with the cache and 20 without."""
    counts = {k: 0 for k in tst.LAUNCHES}
    names = {"_pair_hidden_fwd_plain": ["pair_train_hidden"],
             "_pair_hidden_backward_plain": ["pair_train_dx", "pair_train_dw"],
             "_stream_moments_plain": ["stream_moments"],
             "_stream_moments_grad_plain": ["stream_moments_backward"],
             "_affine_relu_plain": ["affine_relu"],
             "_affine_relu_grads_plain": ["affine_relu_backward"],
             "_stream_head_plain": ["stream_head"],
             "_stream_head_grads_plain": ["stream_head_backward"],
             "_bn_relu_fwd_plain": ["bn_relu_forward"], "_bn_relu_grads": ["bn_relu_backward"]}

    def counted(fn, keys):
        def run(*args):
            for k in keys:
                counts[k] += 1
            return fn(*args)
        return run

    for attr, keys in names.items():
        monkeypatch.setattr(tst, attr, counted(getattr(tst, attr), keys))
    p, s = _depth(*_weights(), depth)
    P_e, L_e, em, lm = _inputs()
    _port_stream(p, s, P_e, L_e, em, lm, "concatenation", cache)
    assert counts == tst.streamed_launches(depth, -(-L // TILE), cache)
    full = {c: tst.streamed_launches(3, 16, c) for c in (False, True)}
    passes = {c: (n["pair_train_hidden"] + n["affine_relu"] + 2 * (
        n["pair_train_dx"] + n["affine_relu_backward"])) // 16 for c, n in full.items()}
    assert passes == {True: 16, False: 20}


def test_streaming_cache_rule():
    """``cache_first=None`` keeps z1 when ``2 * z1 + 4 tiles`` fit the budget:
    15.2 GB without a card (the JAX package's boundary on a 16 GB chip: 32
    sequences x 32,768 padded labels at H 3072 in bf16 fit with tiles of
    2,048 and not of 4,096), and never at depth 1."""
    cpu = torch.device("cpu")
    rule = tst.streaming_cache_first
    assert rule(32, 32768, 2048, 3072, 2, 3, cpu)
    assert not rule(32, 32768, 4096, 3072, 2, 3, cpu)
    assert not rule(128, 32768, 2048, 3072, 2, 3, cpu)
    assert not rule(32, 32768, 2048, 3072, 2, 1, cpu)
    z1 = 32 * 32768 * 3072 * 2
    assert 2 * z1 + 4 * 32 * 2048 * 3072 * 2 <= tst.CPU_CACHE_BUDGET < 2 * z1 + 4 * z1 // 8


def test_k6_cuda_wrappers_refuse_cpu_tensors():
    z, v = torch.zeros(4, 256, dtype=torch.bfloat16), torch.zeros(256)
    rows = torch.ones(4, 1)
    for call in (lambda: tst._stream_moments_cuda(z, rows, v),
                 lambda: tst._affine_relu_cuda(z, v, v),
                 lambda: tst._stream_head_cuda(z, v, v, z[0], torch.zeros(())),
                 lambda: tst._stream_head_grads_cuda(z, v, v, z[0], torch.zeros(4))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


def _forward_configs(**change):
    """A small JAX ``ProtNoteConfig`` and the port's with the same fields."""
    from protnote_tpu_torch.models.fusion import ProtNoteConfig

    fields = dict(protein_embedding_dim=20, label_embedding_dim=20, latent_dim=D,
                  projection_head_num_layers=2, output_mlp_num_layers=3,
                  output_mlp_hidden_dim_scale_factor=H_SCALE, train_label_tile=TILE, **change)
    return JaxConfig(**fields), ProtNoteConfig(**fields)


@pytest.mark.parametrize("backend", ["auto", "tiled", "tiled_int8"])
def test_protnote_forward_streams_like_jax(backend):
    """``protnote_forward(train=True)`` with ``train_label_tile``: every
    backend but dense trains through the streamed scorer, as the JAX
    dispatch does (``tiled`` raises without a tile); logits and new state
    against the JAX ``protnote_forward`` in float32."""
    from protnote_tpu.models.fusion import protnote_forward as jax_forward
    from protnote_tpu_torch.models.fusion import protnote_forward

    jcfg, tcfg = _forward_configs(pair_backend=backend)
    params, state = jax_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(24)
    seqs = rng.normal(size=(B, 20)).astype(np.float32)
    labels = rng.normal(size=(L, 20)).astype(np.float32)
    _, _, em, lm = _inputs()
    want = jax_forward(params, state, jnp.asarray(seqs), jnp.asarray(labels), jcfg, train=True,
                       example_mask=jnp.asarray(em), label_mask=jnp.asarray(lm))
    t = from_jax_tree({"p": jax.tree_util.tree_map(np.asarray, params),
                       "s": jax.tree_util.tree_map(np.asarray, state)})
    got = protnote_forward(t["p"], t["s"], torch.from_numpy(seqs), torch.from_numpy(labels), tcfg,
                           train=True, example_mask=torch.from_numpy(em),
                           label_mask=torch.from_numpy(lm))
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b) == 1 + 2 * (1 + 1 + 3)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=TOL, rtol=0)


@pytest.mark.parametrize("change,error,match", [
    ({"dropout": 0.1}, None, None),
    ({"train_fused_bn_vjp": True}, ValueError, "TRAIN_FUSED_BN_VJP"),
])
def test_streaming_dispatch_refusals(change, error, match, monkeypatch):
    """With a tile: dropout falls through to the materialised dense scorer
    on both sides, which then agree (logits and new state to 1e-5) on the
    same masks: the heads' dropout takes a position mask of its input's
    shape on both sides, the output MLP the port's counter-hash masks of a
    fixed seed; ``TRAIN_FUSED_BN_VJP`` raises JAX's ``ValueError`` on both
    sides."""
    from protnote_tpu.models import fusion as jfu
    from protnote_tpu.models.fusion import protnote_forward as jax_forward
    from protnote_tpu.ops import pair_scorer as jps
    from protnote_tpu_torch.models import fusion as tfu
    from protnote_tpu_torch.models.fusion import protnote_forward
    from protnote_tpu_torch.ops import dense_scorer as tds

    jcfg, tcfg = _forward_configs(**change)
    params, state = jax_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(25)
    seqs = rng.normal(size=(B, 20)).astype(np.float32)
    labels = rng.normal(size=(L, 20)).astype(np.float32)
    t = from_jax_tree({"p": jax.tree_util.tree_map(np.asarray, params),
                       "s": jax.tree_util.tree_map(np.asarray, state)})
    if error is not None:
        with pytest.raises(ValueError, match=match):
            jax_forward(params, state, jnp.asarray(seqs), jnp.asarray(labels), jcfg, train=True)
        with pytest.raises(error, match=match):
            protnote_forward(t["p"], t["s"], torch.from_numpy(seqs), torch.from_numpy(labels),
                             tcfg, train=True, generator=torch.Generator().manual_seed(0))
        return

    def position_mask(shape, r):
        idx = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
        return (idx * 2654435761 % 1000) >= int(r * 1000)

    seed = torch.tensor([3, 4], dtype=torch.int64)
    rows, cols = torch.arange(B * L)[:, None], torch.arange(D * H_SCALE)[None, :]
    masks = [tds.keep_mask(seed, i, 0.1, rows, cols).numpy() for i in range(2)]
    calls = []

    def mlp_dropout(x, r, key, train):
        calls.append(r)
        return jnp.where(masks[(len(calls) - 1) % 2], x / (1.0 - r), 0.0).astype(x.dtype)

    monkeypatch.setattr(jfu, "dropout_fn", lambda x, r, key, train: jnp.where(
        position_mask(x.shape, r), x / (1.0 - r), 0.0).astype(x.dtype))
    monkeypatch.setattr(tfu, "dropout_fn", lambda x, r, gen, train: torch.where(
        torch.from_numpy(position_mask(tuple(x.shape), r)), x / (1.0 - r), 0.0).to(x.dtype))
    monkeypatch.setattr(tfu, "draw_seed", lambda gen: seed)
    monkeypatch.setattr(jps, "dropout_fn", mlp_dropout)
    want = jax_forward(params, state, jnp.asarray(seqs), jnp.asarray(labels), jcfg, train=True,
                       rng=jax.random.PRNGKey(0))
    got = protnote_forward(t["p"], t["s"], torch.from_numpy(seqs), torch.from_numpy(labels),
                           tcfg, train=True, generator=torch.Generator().manual_seed(0))
    assert calls == [0.1, 0.1]
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b) == 1 + 2 * (1 + 1 + 3) and float(np.std(np.asarray(want[0]))) > 0.1
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.float().numpy(), np.asarray(y, np.float32), atol=TOL, rtol=0)


# ----------------------------------------------------------------------
# K4's launch plan (csrc/pair_train.cu runs its tiles; the card tests in
# tests/test_torch_kernels_cuda.py hold the kernel to the plain version)


def _stored(plan):
    """How often each z element (b, l, n) is written by the plan's stores."""
    count = np.zeros((plan.batch, plan.labels, plan.width_out), np.int32)
    for t in range(plan.tiles):
        for b, l0, l1, n0, n1 in plan.stores(t):
            count[b, l0:l1, n0:n1] += 1
    return count


@pytest.mark.parametrize("B,L,K,N", [(5, 301, 128, 256), (5, 301, 256, 384), (1, 64, 128, 128),
                                     (3, 128, 384, 512), (2, 1, 128, 128), (4, 200, 128, 640)])
def test_pair_train_plan_writes_every_element_once(B, L, K, N):
    """Every (b, l, n) of z is written by exactly one tile; a tile covers
    128 labels of one sequence, and its rows past L are clipped, not
    stored; the column tile is 256 where N allows it."""
    plan = tst.pair_train_plan(B, L, K, N, num_sms=7)
    assert plan.block_n == (256 if N % 256 == 0 else 128)
    assert plan.tiles == -(-L // 128) * B * (N // plan.block_n)
    assert plan.grid == min(7, plan.tiles)
    assert (_stored(plan) == 1).all()
    for t in range(plan.tiles):
        b, l0, n0 = plan.tile(t)
        assert l0 % 128 == 0 and l0 < L and n0 % plan.block_n == 0
        boxes = plan.stores(t)
        assert {box[0] for box in boxes} == {b}  # no tile crosses a sequence
        assert max(box[2] for box in boxes) == min(l0 + 128, L)  # clipped at L
    # why the store is 3-D: the last label tile of sequence b stored as rows
    # b * L + l of a 2-D (B * L, N) map would reach past row (b + 1) * L,
    # into sequence b + 1's first rows, wherever 128 does not divide L
    last_l0 = (plan.tiles_l - 1) * 128
    assert (last_l0 + 128 > L) == (L % 128 != 0)


def test_pair_train_plan_at_the_training_shape():
    """B 32 x L 32,102 at H 3072 (the training step's K4 launch): 251 label
    tiles a sequence, the last holding 102 labels; the tiles map one to one
    onto (label tile, sequence, column tile) with label tiles outermost, so
    the 132 blocks in flight share at most two c2 tiles; the clipped stores
    add up to z's 3.16e9 elements."""
    B, L, H = 32, 32102, 3072
    plan = tst.pair_train_plan(B, L, H, H, num_sms=132)
    assert (plan.block_n, plan.tiles_l, plan.tiles_n, plan.grid) == (256, 251, 12, 132)
    t = np.arange(plan.tiles)
    decoded = np.array([plan.tile(int(i)) for i in t])
    lt, b, nt = decoded[:, 1] // 128, decoded[:, 0], decoded[:, 2] // 256
    assert (np.diff(lt) >= 0).all() and (np.diff(lt * B + b) >= 0).all()  # label tile first
    key = (lt * B + b) * plan.tiles_n + nt
    assert (np.sort(key) == t).all()  # one to one
    wave = lt.reshape(-1)[: plan.tiles // plan.grid * plan.grid].reshape(-1, plan.grid)
    assert (wave.max(1) - wave.min(1) <= 1).all()
    last = plan.stores(plan.tiles - 1)
    assert {box[1:3] for box in last} == {(32000, 32064), (32064, 32102)}  # 102 labels
    elements = sum((l1 - l0) * (n1 - n0) for i in range(plan.tiles)
                   for _, l0, l1, n0, n1 in plan.stores(i))
    assert elements == B * L * H > 2**31


@pytest.mark.parametrize("K,N", [(64, 256), (128, 200), (192, 128), (0, 128)])
def test_pair_train_plan_refuses_widths(K, N):
    with pytest.raises(ValueError, match="multiples of 128"):
        tst.pair_train_plan(5, 301, K, N)


def test_pair_train_cuda_wrapper_refuses_cpu_tensors():
    a2, c2, w = torch.zeros(2, 128), torch.zeros(3, 128), torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA device"):
        tst._pair_hidden_fwd_cuda(a2, c2, w)


def test_pair_train_plan_layout_matches_jax():
    """z assembled tile by tile as the kernel does (c2 rows past L read as
    zeros, each tile's x1 = bf16(relu(a2[b] + c2)) times W with float32
    sums, rounded to bf16, then stored through the plan's clipped boxes)
    against the JAX path's layer-2 GEMM ``linear(relu(a2[b] + c2[l]))`` in
    bf16: within one bf16 step (2^-8 of the largest |value|: the sums run
    in other orders)."""
    rng = np.random.default_rng(12)
    B, L, K, N = 3, 301, 128, 384
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    a2, c2 = bf(rng.normal(size=(B, K))), bf(rng.normal(size=(L, K)))
    w = bf(rng.normal(size=(K, N)) * 0.2)
    plan = tst.pair_train_plan(B, L, K, N, num_sms=5)
    z = torch.full((B, L, N), float("nan"))
    c2_pad = torch.cat([c2.float(), torch.zeros(plan.tiles_l * 128 - L, K)])
    for t in range(plan.tiles):
        b, l0, n0 = plan.tile(t)
        x1 = torch.relu(a2[b].float() + c2_pad[l0:l0 + 128]).to(torch.bfloat16).float()
        tile = (x1 @ w.float()[:, n0:n0 + plan.block_n]).to(torch.bfloat16).float()
        for _, s0, s1, m0, m1 in plan.stores(t):
            z[b, s0:s1, m0:m1] = tile[s0 - l0:s1 - l0, m0 - n0:m1 - n0]
    j = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa: E731
    h = jax.nn.relu(j(a2)[:, None, :] + j(c2)[None, :, :]).reshape(B * L, K)
    want = np.asarray(jlayers.linear({"kernel": j(w)}, h).astype(jnp.float32)).reshape(B, L, N)
    got = z.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


# ----------------------------------------------------------------------
# K4-bwd's launch plans (csrc/pair_train_bwd.cu runs their walks; the card
# tests hold the kernels to the plain backward)

_BWD_SHAPES = [(5, 301, 128, 256), (1, 301, 256, 384), (3, 1, 128, 128), (2, 64, 128, 256),
               (4, 200, 384, 512), (1, 1, 128, 128), (2, 130, 256, 128), (2, 70, 128, 1536),
               (7, 301, 384, 256), (32, 40, 256, 128)]


def _bwd_inputs(B, L, K, N, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, K)), rng.normal(size=(L, K)), rng.normal(size=(K, N)),
            rng.normal(size=(B * L, N)))


def _dx_walk(plan, a2, c2, w, dz):
    """The dX kernel's walk in float64: every block takes its label tiles in
    order and, in each, its sequence pairs in order (warpgroup 0 on 2p,
    warpgroup 1 on 2p + 1, which past B is all zeros); dc2's sum over the
    pairs is stored once a unit (the group's partial when groups > 1), each
    tile's column sums are written (first label tile) or added into the
    block's row of the (ranges, B, K) scratch, and a second pass adds the
    ranges, and the groups, in order.  Returns (da2, dc2, counts): how often
    each dc2 partial element was stored, each dx1 element summed, each da2
    scratch element written and added."""
    B, L, K, N = plan.batch, plan.labels, plan.width_in, plan.width_out
    dz3 = dz.reshape(B, L, N)
    da2_part = np.full((plan.ranges, B, K), np.nan)
    dc2_part = np.full((plan.groups, L, K), np.nan)
    stored = np.zeros((plan.groups, L, K), int)
    summed = np.zeros((B, L, K), int)
    firsts, adds = np.zeros((plan.ranges, B, K), int), np.zeros((plan.ranges, B, K), int)
    for i in range(plan.grid):
        r, k0, (lt0, lt1), (p0, p1) = plan.block(i)
        g = i // (plan.tiles_k * plan.ranges)
        assert k0 % 256 == 0 and k0 < K and 0 <= lt0 < lt1 <= plan.tiles_l
        assert 0 <= p0 < p1 <= plan.pairs
        c = slice(k0, min(k0 + 256, K))
        for lt in range(lt0, lt1):
            rows = slice(lt * 64, min(lt * 64 + 64, L))
            dc = None
            for p in range(p0, p1):
                for b in (2 * p, 2 * p + 1):  # warpgroup 0, then 1: b order
                    if b >= B:
                        assert b == B and B % 2 == 1  # the zeros past B
                        continue
                    dx1 = np.where(a2[b, c] + c2[rows, c] > 0, dz3[b, rows] @ w[c].T, 0.0)
                    dc = dx1 if dc is None else dc + dx1
                    summed[b, rows, c] += 1
                    if lt == lt0:
                        da2_part[r, b, c] = dx1.sum(0)
                        firsts[r, b, c] += 1
                    else:
                        da2_part[r, b, c] += dx1.sum(0)
                        adds[r, b, c] += 1
            dc2_part[g, rows, c] = dc
            stored[g, rows, c] += 1
    da2 = da2_part[0].copy()
    for r in range(1, plan.ranges):
        da2 += da2_part[r]
    dc2 = dc2_part[0].copy()
    for g in range(1, plan.groups):
        dc2 += dc2_part[g]
    return da2, dc2, (stored, summed, firsts, adds)


@pytest.mark.parametrize("B,L,K,N", _BWD_SHAPES)
def test_pair_dx_plan_walk_matches_plain_backward(B, L, K, N):
    """The dX kernel's walk (64 labels x 256 input columns a tile, the
    sequences two at a time, label ranges and pair groups over the blocks)
    emulated in float64: every dc2 partial element is stored once, every
    dx1 element summed once, every da2 scratch element written once and
    added to once for each later label tile of its range, and da2 and dc2
    equal the plain backward's in float64."""
    a2, c2, w, dz = _bwd_inputs(B, L, K, N)
    plan = tst.pair_dx_plan(B, L, K, N, num_sms=7)
    assert plan.tiles_l == -(-L // 64) and plan.tiles_k == -(-K // 256)
    assert plan.ranges == min(plan.tiles_l, max(1, 7 // plan.tiles_k))
    da2, dc2, (stored, summed, firsts, adds) = _dx_walk(plan, a2, c2, w, dz)
    assert (stored == 1).all() and (summed == 1).all() and (firsts == 1).all()
    for r in range(plan.ranges):
        lt0, lt1 = plan.block(r * plan.tiles_k)[2]
        assert (adds[r] == lt1 - lt0 - 1).all()
    want = tst._pair_hidden_backward_plain(*(torch.from_numpy(x) for x in (a2, c2, w, dz)))
    np.testing.assert_allclose(da2, want[0].numpy(), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(dc2, want[1].numpy(), rtol=1e-12, atol=1e-10)


def _dw_walk(plan, a2, c2, dz):
    """The dW kernel's walk in float64: block i takes items i, i + grid, ...;
    an item forms x1 = relu(a2[b] + c2) for each label block of its range
    (outermost) and each sequence (c2 rows past L read as zeros, where dz is
    zero too) and stores its tile as dW (whole) or its f32 slot (a piece);
    a second pass adds each pieced tile's slots in range order.  Returns
    (dW, counts): how often each dW element was stored by an item, each
    slot element written, and each (tile, sequence, label) summed."""
    B, L, K, N = plan.batch, plan.labels, plan.width_in, plan.width_out
    pad = plan.lblocks * 64
    dz3 = np.concatenate([dz.reshape(B, L, N), np.zeros((B, pad - L, N))], 1)
    c2p = np.concatenate([c2, np.zeros((pad - L, K))])
    dw = np.full((K, N), np.nan)
    partial = np.full((max(plan.slots, 1), 128, plan.block_n), np.nan)
    stored = np.zeros((K, N), int)
    written = np.zeros(partial.shape, int)
    used = np.zeros((plan.tiles, B, pad), int)
    for i in range(plan.grid):
        for t in range(i, plan.items, plan.grid):
            m0, n0, lb0, lb1, slot = plan.item(t)
            assert 0 <= lb0 < lb1 <= plan.lblocks
            m, n = slice(m0, m0 + 128), slice(n0, n0 + plan.block_n)
            acc = np.zeros((128, plan.block_n))
            for lb in range(lb0, lb1):  # label block outermost, every sequence inside it
                rows = slice(lb * 64, lb * 64 + 64)
                for b in range(B):
                    acc += np.maximum(a2[b, m] + c2p[rows, m], 0.0).T @ dz3[b, rows, n]
                    used[(m0 // 128) * plan.tiles_n + n0 // plan.block_n, b, rows] += 1
            if slot is None:
                dw[m, n] = acc
                stored[m, n] += 1
            else:
                partial[slot] = acc
                written[slot] += 1
    for tt in range(plan.tail if plan.slots else 0):
        tile = plan.full + tt
        m0, n0 = (tile // plan.tiles_n) * 128, (tile % plan.tiles_n) * plan.block_n
        total = partial[tt].copy()
        for p in range(1, plan.pieces):
            total += partial[p * plan.tail + tt]
        dw[m0:m0 + 128, n0:n0 + plan.block_n] = total
        stored[m0:m0 + 128, n0:n0 + plan.block_n] += 1
    return dw, (stored, written, used)


@pytest.mark.parametrize("B,L,K,N", _BWD_SHAPES)
def test_pair_dw_plan_walk_matches_plain_backward(B, L, K, N):
    """The dW kernel's walk (128 x block_n tiles, label blocks outermost,
    whole waves whole and the last wave's tiles in pieces) emulated in
    float64: every dW element is stored once, every slot written once, every
    pair row summed into each output tile once, and dW equals the plain
    backward's in float64."""
    a2, c2, w, dz = _bwd_inputs(B, L, K, N)
    plan = tst.pair_dw_plan(B, L, K, N, num_sms=7)
    assert plan.block_n == (256 if N % 256 == 0 else 128)
    assert plan.full % 7 == 0 and 0 <= plan.tail < 7
    assert 1 <= plan.pieces <= plan.lblocks and plan.grid == min(7, plan.items)
    dw, (stored, written, used) = _dw_walk(plan, a2, c2, dz)
    assert (stored == 1).all() and (used == 1).all()
    assert plan.slots == 0 or (written == 1).all()
    want = tst._pair_hidden_backward_plain(*(torch.from_numpy(x) for x in (a2, c2, w, dz)))
    np.testing.assert_allclose(dw, want[2].numpy(), rtol=1e-12, atol=1e-9)


# (B, L) of every path that runs K4-bwd at H 3072: the default step, remat and
# encoder training; label subsets; the streamed tile at 32 and 128
# sequences; in-batch labels; a ragged L, one sequence, one label, odd B
_BWD_PATH_SHAPES = [(32, 32102), (32, 8192), (32, 2048), (128, 2048), (32, 300), (32, 40),
                    (5, 301), (1, 32102), (32, 1), (31, 2048)]


@pytest.mark.parametrize("B,L", _BWD_PATH_SHAPES)
def test_pair_bwd_plans_at_the_training_shape(B, L):
    """At H 3072 on 132 SMs, both plans cover the work of every path's shape
    exactly once: dX's blocks partition (label tile, column tile, pair) and
    its da2 scratch rows, dW's items every (tile, label block).  At B 32 x L
    32,102 dX runs 12 column tiles x 11 label ranges of 45-46 tiles (132
    blocks) and dW 264 whole tiles and 24 x 5 pieces (one wave each);
    groups split the pairs only at small L."""
    H = 3072
    dx = tst.pair_dx_plan(B, L, H, H, num_sms=132)
    assert dx.grid <= 132 and dx.tiles_k == 12
    cover = np.zeros((dx.tiles_l, dx.tiles_k, dx.pairs), int)
    rows = np.zeros((dx.ranges, B), int)
    for i in range(dx.grid):
        r, k0, (lt0, lt1), (p0, p1) = dx.block(i)
        cover[lt0:lt1, k0 // 256, p0:p1] += 1
        rows[r, [b for p in range(p0, p1) for b in (2 * p, 2 * p + 1) if b < B]] += 1
    assert (cover == 1).all()
    assert (rows == dx.tiles_k).all()  # each (range, b) row: once a column tile
    sizes = {dx.block(i)[2][1] - dx.block(i)[2][0] for i in range(dx.grid)}
    assert max(sizes) - min(sizes) <= 1
    dw = tst.pair_dw_plan(B, L, H, H, num_sms=132)
    assert (dw.block_n, dw.tiles, dw.full, dw.tail) == (256, 288, 264, 24)
    assert dw.pieces == min(5, dw.lblocks) and dw.grid == 132
    work = np.zeros((dw.tiles, dw.lblocks), int)
    for t in range(dw.items):
        m0, n0, lb0, lb1, slot = dw.item(t)
        work[(m0 // 128) * dw.tiles_n + n0 // 256, lb0:lb1] += 1
        assert (slot is None) == (t < dw.full or dw.pieces == 1)
    assert (work == 1).all()
    if (B, L) == (32, 32102):
        assert (dx.tiles_l, dx.ranges, dx.groups, dx.grid) == (502, 11, 1, 132)
        assert sizes == {45, 46}
        assert (dw.pieces, dw.items, dw.slots) == (5, 384, 120)
        assert dw.item(264) == (22 * 128, 0, 0, 100, 0)  # range 0 of the first pieced tile
    if L <= 320:  # in-batch labels: few label tiles, the pairs split over more SMs
        assert dx.groups == min(dx.pairs, 132 // (12 * dx.ranges))
        assert dx.grid > 12 * dx.tiles_l or dx.groups == dx.pairs


def test_pair_bwd_smem_bytes_per_kflop():
    """What each stage brings into shared memory for a kFLOP: dX 11.7 bytes
    (the first design's 128 x 128 tile: 15.6), dW 7.8 and a 64-label
    block's c2 once for its B steps (the first design's: 11.7)."""
    H = 3072
    assert tst.pair_dx_plan(32, 32102, H, H).smem_bytes_per_kflop == pytest.approx(11.71875)
    dw = tst.pair_dw_plan(32, 32102, H, H)
    assert dw.smem_bytes_per_kflop == pytest.approx((32768 + 16384 / 32) / 4194.304)
    assert 7.8 < dw.smem_bytes_per_kflop < 8.0


@pytest.mark.parametrize("B", [32, 128])
def test_pair_plans_at_the_streamed_tile(B):
    """The streamed scorer runs K4 and K4-bwd on one label tile at a time,
    each padded to the default 2,048 labels (the last of 32,102 holds 1,382
    real ones and 666 padded), so every launch takes L 2,048 whole: K4 16
    label tiles x B sequences x 12 column tiles; dX 32 label tiles of 64 in
    11 ranges of 2-3 x 12 column tiles, the B / 2 pairs in one group; dW
    264 whole tiles of B x 32 label steps and 24 x 5 pieces of 6-7 label
    blocks; each plan filling the 132 SMs."""
    H, tile = 3072, 2048
    assert 32102 - 15 * tile == 1382 and -(-32102 // tile) == 16
    k4 = tst.pair_train_plan(B, tile, H, H, num_sms=132)
    assert (k4.tiles_l, k4.tiles_n, k4.block_n, k4.grid) == (16, 12, 256, 132)
    assert k4.tiles == 16 * B * 12 and not tile % 128
    dx = tst.pair_dx_plan(B, tile, H, H, num_sms=132)
    assert (dx.tiles_l, dx.tiles_k, dx.ranges, dx.groups, dx.grid) == (32, 12, 11, 1, 132)
    assert {dx.block(i)[2][1] - dx.block(i)[2][0] for i in range(132)} == {2, 3}
    dw = tst.pair_dw_plan(B, tile, H, H, num_sms=132)
    assert (dw.tiles, dw.full, dw.pieces, dw.lblocks, dw.grid) == (288, 264, 5, 32, 132)
    assert {dw.item(t)[3] - dw.item(t)[2] for t in range(264, dw.items)} == {6, 7}


@pytest.mark.parametrize("K,N", [(64, 256), (128, 200), (192, 128), (0, 128)])
def test_pair_bwd_plans_refuse_widths(K, N):
    with pytest.raises(ValueError, match="multiples of 128"):
        tst.pair_dw_plan(5, 301, K, N)
    if K % 128:
        with pytest.raises(ValueError, match="multiples of 128"):
            tst.pair_dx_plan(5, 301, K, N)


def test_pair_bwd_cuda_wrapper_refuses_cpu_tensors():
    a2, c2, w = (torch.zeros(s, dtype=torch.bfloat16) for s in ((2, 128), (3, 128), (128, 128)))
    with pytest.raises(ValueError, match="CUDA device"):
        tst._pair_hidden_backward_cuda(a2, c2, w, torch.zeros(6, 128, dtype=torch.bfloat16))
