"""The port's training scorer (protnote_tpu_torch/ops/streaming_train.py) and
train-mode BatchNorm (models/layers.py) against the JAX package on the CPU.

The same numpy inputs and JAX-initialised weights (random BatchNorm
parameters and running statistics, He-scaled linears) go through the JAX
function and the port's plain versions of K4 and K5.

Tolerances:
* float32: 1e-5 absolute on logits, new running statistics and gradients
  (of size ~1e-2..1 here), the `TOL` of tests/test_reference_parity.py: the
  two sides sum in other orders, and the port's K5 backward is the JAX
  custom VJP's formula where JAX's unfused setting differentiates the
  composition (the same function).
* bfloat16: logits to 3e-2 absolute (both sides round a2, c2, x1 and every
  pre-activation to bf16 at the same points, but a sum in another order can
  land one bf16 step (2^-8 relative) away and move what follows).
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


def _jax_run(p, s, P_e, L_e, em, lm, fusion, fused, dtype=jnp.float32):
    w = jnp.asarray(_loss_weights()) * jnp.asarray(em)[:, None] * jnp.asarray(lm)[None, :]

    def f(p_, P_, L_):
        lg, new = jst.pair_logits_dense_decomposed(
            p_, jax.tree_util.tree_map(jnp.asarray, s), P_, L_, fusion,
            example_mask=jnp.asarray(em), label_mask=jnp.asarray(lm), compute_dtype=dtype,
            fused_bn_vjp=fused)
        return jnp.sum(jax.nn.sigmoid(lg) * w), (lg, new)

    (_, (lg, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(P_e), jnp.asarray(L_e))
    return jax.tree_util.tree_map(np.asarray, (lg, new, grads))


def _port_run(p, s, P_e, L_e, em, lm, fusion, dtype=torch.float32):
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
        label_mask=torch.from_numpy(lm), compute_dtype=dtype)
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


def test_unported_settings_raise():
    p, s = _weights()
    t = from_jax_tree({"p": p, "s": s})
    P_e, L_e, _, _ = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(NotImplementedError, match="GRADIENT_CHECKPOINTING"):
        tst.pair_logits_dense_decomposed(t["p"], t["s"], P_e, L_e, remat=True)
    with pytest.raises(NotImplementedError, match="K6"):
        tst.pair_logits_streaming_train(t["p"], t["s"], P_e, L_e)
