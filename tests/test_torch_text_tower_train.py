"""Training the label text tower in the port against the JAX package on the
CPU: the plain backward of masked attention (K8a-bwd,
ops/text_attention.py) and of the residual LayerNorm (K8b-bwd,
ops/layer_norm.py), the tower's gradients, and the train and eval steps
with the tower (last-n-layer unfreezing under a trainable mask, LoRA).

Inputs come from numpy seeds; weights from the JAX init (LayerNorms
perturbed), carried across with ``from_jax_tree``; masks are ragged, with an
all-masked row (the filler row of a padded chunk).

Tolerances:
* float32: 1e-5 absolute (the `TOL` of tests/test_reference_parity.py):
  both sides round at the same points and sum in other orders; for the
  tower's gradients, whose largest values reach ~80 with this loss, 1e-5 of
  max(1, the gradient's largest |value|);
* bfloat16, the plain backward against eager JAX (``jax.disable_jit()``:
  jitted on the CPU, XLA drops some bf16 roundings the source writes):
  2^-6 of the largest |value| of each gradient.  dP is rounded to bf16
  before it is used, and a float32 sum in another order can round it to the
  neighbouring bf16 value; dS and the outputs carry such a step.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import fusion as jfu
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu.models import text_transformer as jtt
from protnote_tpu.models.layers import gemm_precision as jax_gemm_precision
from protnote_tpu.train.losses import get_loss_fn as jax_loss
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state as jax_init_state
from protnote_tpu.train.step import make_eval_step as jax_eval_step
from protnote_tpu.train.step import make_train_step as jax_train_step
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models import text_transformer as ttt
from protnote_tpu_torch.models.convert import from_jax_tree, to_jax_tree
from protnote_tpu_torch.ops import layer_norm as k8b
from protnote_tpu_torch.ops import text_attention as k8a
from protnote_tpu_torch.train.losses import get_loss_fn
from protnote_tpu_torch.train.optim import Optimizer, tree_leaves
from protnote_tpu_torch.train.step import init_train_state, make_eval_step, make_train_step

TOL = 1e-5
BF16_TOL = 2.0 ** -6


def _port(tree):
    return from_jax_tree({"t": tree})["t"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ----------------------------------------------------------------------
# K8a-bwd: the plain backward against jax.vjp


def _jax_core(q, k, v, bias):
    """``protnote_tpu/models/text_transformer.py:_attention``, lines 182-190
    (the core between the projections), as the JAX package writes it."""
    hd = q.shape[-1]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32,
                        precision=jax_gemm_precision(q.dtype)) / math.sqrt(hd)
    scores = scores + bias
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v, preferred_element_type=jnp.float32,
                      precision=jax_gemm_precision(v.dtype)).astype(q.dtype)


def _attention_inputs(T, causal, seed, hd=64, nh=2, B=4):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, nh, T, hd)).astype(np.float32) * s
                  for s in (1.0, 1.0, 1.0, 0.5))
    mask = np.zeros((B, T), np.int32)
    mask[0] = 1
    mask[1, : max(T // 2, 1)] = 1
    mask[3, min(5, T - 1):] = 1  # row 2 stays all-masked
    keep = mask[:, None, None, :] > 0
    if causal:
        keep = keep & np.tril(np.ones((T, T), bool))[None, None]
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, g, mask, bias


@pytest.mark.parametrize("T,causal", [(12, False), (12, True), (33, False), (33, True)])
def test_attention_backward_reference_matches_jax_vjp_f32(T, causal):
    q, k, v, g, mask, bias = _attention_inputs(T, causal, seed=T + causal)
    _, vjp = jax.vjp(lambda a, b, c: _jax_core(a, b, c, jnp.asarray(bias)),
                     *(jnp.asarray(t) for t in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = k8a.masked_attention_backward_reference(
        *(torch.from_numpy(t) for t in (q, k, v, mask)), causal, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("T,causal", [(40, False), (40, True), (130, False)])
def test_attention_backward_reference_matches_eager_jax_bf16(T, causal):
    q, k, v, g, mask, bias = _attention_inputs(T, causal, seed=7 * T + causal)
    q, k, v, g = (_bf16(t) for t in (q, k, v, g))
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a, b, c: _jax_core(a, b, c, jnp.asarray(bias)),
                         *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
        want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g, jnp.bfloat16))]
    got = k8a.masked_attention_backward_reference(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), torch.from_numpy(mask),
        causal, torch.from_numpy(g).to(torch.bfloat16))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        assert np.isfinite(a).all(), name
        assert np.abs(a - b).max() <= BF16_TOL * np.abs(b).max(), name


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _k8a_bwd_emulated(q, k, v, mask, causal, g, tile=64):
    """K8a-bwd's algorithm (``csrc/text_attention_bwd.cu``) in float32
    numpy: the first kernel's running max and rescaled sums of y and dP * y
    over 64-key tiles, D = u / z^2, dS split into bf16 hi and lo halves for
    the products with K and Q; the second kernel's P = bf16(y / z) and dS
    from the saved m, z, D.  The products sum in numpy's order, not the
    tensor cores'."""
    B, nh, T, hd = q.shape
    scale = np.float32(1.0 / np.float32(np.sqrt(hd)))
    keep = mask[:, None, None, :] > 0
    if causal:
        keep = keep & np.tril(np.ones((T, T), bool))[None, None]
    h = (q @ np.swapaxes(k, -1, -2)).astype(np.float32) * scale + np.where(
        keep, np.float32(0), np.float32(-1e9))
    dp = _bf16_np(g @ np.swapaxes(v, -1, -2))
    m = np.full(h.shape[:-1], -np.inf, np.float32)
    z = np.zeros_like(m)
    u = np.zeros_like(m)
    for t0 in range(0, T, tile):
        ht, dpt = h[..., t0:t0 + tile], dp[..., t0:t0 + tile]
        mn = np.maximum(m, ht.max(-1))
        c = np.exp(m - mn).astype(np.float32)
        y = np.exp(ht - mn[..., None]).astype(np.float32)
        z = z * c + y.sum(-1)
        u = u * c + (dpt * y).sum(-1)
        m = mn
    D = u * (np.float32(1) / (z * z))
    y = np.exp(h - m[..., None]).astype(np.float32)
    ds = ((dp / z[..., None]) - D[..., None]) * y * scale
    hi = _bf16_np(ds)
    ds2 = hi + _bf16_np(ds - hi)
    p = _bf16_np(y / z[..., None])
    return (_bf16_np(ds2 @ k), _bf16_np(np.swapaxes(ds2, -1, -2) @ q),
            _bf16_np(np.swapaxes(p, -1, -2) @ g))


@pytest.mark.parametrize("T,causal", [(77, False), (77, True), (130, False), (200, True)])
def test_attention_backward_kernel_algorithm_matches_eager_jax_bf16(T, causal):
    """K8a-bwd's running statistics and hi/lo split of dS, emulated on the
    CPU, against the eager JAX VJP in bf16: 2^-6 of each gradient's largest
    |value| (the plain version's tolerance above), an all-masked row and a
    masked prefix included."""
    q, k, v, g, mask, bias = _attention_inputs(T, causal, seed=11 * T + causal)
    q, k, v, g = (_bf16(t) for t in (q, k, v, g))
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a, b, c: _jax_core(a, b, c, jnp.asarray(bias)),
                         *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
        want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g, jnp.bfloat16))]
    got = _k8a_bwd_emulated(q, k, v, mask, causal, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        assert np.abs(a - b).max() <= BF16_TOL * np.abs(b).max(), name


def test_attention_backward_all_masked_row_is_uniform_softmax_gradient():
    """A row whose keys are all masked: JAX's softmax is uniform over every
    key, and so is its gradient (finite, dV gets 1/T of its dctx)."""
    q, k, v, g, mask, bias = _attention_inputs(9, False, seed=3)
    mask[:] = 0
    dq, dk, dv = k8a.masked_attention_backward_reference(
        *(torch.from_numpy(t) for t in (q, k, v, mask)), False, torch.from_numpy(g))
    assert all(np.isfinite(t.numpy()).all() for t in (dq, dk, dv))
    np.testing.assert_allclose(dv.numpy(), np.broadcast_to(g.mean(2, keepdims=True), g.shape),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("arch", ["bert", "gpt"])
def test_attention_autograd_matches_jax_vjp(arch):
    """The port's ``_attention`` (projections, K8a through its autograd
    Function) differentiated against ``jax.vjp`` of the JAX ``_attention``,
    with respect to x and every projection weight; hd 16."""
    jcfg = jtt.TextEncoderConfig(arch=arch, vocab_size=60, hidden_size=32, num_layers=1,
                                 num_heads=2, intermediate_size=64, max_position_embeddings=40)
    tcfg = ttt.TextEncoderConfig(**{f.name: getattr(jcfg, f.name)
                                    for f in dataclasses.fields(jcfg) if f.name != "dtype"})
    lp = jax.tree_util.tree_map(np.asarray,
                                jtt.init_text_encoder(jax.random.PRNGKey(1), jcfg)["layers"][0])
    lp = {k: lp[k] for k in ("q", "k", "v", "o")}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 10, 32)).astype(np.float32)
    g = rng.normal(size=(4, 10, 32)).astype(np.float32)
    _, _, _, _, mask, bias = _attention_inputs(10, arch == "gpt", seed=2, hd=16, nh=2)
    _, vjp = jax.vjp(lambda p, x_: jtt._attention(p, x_, jnp.asarray(bias), jcfg, None, 1.0),
                     jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(g))
    tp = _port(lp)
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out = ttt._attention(tp, tx, torch.from_numpy(mask), tcfg, None, 1.0, k8a.masked_attention)
    grads = torch.autograd.grad(out, [tx] + leaves, torch.from_numpy(g))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x), atol=TOL, rtol=0)
    for a, b in zip(grads[1:], _leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=0)


# ----------------------------------------------------------------------
# K8b-bwd


def _ln_inputs(seed, H=64):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(5, 7, H)) * 3 + 10).astype(np.float32)
    a = rng.normal(size=(5, 7, H)).astype(np.float32)
    g = rng.normal(size=(5, 7, H)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, H).astype(np.float32),
         "bias": rng.normal(size=H).astype(np.float32)}
    return x, a, g, p


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_layer_norm_backward_matches_jax_vjp(dtype, residual):
    """The plain K8b-bwd (through the autograd Function) against ``jax.vjp``
    of ``_layer_norm(p, x + a)``: dx (= da), dscale and dbias.  bf16 against
    eager JAX: dx within 2^-6 of its largest |value| (one bf16 step of an
    output rounded once), dscale and dbias (float32 sums of bf16 inputs) to
    1e-4 of theirs."""
    x, a, g, p = _ln_inputs(3 + residual)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "bf16":
        x, a, g = (_bf16(t) for t in (x, a, g))

    def ln(x_, a_, p_):
        return jtt._layer_norm(p_, x_ + a_ if residual else x_, 1e-5)

    args = (jnp.asarray(x, jdt), jnp.asarray(a, jdt), jax.tree_util.tree_map(jnp.asarray, p))
    if dtype == "f32":
        _, vjp = jax.vjp(ln, *args)
        wx, wa, wp = vjp(jnp.asarray(g, jdt))
    else:
        with jax.disable_jit():
            _, vjp = jax.vjp(ln, *args)
            wx, wa, wp = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ta = torch.from_numpy(a).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(p["scale"]).requires_grad_(True)
    tb = torch.from_numpy(p["bias"]).requires_grad_(True)
    y = k8b.add_layer_norm(tx, ta if residual else None, ts, tb, 1e-5)
    got = torch.autograd.grad(y, [tx, ta, ts, tb] if residual else [tx, ts, tb],
                              torch.from_numpy(g).to(tdt))
    got = [t.float().numpy() for t in got]
    want = [np.asarray(t, np.float32) for t in
            ([wx, wa] if residual else [wx]) + [wp["scale"], wp["bias"]]]
    if residual:
        np.testing.assert_array_equal(got[0], got[1])  # one tensor for both operands
    for i, (gv, wv) in enumerate(zip(got, want)):
        if dtype == "f32":
            np.testing.assert_allclose(gv, wv, atol=TOL, rtol=0)
        else:
            tol = BF16_TOL if i < len(got) - 2 else 1e-4
            assert np.abs(gv - wv).max() <= tol * np.abs(wv).max(), i


def test_layer_norm_backward_reference_uses_the_forward_stats():
    """The forward keeps (mu, rstd) of each row; the backward reads them."""
    x, a, g, p = _ln_inputs(9)
    tx, ta = torch.from_numpy(x), torch.from_numpy(a)
    y, stats = k8b._reference_with_stats(tx, ta, torch.from_numpy(p["scale"]),
                                         torch.from_numpy(p["bias"]), 1e-5)
    v = (x + a).astype(np.float64)
    np.testing.assert_allclose(stats[..., 0].numpy(), v.mean(-1), rtol=1e-6)
    np.testing.assert_allclose(stats[..., 1].numpy(), 1 / np.sqrt(v.var(-1) + 1e-5), rtol=1e-5)
    dx, ds, db = k8b.add_layer_norm_backward_reference(tx, ta, torch.from_numpy(p["scale"]),
                                                       stats, torch.from_numpy(g))
    assert dx.shape == tx.shape and ds.shape == db.shape == (64,)
    np.testing.assert_allclose(db.numpy(), g.reshape(-1, 64).sum(0), atol=TOL)


# ----------------------------------------------------------------------
# the tower's gradients


def _tower_configs(arch="bert"):
    kw = dict(arch=arch, vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
              intermediate_size=32, max_position_embeddings=24, pad_token_id=1)
    if arch == "gpt":
        kw["scale_embedding"] = True
    return jtt.TextEncoderConfig(**kw), ttt.TextEncoderConfig(**kw)


def _tower(jcfg, seed=2):
    p = jax.tree_util.tree_map(np.asarray, jtt.init_text_encoder(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for ln in [p["embeddings_ln" if jcfg.arch == "bert" else "final_ln"]] + [
            lp[k] for lp in p["layers"] for k in ("attn_ln", "ffn_ln")]:
        ln["scale"] = rng.uniform(0.5, 1.5, ln["scale"].shape).astype(np.float32)
        ln["bias"] = rng.normal(0, 0.2, ln["bias"].shape).astype(np.float32)
    return p


def _lora(jcfg, seed=3, rank=2):
    lora = jax.tree_util.tree_map(np.asarray,
                                  jtt.init_lora(jax.random.PRNGKey(seed), jcfg, rank, 1))
    rng = np.random.default_rng(seed)
    for entry in lora.values():  # B non-zero, so A gets a gradient too
        for t in entry.values():
            t["B"] = rng.normal(0, 0.3, t["B"].shape).astype(np.float32)
    return lora


def _tokens(L=6, TK=10, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 49, (L, TK)).astype(np.int32)
    attn = (np.arange(TK)[None, :] < rng.integers(2, TK + 1, L)[:, None]).astype(np.int32)
    attn[-1] = 0  # a filler row
    ids[attn == 0] = 1
    return ids, attn


@pytest.mark.parametrize("arch", ["bert", "gpt"])
@pytest.mark.parametrize("lora", [False, True])
def test_tower_gradients_match_jax_grad(arch, lora):
    """``text_encoder_forward`` + mean pooling differentiated through K8a-bwd
    and K8b-bwd (their plain versions) against ``jax.grad``: every weight of
    the tower (the mask path), or the adapters of the last layer (LoRA)."""
    jcfg, tcfg = _tower_configs(arch)
    params = _tower(jcfg)
    adapters = _lora(jcfg) if lora else None
    ids, attn = _tokens()
    w = np.random.default_rng(5).normal(size=(ids.shape[0], 16)).astype(np.float32)

    def jloss(p, lo):
        h = jtt.text_encoder_forward(p, jnp.asarray(ids), jnp.asarray(attn), jcfg, lora=lo,
                                     lora_alpha=4.0, lora_rank=2)
        return jnp.sum(jtt.pool_hidden_states_jnp(h, jnp.asarray(attn), "mean") * w)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jl = None if adapters is None else jax.tree_util.tree_map(jnp.asarray, adapters)
    want = jax.grad(jloss, argnums=1 if lora else 0)(jp, jl)
    tp, tl = _port(params), None if adapters is None else _port(adapters)
    wrt = tree_leaves(tl if lora else tp)
    for t in wrt:
        t.requires_grad_(True)
    h = ttt.text_encoder_forward(tp, torch.from_numpy(ids), torch.from_numpy(attn), tcfg,
                                 lora=tl, lora_alpha=4.0, lora_rank=2)
    loss = (ttt.pool_hidden_states(h, torch.from_numpy(attn), "mean") * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, wrt)
    want = _leaves(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):  # gradients reach ~80 here: TOL of max(1, largest |value|)
        assert np.abs(a.numpy() - b).max() <= TOL * max(1.0, np.abs(b).max())


def test_trainable_mask_matches_jax():
    jcfg, tcfg = _tower_configs()
    params = _tower(jcfg)
    for n in (1, 2, 5, 0):
        want = _leaves(jtt.trainable_mask(jax.tree_util.tree_map(jnp.asarray, params), jcfg, n))
        got = tree_leaves(ttt.trainable_mask(_port(params), tcfg, n))
        assert [bool(x) for x in got] == [bool(x) for x in want]


# ----------------------------------------------------------------------
# the train and eval steps with the tower (tests/test_trainable_label_tower.py
# as parity tests)

PI = dict(output_channels=16, kernel_size=3, num_resnet_blocks=1, num_labels=4)
PN = dict(protein_embedding_dim=16, label_embedding_dim=16, latent_dim=8,
          projection_head_num_layers=2, projection_head_hidden_dim_scale_factor=2,
          output_mlp_num_layers=2, output_mlp_hidden_dim_scale_factor=2)
B, T, L, TK = 4, 24, 6, 10
FOCAL = {"LOSS_FN": "FocalLoss", "FOCAL_LOSS_GAMMA": 2, "FOCAL_LOSS_ALPHA": -1}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 49, (L, TK)).astype(np.int32)
    attn = np.ones((L, TK), np.int32)
    attn[:, 7:] = 0
    ids[attn == 0] = 1
    return {"aa_ids": rng.integers(0, 20, (B, T)).astype(np.int8),
            "lengths": rng.integers(5, T, (B,)).astype(np.int32),
            "example_mask": np.ones((B,), np.float32),
            "label_input_ids": ids, "label_attention_mask": attn,
            "label_multihots": (rng.random((B, L)) < 0.4).astype(np.float32)}


def _models(pooling="mean"):
    jpi_cfg, tpi_cfg = jpi.ProteInferConfig(**PI), tpi.ProteInferConfig(**PI)
    jpn = jfu.ProtNoteConfig(**PN, label_embedding_pooling_method=pooling)
    tpn = tfu.ProtNoteConfig(**PN, label_embedding_pooling_method=pooling,
                             compute_dtype=torch.float32)
    pi_p, pi_s = jpi.init_proteinfer(jax.random.PRNGKey(0), jpi_cfg)
    pn_p, pn_s = jfu.init_protnote(jax.random.PRNGKey(1), jpn)
    return jpi_cfg, tpi_cfg, jpn, tpn, (pi_p, pi_s), (pn_p, pn_s)


def _steps_both(params_cfg, n_steps, pooling="mean", mask_layers=None, lora=None,
                lora_rank=4, lora_alpha=8.0, loss=FOCAL):
    """Both train steps from one JAX state for ``n_steps`` on one batch:
    (per-step JAX metrics, port metrics, final JAX state, final port state
    as a JAX tree, the port's initial state)."""
    jpi_cfg, tpi_cfg, jpn, tpn, (pi_p, pi_s), (pn_p, pn_s) = _models(pooling)
    jcfg, tcfg = _tower_configs()
    text = _tower(jcfg)
    jmask = tmask = None
    if mask_layers is not None:
        jmask = {"protnote": jax.tree_util.tree_map(lambda _: True, pn_p),
                 "text": jtt.trainable_mask(text, jcfg, mask_layers)}
    tx = make_optimizer(params_cfg, trainable_mask=jmask)
    jts = jax_init_state(pn_p, pn_s, pi_p, pi_s, tx, text_params=text,
                         train_label_encoder=mask_layers is not None, lora_params=lora)
    tts = from_jax_tree(jax.tree_util.tree_map(np.asarray, jts))
    if mask_layers is not None:
        tmask = {"protnote": jax.tree_util.tree_map(lambda _: True, pn_p),
                 "text": ttt.trainable_mask(tts["trainable"]["text"], tcfg, mask_layers)}
    opt = Optimizer(params_cfg, trainable_mask=tmask)
    tts["opt_state"] = opt.init(tts["trainable"])
    start = from_jax_tree(jax.tree_util.tree_map(np.asarray, jts))  # an independent copy
    kw = dict(text_cfg=jcfg, pooling_method=pooling, lora_rank=lora_rank, lora_alpha=lora_alpha)
    jstep = jax_train_step(jpi_cfg, jpn, jax_loss(loss), tx, donate=False, **kw)
    tstep = make_train_step(tpi_cfg, tpn, get_loss_fn(loss), opt, **dict(kw, text_cfg=tcfg))
    batch = _batch()
    jm_all, tm_all = [], []
    for _ in range(n_steps):
        jts, jm = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
        tts, tm = tstep(tts, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
        jm_all.append(jax.tree_util.tree_map(np.asarray, jm))
        tm_all.append({k: v.numpy() for k, v in tm.items()})
    return jm_all, tm_all, jax.tree_util.tree_map(np.asarray, jts), to_jax_tree(tts, opt), start


# Leaves whose gradient is zero in exact arithmetic: the key bias (a
# softmax does not see a constant added to a row of scores), the scorer's
# attention bias (pooling "all", likewise), and the bias of the tower's last
# LayerNorm (it shifts every label embedding alike, and the BatchNorm of the
# W_l head takes the shift out).  Each side's gradient there is float32
# noise of ~1e-9, which Adam scales up to steps of up to the learning rate:
# their parameters are held to Adam's bound, not to each other.
def _zero_gradient(path: str, num_layers: int = 2) -> bool:
    return (path.endswith("['k']['bias']") or path.endswith("['attn']['bias']")
            or path.endswith(f"['text']['layers'][{num_layers - 1}]['ffn_ln']['bias']"))


def _assert_trees_close(got, want, atol=TOL, start=None, bound=None):
    """Leaf by leaf to ``atol``; with ``start`` and ``bound``, the
    zero-gradient leaves (:func:`_zero_gradient`) only within ``bound`` of
    ``start`` on both sides."""
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    a, b = _leaves(got), _leaves(want)
    s0 = _leaves(start) if start is not None else [None] * len(a)
    assert len(a) == len(b) == len(paths) > 0
    for path, x, y, x0 in zip(paths, a, b, s0):
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        if bound is not None and _zero_gradient(path):
            assert np.abs(x - x0).max() <= bound and np.abs(y - x0).max() <= bound, path
            continue
        np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=path)


def test_train_with_trainable_text_tower_matches_jax():
    """15 steps with the last layer of the tower unfrozen (Adam under the
    trainable mask, clip 1.0): losses and grad norms every step, and every
    parameter and Adam moment at the end, to 1e-5.  ``grad_norm`` counts the
    frozen layers' and the embeddings' gradients, as optax's clip before the
    partition does; those leaves keep their bits."""
    cfg = {"OPTIMIZER": "Adam", "LEARNING_RATE": 5e-3, "CLIP_VALUE": 1.0}
    jm, tm, jts, tts, start = _steps_both(cfg, 15, mask_layers=1)
    for j, t in zip(jm, tm):
        assert float(t["loss"]) == pytest.approx(float(j["loss"]), abs=TOL, rel=0)
        assert float(t["grad_norm"]) == pytest.approx(float(j["grad_norm"]), abs=TOL, rel=0)
    losses = [float(t["loss"]) for t in tm]
    assert np.isfinite(losses).all() and min(losses) < losses[0]
    start_np = jax.tree_util.tree_map(lambda t: t.numpy(), start["trainable"])
    _assert_trees_close({"trainable": tts["trainable"]}, {"trainable": jts["trainable"]},
                        start={"trainable": start_np}, bound=15 * 5e-3)
    _assert_trees_close(tts["opt_state"], jts["opt_state"])
    text0, text = start["trainable"]["text"], tts["trainable"]["text"]
    assert not np.allclose(text["layers"][1]["q"]["kernel"], text0["layers"][1]["q"]["kernel"])
    np.testing.assert_array_equal(text["layers"][0]["q"]["kernel"],
                                  text0["layers"][0]["q"]["kernel"].numpy())
    np.testing.assert_array_equal(text["word_embeddings"], text0["word_embeddings"].numpy())
    # the clip saw the frozen gradients: the norm exceeds the trained leaves' own
    assert float(tm[0]["grad_norm"]) > 0


def test_train_lora_only_matches_jax():
    """4 steps with LoRA on the last layer (rank 2, alpha 4): losses, the
    adapters and every parameter to 1e-5; B leaves zero, the tower's weights
    (``text_params``) do not move."""
    jcfg, _ = _tower_configs()
    lora = jax.tree_util.tree_map(np.asarray, jtt.init_lora(jax.random.PRNGKey(3), jcfg, 2, 1))
    cfg = {"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 1.0}
    jm, tm, jts, tts, start = _steps_both(cfg, 4, lora=lora, lora_rank=2, lora_alpha=4.0)
    for j, t in zip(jm, tm):
        assert float(t["loss"]) == pytest.approx(float(j["loss"]), abs=TOL, rel=0)
        assert float(t["grad_norm"]) == pytest.approx(float(j["grad_norm"]), abs=TOL, rel=0)
    _assert_trees_close(tts["trainable"], jts["trainable"])
    assert np.abs(tts["trainable"]["lora"]["1"]["q"]["B"]).max() > 0
    _assert_trees_close(tts["text_params"], jts["text_params"], atol=0)
    np.testing.assert_array_equal(tts["text_params"]["layers"][1]["q"]["kernel"],
                                  start["text_params"]["layers"][1]["q"]["kernel"].numpy())


def test_eval_with_text_tower_matches_precomputed_and_jax():
    """The eval step through the tower equals the eval step on the tower's
    pooled embeddings, and the JAX eval step through its tower."""
    jpi_cfg, tpi_cfg, jpn, tpn, (pi_p, pi_s), (pn_p, pn_s) = _models()
    jcfg, tcfg = _tower_configs()
    text = _tower(jcfg)
    jts = jax_init_state(pn_p, pn_s, pi_p, pi_s, make_optimizer({"OPTIMIZER": "Adam"}),
                         text_params=text)
    tts = from_jax_tree(jax.tree_util.tree_map(np.asarray, jts))
    batch = _batch(1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = make_eval_step(tpi_cfg, tpn, text_cfg=tcfg)(tts, tb)["logits"].numpy()
    want = np.asarray(jax_eval_step(jpi_cfg, jpn, text_cfg=jcfg)(
        jts, {k: jnp.asarray(v) for k, v in batch.items()})["logits"])
    np.testing.assert_allclose(out, want, atol=TOL, rtol=0)
    with torch.no_grad():
        h = ttt.text_encoder_forward(tts["text_params"], tb["label_input_ids"],
                                     tb["label_attention_mask"], tcfg)
        emb = ttt.pool_hidden_states(h, tb["label_attention_mask"], "mean")
    pre = {k: v for k, v in tb.items() if k not in ("label_input_ids", "label_attention_mask")}
    pre["label_embeddings"] = emb
    np.testing.assert_allclose(make_eval_step(tpi_cfg, tpn)(tts, pre)["logits"].numpy(), out,
                               atol=TOL, rtol=0)


def test_pooling_all_runs_through_both_steps():
    """Pooling ``all`` (additive attention over the token states): one train
    step and the eval step take the label attention mask, as in JAX."""
    cfg = {"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-3}
    jm, tm, jts, tts, start = _steps_both(cfg, 1, pooling="all", loss={"LOSS_FN": "BCE"})
    assert float(tm[0]["loss"]) == pytest.approx(float(jm[0]["loss"]), abs=TOL, rel=0)
    start_np = jax.tree_util.tree_map(lambda t: t.numpy(), start["trainable"])
    _assert_trees_close({"trainable": tts["trainable"]}, {"trainable": jts["trainable"]},
                        start={"trainable": start_np}, bound=1e-3)
    _, tpi_cfg, _, tpn, _, _ = _models("all")
    _, tcfg = _tower_configs()
    out = make_eval_step(tpi_cfg, tpn, get_loss_fn({"LOSS_FN": "BCE"}), text_cfg=tcfg,
                         pooling_method="all")(
        from_jax_tree(tts), {k: torch.from_numpy(v) for k, v in _batch().items()})
    assert out["logits"].shape == (B, L) and np.isfinite(out["logits"].numpy()).all()


def test_init_train_state_text_layouts():
    """The JAX ``init_train_state`` layouts: the tower frozen in
    ``text_params``, trainable under ``trainable["text"]``, adapters under
    ``trainable["lora"]``; the masked optimizer keeps moments of the masked
    leaves only."""
    jcfg, tcfg = _tower_configs()
    text = _port(_tower(jcfg))
    pn = {"w": torch.zeros(2)}
    frozen = init_train_state(pn, {}, {}, {}, Optimizer({}), text_params=text)
    assert frozen["text_params"] is text and set(frozen["trainable"]) == {"protnote"}
    mask = {"protnote": {"w": True}, "text": ttt.trainable_mask(text, tcfg, 1)}
    opt = Optimizer({}, trainable_mask=mask)
    tr = init_train_state(pn, {}, {}, {}, opt, text_params=text, train_label_encoder=True)
    assert tr["text_params"] is None and tr["trainable"]["text"] is text
    mu = tr["opt_state"]["mu"]
    assert mu["text"]["word_embeddings"] is None and mu["text"]["layers"][1]["q"]["kernel"] \
        is not None
    lo = init_train_state(pn, {}, {}, {}, Optimizer({}), text_params=text,
                          lora_params={"1": {}})
    assert lo["trainable"]["lora"] == {"1": {}} and lo["text_params"] is text


@pytest.mark.parametrize("cfg", [
    {"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 1.0},
    {"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2},
    {"OPTIMIZER": "SGD", "LEARNING_RATE": 5e-2, "CLIP_VALUE": 1.0},
    {"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 1.0,
     "GRADIENT_ACCUMULATION_STEPS": 2},
], ids=["adam_clip", "adam", "sgd_clip", "adam_accum2"])
def test_masked_optimizer_state_reads_both_ways(cfg):
    """The ``multi_transform`` state of a trainable mask: 3 optax updates,
    the state into the port (``from_jax_tree``: the moments of the frozen
    leaves None), 2 more updates on each side to 1e-5; then the port's state
    in the JAX layout (``to_jax_tree``), written as checkpoint bytes and
    restored by flax into a JAX template, equals optax's own state,
    ``MaskedNode`` leaves included."""
    import optax
    from flax import serialization

    from protnote_tpu_torch.core.checkpoint import msgpack_pack

    rng = np.random.default_rng(6)
    params = {"protnote": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "text": {"layers": [{"q": rng.normal(size=5).astype(np.float32)},
                                  {"q": rng.normal(size=(2, 2)).astype(np.float32)}],
                       "word_embeddings": rng.normal(size=(6, 2)).astype(np.float32)}}
    mask = {"protnote": {"w": True},
            "text": {"layers": [{"q": False}, {"q": True}], "word_embeddings": False}}
    grads = [jax.tree_util.tree_map(lambda x: (3 * rng.normal(size=x.shape)).astype(np.float32),
                                    params) for _ in range(5)]
    tx = make_optimizer(cfg, trainable_mask=mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads[:3]:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    ts = from_jax_tree({"trainable": jax.tree_util.tree_map(np.asarray, jp),
                        "opt_state": jax.tree_util.tree_map(np.asarray, state), "step": 3})
    opt = Optimizer(cfg, trainable_mask=mask)
    if opt.adam:
        assert ts["opt_state"]["mu"]["text"]["word_embeddings"] is None
        assert ts["opt_state"]["mu"]["text"]["layers"][1]["q"] is not None
    frozen = ts["trainable"]["text"]["layers"][0]["q"].clone()
    port_state = ts["opt_state"]
    for g in grads[3:]:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        port_state = opt.update(jax.tree_util.tree_map(torch.from_numpy, g), ts["trainable"],
                                port_state)
    _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), ts["trainable"]),
                        jax.tree_util.tree_map(np.asarray, jp))
    assert torch.equal(ts["trainable"]["text"]["layers"][0]["q"], frozen)
    written = to_jax_tree(dict(ts, opt_state=port_state), opt)["opt_state"]
    restored = serialization.from_state_dict(  # through the checkpoint's bytes
        tx.init(jp), serialization.msgpack_restore(msgpack_pack(written)))
    a = jax.tree_util.tree_leaves(restored)
    b = jax.tree_util.tree_leaves(state)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                   atol=TOL, rtol=0)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(state)
