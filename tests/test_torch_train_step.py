"""The port's train step (protnote_tpu_torch/train/step.py) against the JAX
``make_train_step`` on the CPU.

One JAX ``init_train_state`` (small widths, random BatchNorm statistics,
He-scaled linears) is converted with ``from_jax_tree``; both steps then run
on the same numpy batches with label noising and dropout off (JAX's random
bits cannot be matched) and the default FocalLoss + clipped Adam.

Tolerances:
* float32: 1e-5 absolute on the loss, the gradient norm, parameters, BN
  running statistics and Adam moments (the `TOL` of
  tests/test_reference_parity.py); tp/fp/fn exactly (the logits agree to
  ~1e-6 and no probability lies within 1e-4 of the threshold).
* bfloat16: the loss to 2e-3 relative and the gradient norm to 5e-2
  relative after one step (both sides round at the same points, but a sum
  in another order lands a bf16 step away and the backward's bf16
  cotangents carry it).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import fusion as jfu
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu.train.losses import get_loss_fn as jax_loss
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state as jax_init_state
from protnote_tpu.train.step import make_train_step as jax_train_step
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree, to_jax_tree
from protnote_tpu_torch.train.losses import get_loss_fn
from protnote_tpu_torch.train.optim import Optimizer
from protnote_tpu_torch.train.step import make_train_step

TOL = 1e-5
B, T, L, D = 6, 40, 13, 16
PARAMS = {"LOSS_FN": "FocalLoss", "FOCAL_LOSS_GAMMA": 2, "FOCAL_LOSS_ALPHA": -1,
          "OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 0.3}
PI = dict(input_channels=20, output_channels=24, kernel_size=3, num_resnet_blocks=1,
          num_labels=5)
PN = dict(protein_embedding_dim=24, label_embedding_dim=D, latent_dim=8,
          projection_head_num_layers=2, projection_head_hidden_dim_scale_factor=2,
          output_mlp_num_layers=3, output_mlp_hidden_dim_scale_factor=2)


def _configs(bf16=False):
    jpi_cfg = jpi.ProteInferConfig(**PI)
    tpi_cfg = tpi.ProteInferConfig(**PI)
    jpn = jfu.ProtNoteConfig(**PN, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tpn = tfu.ProtNoteConfig(**PN, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return jpi_cfg, tpi_cfg, jpn, tpn


def _jax_state(seed=0):
    jpi_cfg, _, jpn, _ = _configs()
    pi_p, pi_s = jpi.init_proteinfer(jax.random.PRNGKey(seed), jpi_cfg)
    pn_p, pn_s = jfu.init_protnote(jax.random.PRNGKey(seed + 1), jpn)
    rng = np.random.default_rng(seed)
    pn_p = jax.tree_util.tree_map(np.asarray, pn_p)
    pn_s = jax.tree_util.tree_map(np.asarray, pn_s)
    for head in ("W_p", "W_l", "output_mlp"):
        for st in pn_s[head]["bns"]:
            st["mean"] = rng.normal(0, 0.2, st["mean"].shape).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
        for lin in pn_p[head]["layers"] + [pn_p[head].get("out", {})]:
            if "kernel" in lin:
                lin["kernel"] = lin["kernel"] * np.float32(6 ** 0.5)
    return jax_init_state(pn_p, pn_s, pi_p, pi_s, make_optimizer(PARAMS))


def _batches(n, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lengths = rng.integers(10, T + 1, size=B).astype(np.int32)
        aa = rng.integers(0, 20, size=(B, T)).astype(np.int32)
        aa[np.arange(T)[None, :] >= lengths[:, None]] = 20  # the pad id
        em = np.ones(B, np.float32)
        em[-1 - i % 2:] = 0.0
        lm = (np.arange(L) < L - 2).astype(np.float32)
        out.append({"aa_ids": aa, "lengths": lengths, "example_mask": em,
                    "label_embeddings": rng.normal(size=(L, D)).astype(np.float32),
                    "label_multihots": (rng.random((B, L)) < 0.3).astype(np.float32),
                    "label_mask": lm})
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _run_both(jts, batches, bf16=False):
    """Steps on both sides from the same state; returns the metrics of each
    step on each side and the final states (the port's as a JAX tree)."""
    jpi_cfg, tpi_cfg, jpn, tpn = _configs(bf16)
    jstep = jax_train_step(jpi_cfg, jpn, jax_loss(PARAMS), make_optimizer(PARAMS),
                           donate=False)
    opt = Optimizer(PARAMS)
    tstep = make_train_step(tpi_cfg, tpn, get_loss_fn(PARAMS), opt)
    tts = from_jax_tree(jax.tree_util.tree_map(np.asarray, jts))
    metrics = []
    gen = torch.Generator().manual_seed(0)
    for batch in batches:
        jts, jm = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
        tts, tm = tstep(tts, {k: torch.from_numpy(v) for k, v in batch.items()}, gen)
        metrics.append((jax.tree_util.tree_map(np.asarray, jm),
                        {k: v.numpy() for k, v in tm.items()}))
    return metrics, jax.tree_util.tree_map(np.asarray, jts), to_jax_tree(tts, opt)


def test_three_steps_match_jax_f32():
    metrics, jts, tts = _run_both(_jax_state(), _batches(3))
    for jm, tm in metrics:
        np.testing.assert_allclose(tm["loss"], jm["loss"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], atol=TOL, rtol=0)
        assert jm["grad_norm"] > PARAMS["CLIP_VALUE"]  # the clip binds
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
        assert int(tm["examples"]) == int(jm["examples"])
    assert sum(int(jm["tp"].sum()) for jm, _ in metrics) > 0
    for key in ("trainable", "model_state"):
        got, want = _leaves(tts[key]), _leaves(jts[key])
        assert len(got) == len(want) >= 10
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=key)
    got, want = _leaves(tts["opt_state"]), _leaves(jts["opt_state"])
    assert len(got) == len(want) and int(tts["step"]) == int(jts["step"]) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_one_step_matches_jax_bf16():
    metrics, _, _ = _run_both(_jax_state(), _batches(1), bf16=True)
    (jm, tm), = metrics
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-3, atol=0)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=5e-2, atol=0)


def test_jax_trained_state_with_moments_steps_alike():
    """Two JAX steps, the state (Adam moments included) converted, then one
    step on each side."""
    jpi_cfg, _, jpn, _ = _configs()
    jstep = jax_train_step(jpi_cfg, jpn, jax_loss(PARAMS), make_optimizer(PARAMS),
                           donate=False)
    jts = _jax_state(seed=3)
    for batch in _batches(2, seed=4):
        jts, _ = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    assert int(jts["step"]) == 2
    metrics, jts, tts = _run_both(jts, _batches(1, seed=5))
    np.testing.assert_allclose(metrics[0][1]["loss"], metrics[0][0]["loss"], atol=TOL, rtol=0)
    for key in ("trainable", "model_state", "opt_state"):
        for a, b in zip(_leaves(tts[key]), _leaves(jts[key])):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=key)


def test_label_rows_gather_matches_shipped_embeddings():
    """A batch with ``label_rows`` into a resident matrix trains like the
    same batch with the gathered rows shipped."""
    jts = _jax_state()
    _, tpi_cfg, _, tpn = _configs()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    matrix = torch.cat([batch["label_embeddings"], torch.randn(4, D)])
    gathered = dict(batch, label_matrix=matrix,
                    label_rows=torch.arange(L, dtype=torch.int32))
    del gathered["label_embeddings"]
    out = []
    for b in (batch, gathered):
        opt = Optimizer(PARAMS)
        step = make_train_step(tpi_cfg, tpn, get_loss_fn(PARAMS), opt)
        tts, m = step(from_jax_tree(jax.tree_util.tree_map(np.asarray, jts)), b, None)
        out.append((m["loss"], _leaves(to_jax_tree(tts, opt)["trainable"])))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


def test_label_noise_range_and_scale():
    """Noising cannot match JAX's bits: U(-1, 1) * alpha / sqrt(d)."""
    L_f = torch.zeros(400, 64)
    noised = tfu.noise_label_embeddings(L_f, 20.0, torch.Generator().manual_seed(0))
    bound = 20.0 / 8.0
    assert float(noised.abs().max()) <= bound
    assert abs(float(noised.std()) - bound / np.sqrt(3)) < 0.02 * bound
    assert abs(float(noised.mean())) < 0.02 * bound


def test_unported_training_settings_raise():
    jts = _jax_state()
    _, tpi_cfg, _, tpn = _configs()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    for change, match in (({"train_label_tile": 8}, "K6"),
                          ({"gradient_checkpointing": True}, "GRADIENT_CHECKPOINTING"),
                          ({"pair_backend": "tiled"}, "dense"),
                          ({"dropout": 0.1}, "OUTPUT_MLP_DROPOUT")):
        cfg = dataclasses.replace(tpn, **change)
        step = make_train_step(tpi_cfg, cfg, get_loss_fn(PARAMS), Optimizer(PARAMS))
        with pytest.raises(NotImplementedError, match=match):
            step(from_jax_tree(jax.tree_util.tree_map(np.asarray, jts)), batch, None)
