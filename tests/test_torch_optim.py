"""The port's optimizers (protnote_tpu_torch/train/optim.py) against the
optax chains of ``protnote_tpu.train.optim.make_optimizer``: 5 updates on the
same parameters and gradients, with global-norm clipping (binding and not),
weight decay, a trainable mask and accumulation over k = 2 steps; the
optimizer state against optax's in the checkpoint layout, and an optax state
converted mid-run (``from_jax_tree``) and stepped on by both.

Tolerance 1e-5 absolute on parameters and moments (float32; optax and the
port round ``1 - b^t`` and the moment updates in their own orders).  With
``OPTIMIZER_MOMENT_DTYPE: bfloat16`` (optax's ``mu_dtype``) the chain runs
under ``jax.jit``, as in the JAX train step (XLA keeps ``b1 * mu`` in f32,
where eager optax rounds it to bf16), and the bf16 first moment is held to
optax's within one bf16 step on at most 1% of its elements (the f32 sums
may differ in their last bit and round to the neighbouring bf16 value),
parameters and the f32 second moment to 1e-5.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from protnote_tpu.train.optim import make_optimizer
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.train.optim import Optimizer, tree_leaves

TOL = 1e-5


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float32),
                  rng.normal(size=(2, 2)).astype(np.float32)]}


def _grads(n, scale, seed=1):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda x: (scale * rng.normal(size=x.shape)).astype(np.float32), _params())
        for _ in range(n)]


def _run_jax(cfg, grads, mask=None, params=None, state=None, jit=False):
    tx = make_optimizer(cfg, trainable_mask=mask)
    params = jax.tree_util.tree_map(jnp.asarray, params if params is not None else _params())
    state = tx.init(params) if state is None else state
    update = jax.jit(tx.update) if jit else tx.update
    for g in grads:
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
    return jax.tree_util.tree_map(np.asarray, params), state


def _run_port(cfg, grads, mask=None, params=None, state=None):
    opt = Optimizer(cfg, trainable_mask=mask)
    params = jax.tree_util.tree_map(torch.from_numpy,
                                    params if params is not None else _params())
    state = opt.init(params) if state is None else state
    for g in grads:
        state = opt.update(jax.tree_util.tree_map(torch.from_numpy, g), params, state)
    return jax.tree_util.tree_map(lambda t: t.numpy(), params), state, opt


def _close(got, want):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=0)


CASES = {
    "adam_clip_binds": ({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 1.0}, 3.0),
    "adam_clip_idle": ({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 100.0,
                        "WEIGHT_DECAY": 0.1}, 0.3),
    "adam_no_clip": ({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2}, 0.3),
    "adamw": ({"OPTIMIZER": "AdamW", "LEARNING_RATE": 1e-2, "WEIGHT_DECAY": 0.1,
               "CLIP_VALUE": 1.0}, 3.0),
    "sgd": ({"OPTIMIZER": "SGD", "LEARNING_RATE": 5e-2, "CLIP_VALUE": 1.0}, 3.0),
    "sgd_decay": ({"OPTIMIZER": "SGD", "LEARNING_RATE": 5e-2, "WEIGHT_DECAY": 0.1,
                   "CLIP_VALUE": 1.0}, 3.0),
    "adam_accum2": ({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 1.0,
                     "GRADIENT_ACCUMULATION_STEPS": 2}, 3.0),
    "adamw_accum2": ({"OPTIMIZER": "AdamW", "LEARNING_RATE": 1e-2, "WEIGHT_DECAY": 0.1,
                      "GRADIENT_ACCUMULATION_STEPS": 2}, 0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_updates_match_optax(case):
    cfg, scale = CASES[case]
    grads = _grads(5, scale)
    want, jstate = _run_jax(cfg, grads)
    got, state, opt = _run_port(cfg, grads)
    _close(got, want)
    assert not np.allclose(got["a"], _params()["a"])  # the updates moved something
    # the state in the checkpoint layout (lists written as {"0": ..} maps)
    # equals optax's state dict
    got_sd = _state_dict(opt.jax_opt_state(state, lambda t: jax.tree_util.tree_map(
        np.asarray, t)))
    want_sd = serialization.to_state_dict(jstate)
    assert jax.tree_util.tree_structure(got_sd) == jax.tree_util.tree_structure(want_sd)
    for a, b in zip(jax.tree_util.tree_leaves(got_sd), jax.tree_util.tree_leaves(want_sd)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0)


def _state_dict(tree):
    if isinstance(tree, dict):
        return {k: _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def test_trainable_mask_freezes_leaves():
    """Frozen leaves keep their values; clipping still sees their
    gradients (the clip precedes optax.multi_transform)."""
    cfg = {"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 1.0}
    mask = {"a": True, "b": [False, True]}
    grads = _grads(5, 3.0)
    want, _ = _run_jax(cfg, grads, mask=mask)
    got, _, _ = _run_port(cfg, grads, mask=mask)
    _close(got, want)
    np.testing.assert_array_equal(got["b"][0], _params()["b"][0])


@pytest.mark.parametrize("case", ["adam_clip_binds", "adam_accum2"])
def test_optax_state_converts_and_continues(case):
    """3 optax updates, the state through ``from_jax_tree``, then 2 more
    updates on each side (the second accumulation window spans the
    conversion)."""
    cfg, scale = CASES[case]
    grads = _grads(5, scale)
    mid, jstate = _run_jax(cfg, grads[:3])
    want, _ = _run_jax(cfg, grads[3:], params=mid, state=jstate)
    ts = from_jax_tree({"trainable": mid, "opt_state": jax.tree_util.tree_map(
        np.asarray, jstate), "step": np.int32(3)})
    assert ts["step"] == 3 and ts["opt_state"]["count"] == (3 if case == "adam_clip_binds"
                                                              else 1)
    _close(jax.tree_util.tree_map(lambda t: t.numpy(), ts["opt_state"]["mu"]),
           jax.tree_util.tree_map(np.asarray, _adam_state(jstate).mu))
    got, _, _ = _run_port(cfg, grads[3:], params=jax.tree_util.tree_map(
        lambda t: t.numpy(), ts["trainable"]), state=ts["opt_state"])
    _close(got, want)


def _adam_state(state):
    for node in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(node, optax.ScaleByAdamState):
            return node
    raise AssertionError("no ScaleByAdamState")


def test_moment_dtype_and_unknown_optimizer_raise():
    with pytest.raises(ValueError, match="OPTIMIZER_MOMENT_DTYPE"):
        Optimizer({"OPTIMIZER_MOMENT_DTYPE": "float16"})
    with pytest.raises(ValueError, match="Unknown optimizer"):
        Optimizer({"OPTIMIZER": "Lion"})
    assert len(tree_leaves(_params())) == 3


def _bf16_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("case", ["adam_clip_binds", "adam_no_clip", "adamw", "adam_accum2"])
def test_bf16_first_moment_matches_optax(case):
    """``OPTIMIZER_MOMENT_DTYPE: bfloat16``: 6 updates against optax's
    ``mu_dtype=bfloat16`` under ``jax.jit`` (b1 rounded to bf16, the update
    from the f32 moment, mu rounded when stored; nu f32)."""
    cfg, scale = CASES[case]
    cfg = dict(cfg, OPTIMIZER_MOMENT_DTYPE="bfloat16")
    grads = _grads(6, scale)
    want, jstate = _run_jax(cfg, grads, jit=True)
    got, state, _ = _run_port(cfg, grads)
    _close(got, want)
    jadam = _adam_state(jstate)
    mus = tree_leaves(state["mu"])
    assert all(m.dtype == torch.bfloat16 for m in mus)
    assert all(np.asarray(m).dtype == jnp.bfloat16 for m in jax.tree_util.tree_leaves(jadam.mu))
    a = np.concatenate([_bf16_np(m).ravel() for m in mus])
    b = np.concatenate([np.asarray(m, np.float32).ravel()
                        for m in jax.tree_util.tree_leaves(jadam.mu)])
    off = a != b
    assert off.mean() <= 0.01
    np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0)
    _close(jax.tree_util.tree_map(lambda t: t.numpy(), state["nu"]), jadam.nu)
    # the f32 first moment differs: the bf16 rounding is really taken
    f32, _, _ = _run_port(CASES[case][0], grads)
    assert any(not np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                                        jax.tree_util.tree_leaves(f32)))


def test_bf16_first_moment_converts_and_continues():
    """3 optax updates with a bf16 mu, the state through ``from_jax_tree``
    (restored moments are float32 like the template) and the load path's
    cast back to the moment dtype, then 3 more updates on each side."""
    cfg = dict(CASES["adam_clip_binds"][0], OPTIMIZER_MOMENT_DTYPE="bfloat16")
    grads = _grads(6, 3.0)
    mid, jstate = _run_jax(cfg, grads[:3], jit=True)
    want, _ = _run_jax(cfg, grads[3:], params=mid, state=jstate, jit=True)
    f32 = lambda t: np.asarray(t, np.float32)  # noqa: E731
    ts = from_jax_tree({"trainable": mid, "opt_state": jax.tree_util.tree_map(f32, jstate),
                        "step": np.int32(3)})
    opt = Optimizer(cfg)
    state = dict(ts["opt_state"], mu=jax.tree_util.tree_map(
        lambda t: t.to(opt.mu_dtype), ts["opt_state"]["mu"]))
    got, state, _ = _run_port(cfg, grads[3:], params=jax.tree_util.tree_map(
        lambda t: t.numpy(), ts["trainable"]), state=state)
    _close(got, want)
