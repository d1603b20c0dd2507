"""The port's losses (protnote_tpu_torch/train/losses.py) against
``protnote_tpu.train.losses.get_loss_fn`` on the same numpy logits and
targets, masked and unmasked, and their gradients with respect to the logits.

Tolerance 1e-5 absolute on the loss and 1e-5 on each logit's gradient
(float32 on both sides; only summation orders differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.train.losses import get_loss_fn as jax_get_loss_fn
from protnote_tpu_torch.train.losses import get_loss_fn

TOL = 1e-5
B, L = 6, 40
LOSSES = ["BCE", "FocalLoss", "WeightedBCE", "CBLoss", "BatchWeightedBCE",
          "BatchLabelWeightedBCE", "RGDBCE", "SupCon"]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, size=(B, L)).astype(np.float32)
    targets = (rng.random((B, L)) < 0.15).astype(np.float32)
    targets[:, 0] = 1.0  # every row has a positive (SupCon's denominator)
    targets[:, 5] = 0.0  # a label with no positive (BatchLabelWeightedBCE)
    mask = np.ones((B, L), np.float32)
    mask[-1] = 0.0
    mask[:, -3:] = 0.0
    weights = rng.uniform(0.1, 2.0, L).astype(np.float32)
    counts = rng.integers(0, 50, L).astype(np.float32)
    return logits, targets, mask, weights, counts


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name, masked):
    logits, targets, mask, weights, counts = _data()
    params = {"LOSS_FN": name, "FOCAL_LOSS_GAMMA": 2, "FOCAL_LOSS_ALPHA": 0.25,
              "LABEL_SMOOTHING": 0.05, "RGDBCE_TEMP": 0.5}
    pos_weight = 1.5 if name == "BCE" else None
    jfn = jax_get_loss_fn(params, label_weights=jnp.asarray(weights),
                          label_counts=jnp.asarray(counts), bce_pos_weight=pos_weight)
    tfn = get_loss_fn(params, label_weights=torch.from_numpy(weights),
                      label_counts=torch.from_numpy(counts), bce_pos_weight=pos_weight)
    m_j = jnp.asarray(mask) if masked else None
    want, want_g = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(targets), mask=m_j))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tfn(x, torch.from_numpy(targets), mask=torch.from_numpy(mask) if masked else None)
    got.backward()
    got = got.detach()
    assert got.dim() == 0 and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=TOL, rtol=0)


def test_focal_loss_defaults_and_reductions():
    """The default FocalLoss (gamma 2, no alpha, no smoothing) and the
    ``sum``/``none`` reductions."""
    from protnote_tpu.train import losses as jl
    from protnote_tpu_torch.train import losses as tl

    logits, targets, mask, _, _ = _data(1)
    for reduction in ("mean", "sum", "none"):
        want = jl.focal_loss(jnp.asarray(logits), jnp.asarray(targets), mask=jnp.asarray(mask),
                             reduction=reduction)
        got = tl.focal_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                            mask=torch.from_numpy(mask), reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_unknown_and_missing_inputs_raise():
    with pytest.raises(ValueError, match="Unknown loss"):
        get_loss_fn({"LOSS_FN": "Hinge"})
    with pytest.raises(ValueError, match="label_weights"):
        get_loss_fn({"LOSS_FN": "WeightedBCE"})
    with pytest.raises(ValueError, match="label_counts"):
        get_loss_fn({"LOSS_FN": "CBLoss"})
