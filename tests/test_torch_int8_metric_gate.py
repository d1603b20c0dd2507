"""The int8 metric gate of tests/test_int8_metric_gate.py through the port's
plain int8 scorer (K2's plain version), on the CPU.

Same regime and limits as the JAX gate: the full output-MLP width (latent
1024, hidden 3072, two hidden layers) over B 4 x L 8192 label rows, random
weights from a seed, targets correlated with the exact float32 scores (the
top 2% plus 0.5% label noise), static scales calibrated on the same batch.
Gates: |Δ micro-mAP| < 5e-3, |Δ macro-mAP| < 2e-3 and the int8 logit RMSE
below 0.06 of the exact logits' standard deviation.  AP is the JAX
package's ``ExactAUPRC`` (numpy), the same function the JAX gate reads.

The fixture's ~2.5 TFLOP of CPU GEMMs run on at most ``THREADS`` torch
threads: the suite runs in several worker processes at once, and eight
threads in each oversubscribe the cores (the fixture then took 78 s of wall
time, against 4 s alone).
"""

import numpy as np
import pytest
import torch

from protnote_tpu.evaln.metrics import ExactAUPRC
from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
from protnote_tpu_torch.ops.pair_scorer import (
    calibrate_act_scales,
    fold_output_mlp,
    pair_logits_tiled_int8,
    pair_logits_tiled_reference,
    quantize_folded,
)

B, L = 4, 8192
EPS_MICRO = 5e-3
EPS_MACRO = 2e-3
EPS_NOISE_RATIO = 0.06
THREADS = 2


@pytest.fixture(scope="module")
def scored():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, THREADS))
    try:
        return _score()
    finally:
        torch.set_num_threads(threads)


def _score():
    cfg = ProtNoteConfig()  # full width: latent 1024, hidden 3072
    params, state = init_protnote(torch.Generator().manual_seed(0), cfg)
    folded = fold_output_mlp(params["output_mlp"], state["output_mlp"], "concatenation",
                             cfg.latent_dim, dtype=torch.float32)
    rng = np.random.default_rng(0)
    P_e = torch.from_numpy(rng.normal(size=(B, cfg.latent_dim)).astype(np.float32))
    L_e = torch.from_numpy(rng.normal(size=(L, cfg.latent_dim)).astype(np.float32))
    exact = pair_logits_tiled_reference(folded, P_e, L_e, 512, torch.float32).numpy()
    q = quantize_folded(folded, act_scales=calibrate_act_scales(folded, P_e, L_e, 512))
    int8 = pair_logits_tiled_int8(q, P_e, L_e, 512, torch.float32).numpy()
    p_exact = 1.0 / (1.0 + np.exp(-exact))
    targets = (p_exact > np.quantile(p_exact, 0.98)) | (rng.random(p_exact.shape) < 0.005)
    assert targets.any() and not targets.all()
    return exact, int8, targets


def _maps(logits, targets):
    m = ExactAUPRC(num_labels=L)
    m.update(1.0 / (1.0 + np.exp(-logits)), targets)
    return m.compute()


def test_int8_static_noise_ratio_within_gate(scored):
    exact, int8, _ = scored
    ratio = float(np.sqrt(np.mean((int8 - exact) ** 2)) / exact.std())
    assert ratio < EPS_NOISE_RATIO, ratio


def test_int8_static_map_delta_within_gate(scored):
    exact, int8, targets = scored
    m_exact, m_int8 = _maps(exact, targets), _maps(int8, targets)
    assert np.isfinite(m_exact["map_micro"]) and m_exact["map_micro"] > 0.5, \
        "degenerate eval: targets no longer correlate with scores"
    assert abs(m_int8["map_micro"] - m_exact["map_micro"]) < EPS_MICRO, (m_int8, m_exact)
    assert abs(m_int8["map_macro"] - m_exact["map_macro"]) < EPS_MACRO, (m_int8, m_exact)
