"""The port's folded pair scorer (protnote_tpu_torch/ops/pair_scorer.py)
against the JAX one (protnote_tpu/ops/pair_scorer.py) on the same weights.

On the CPU ``pair_logits_tiled`` runs the plain PyTorch version; the CUDA
kernel is held against that plain version on the card
(tests/test_torch_kernels_cuda.py, and chip_smoke.py at full width).

Tolerances:
* float32: 1e-5 absolute on logits of std ~0.1 (the repo's f32 parity
  tolerance). JAX runs its f32 products at Precision.HIGHEST and torch in
  full f32; only the summation order differs (measured <= 1.2e-7).
* bfloat16: 5e-3 absolute. Both sides round the weights, relu(a + c) and
  every hidden activation to bf16 at the same points, but may sum the f32
  products in other orders, so an activation near a rounding boundary can
  land on the neighbouring bf16 value (a relative step of 2^-8 = 3.9e-3)
  and carry that step into the logit (measured <= 3e-8 at this size).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.ops import pair_scorer as jps
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import pair_scorer as tps

D, H, B, L, TILE = 8, 32, 3, 37, 8  # L is not a multiple of the tile
TOL = {"f32": 1e-5, "bf16": 5e-3}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _output_mlp(rng, fusion, n_layers):
    """Random output-MLP params and BN state (numpy, JAX layout), with BN
    statistics far from identity so that folding matters."""
    in_dim = {"concatenation": 2 * D}.get(fusion, 3 * D)
    layers, bns, stats = [], [], []
    for i in range(n_layers):
        fan_in = in_dim if i == 0 else H
        layers.append({"kernel": rng.uniform(-1, 1, (fan_in, H)).astype(np.float32)
                       * np.float32(np.sqrt(3.0 / fan_in))})
        bns.append({"scale": rng.uniform(0.5, 1.5, H).astype(np.float32),
                    "bias": rng.normal(0, 0.1, H).astype(np.float32)})
        stats.append({"mean": rng.normal(0, 0.1, H).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, H).astype(np.float32)})
    out = {"kernel": rng.uniform(-1, 1, (H, 1)).astype(np.float32) / np.float32(np.sqrt(H)),
           "bias": np.array([0.2], np.float32)}
    return {"layers": layers, "bns": bns, "out": out}, {"bns": stats}


def _pair(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax_tree({"t": tree})["t"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_layers", [2, 3])  # 1 and 2 hidden H x H layers
@pytest.mark.parametrize("fusion", ["concatenation", "concatenation_diff",
                                    "concatenation_prod"])
def test_tiled_matches_jax(fusion, n_layers, dtype):
    rng = np.random.default_rng(n_layers)
    p, s = _output_mlp(rng, fusion, n_layers)
    P_e = rng.normal(size=(B, D)).astype(np.float32)
    L_e = rng.normal(size=(L, D)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    (jp, tp), (js, ts) = _pair(p), _pair(s)
    j_fold = jps.fold_output_mlp(jp, js, fusion, D, dtype=jdt)
    want = np.asarray(jps.pair_logits_tiled(
        j_fold, jnp.asarray(P_e).astype(jdt), jnp.asarray(L_e).astype(jdt),
        label_tile=TILE, compute_dtype=jdt))
    t_fold = tps.fold_output_mlp(tp, ts, fusion, D, dtype=tdt)
    got = tps.pair_logits_tiled(
        t_fold, torch.from_numpy(P_e).to(tdt), torch.from_numpy(L_e).to(tdt),
        label_tile=TILE, compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (B, L)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype], rtol=0)
    assert np.std(want) > 0.05  # the check is not on near-constant logits


def test_fold_matches_jax():
    rng = np.random.default_rng(5)
    p, s = _output_mlp(rng, "concatenation_diff", 3)
    (jp, tp), (js, ts) = _pair(p), _pair(s)
    j = jps.fold_output_mlp(jp, js, "concatenation_diff", D)
    t = tps.fold_output_mlp(tp, ts, "concatenation_diff", D)
    for a, b in [(j.w1_p, t.w1_p), (j.w1_l, t.w1_l), (j.b1, t.b1), (j.w_out, t.w_out),
                 (j.b_out, t.b_out)] + [
            (x, y) for (jw, jb), (tw, tb) in zip(j.hidden, t.hidden)
            for x, y in ((jw, tw), (jb, tb))]:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    assert t.w1_prod is None and len(t.hidden) == 2


def test_similarity_matches_jax():
    rng = np.random.default_rng(2)
    P_e = rng.normal(size=(B, D)).astype(np.float32)
    L_e = rng.normal(size=(L, D)).astype(np.float32)
    want = np.asarray(jps.similarity_logits(jnp.asarray(P_e), jnp.asarray(L_e), 0.07))
    got = tps.similarity_logits(torch.from_numpy(P_e), torch.from_numpy(L_e), 0.07)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _folded(rng, hidden_width=128, n_hidden=2, prod=False):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return tps.FoldedOutputMLP(
        w1_p=t(D, hidden_width), w1_l=t(D, hidden_width), b1=t(hidden_width),
        w1_prod=t(D, hidden_width) if prod else None,
        hidden=[(t(hidden_width, hidden_width), t(hidden_width))
                for _ in range(n_hidden)],
        w_out=t(hidden_width), b_out=torch.tensor(0.0))


@pytest.mark.parametrize("case,match", [
    (dict(prod=True), "concatenation_prod"),
    (dict(n_hidden=0), "at least one hidden layer"),
    (dict(hidden_width=96), "multiple of 128"),
    (dict(dtype=torch.float32), "bfloat16"),
])
def test_kernel_refuses_what_it_does_not_take(case, match):
    """The CUDA wrapper raises on unsupported input; it never falls back."""
    rng = np.random.default_rng(0)
    case = dict(case)
    dtype = case.pop("dtype", torch.bfloat16)
    folded = _folded(rng, **case)
    P_e, L_e = torch.zeros(B, D), torch.zeros(L, D)
    with pytest.raises(ValueError, match=match):
        tps.check_kernel_inputs(folded, P_e, L_e, dtype)
    tps.check_kernel_inputs(_folded(rng), P_e, L_e, torch.bfloat16)


def test_cuda_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="CUDA device"):
        tps.pair_logits_tiled_cuda(_folded(rng), torch.zeros(B, D), torch.zeros(L, D))


def test_no_scorer_for_other_devices():
    rng = np.random.default_rng(0)
    meta = torch.zeros(B, D, device="meta")
    with pytest.raises(ValueError, match="no pair scorer"):
        tps.pair_logits_tiled(_folded(rng), meta, torch.zeros(L, D, device="meta"))
