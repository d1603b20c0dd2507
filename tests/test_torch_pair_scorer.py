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


def _output_mlp(rng, fusion, n_layers, H=H):
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
    (dict(hidden_width=96), "multiple of 128"),
    (dict(dtype=torch.float32), "bfloat16"),
])
def test_kernel_refuses_what_it_does_not_take(case, match):
    """The CUDA wrapper raises on unsupported input; it never falls back.
    The kernels take bfloat16 (``csrc/pair_scorer.cu``) and float32
    (``csrc/pair_scorer_f32.cu``): the float32 case is taken, and a third
    dtype (float16) raises naming the two."""
    rng = np.random.default_rng(0)
    case = dict(case)
    dtype = case.pop("dtype", torch.bfloat16)
    folded = _folded(rng, **case)
    P_e, L_e = torch.zeros(B, D), torch.zeros(L, D)
    if dtype == torch.float32:
        tps.check_kernel_inputs(folded, P_e, L_e, torch.float32)
        dtype = torch.float16
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


# K1's launch geometry (ops/pair_scorer.py:launch_plan): what the CUDA
# wrapper launches, checked here on shapes alone
PLAN_CASES = [  # (B, L, H, target_rows, SMs)
    (32, 64204, 3072, 16384, 132),  # the serving batch: 126 chunks of 512 labels
    (32, 64204, 3072, 8192, 132),
    (1, 37, 128, 16384, 132),  # one chunk of 37 labels padded to 128 rows
    (5, 300, 384, 640, 132),  # 3 chunks of 128 labels, the last ragged; BN 128
    (3, 1000, 256, 10**6, 8),  # one chunk, more tiles than blocks
    (7, 129, 640, 896, 132),  # ragged by one label
]


@pytest.mark.parametrize("B,L,H,target,sms", PLAN_CASES)
def test_launch_plan_geometry(B, L, H, target, sms):
    plan = tps.launch_plan(B, L, H, 2, num_sms=sms, target_rows=target)
    assert plan.block_n == (256 if H % 256 == 0 else 128)
    assert plan.chunk % tps.BLOCK_M == 0
    covered = np.zeros(L, np.int64)
    for ch in plan.chunks:
        covered[ch.l0 : ch.l0 + ch.nl] += 1
        assert 0 < ch.nl <= plan.chunk and ch.nl_pad % tps.BLOCK_M == 0
        assert ch.nl <= ch.nl_pad < ch.nl + tps.BLOCK_M
        # every 128-row tile of rows b * nl_pad + l lies within one sequence
        starts = np.arange(ch.tiles_m) * tps.BLOCK_M
        assert np.array_equal(starts // ch.nl_pad, (starts + tps.BLOCK_M - 1) // ch.nl_pad)
        assert ch.tiles_m * tps.BLOCK_M == B * ch.nl_pad
        assert ch.tiles_n * plan.block_n == H
        assert ch.grid == min(sms, ch.tiles_m * ch.tiles_n)
    assert (covered == 1).all()  # each label in exactly one chunk
    assert [ch.l0 for ch in plan.chunks] == sorted(ch.l0 for ch in plan.chunks)
    assert plan.workspace_rows == B * max(ch.nl_pad for ch in plan.chunks)
    launches = plan.launches()
    assert len(launches) == 2 * len(plan.chunks)
    assert [(i, m) for _, i, m in launches[:2]] == [(0, 1), (1, 2)]


def test_launch_plan_serving_batch():
    """The serving batch: 256 labels a chunk, 251 chunks (the last 204
    labels, padded to 256), 768 tiles of 128 x 256 on 132 blocks."""
    plan = tps.launch_plan(32, 64204, 3072, 2)
    assert plan.chunk == 256 and len(plan.chunks) == 251
    assert (plan.chunks[-1].nl, plan.chunks[-1].nl_pad) == (204, 256)
    assert plan.chunks[0].tiles_m * plan.chunks[0].tiles_n == 768
    assert plan.chunks[0].grid == 132 and len(plan.launches()) == 502
    assert plan.workspace_rows == 8192


@pytest.mark.parametrize("n_hidden,modes", [(1, [3]), (2, [1, 2]), (3, [1, 0, 2])])
def test_launch_plan_modes(n_hidden, modes):
    plan = tps.launch_plan(2, 300, 256, n_hidden, target_rows=256)
    assert len(plan.chunks) == 3
    assert [m for _, _, m in plan.launches()] == modes * 3
    assert [i for _, i, _ in plan.launches()] == list(range(n_hidden)) * 3


@pytest.mark.parametrize("H", [96, 200])
def test_launch_plan_refuses_width(H):
    with pytest.raises(ValueError, match="multiple of 128"):
        tps.launch_plan(2, 10, H, 2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_layers", [2, 3, 4])  # 1-3 hidden layers: every launch mode
def test_plan_layout_matches_jax(n_layers, dtype):
    """The plain chain over K1's padded chunk layout (rows b * nl_pad + l, c
    rows past L zero, padded rows left out of the logits) against JAX's
    ``pair_logits_tiled`` on the same numpy inputs; L is not a multiple of
    the chunk, so the last chunk is ragged and padded."""
    width, Lc = 128, 300
    rng = np.random.default_rng(10 + n_layers)
    p, s = _output_mlp(rng, "concatenation_diff", n_layers, H=width)
    P_e = rng.normal(size=(B, D)).astype(np.float32)
    L_e = rng.normal(size=(Lc, D)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    (jp, tp), (js, ts) = _pair(p), _pair(s)
    j_fold = jps.fold_output_mlp(jp, js, "concatenation_diff", D, dtype=jdt)
    want = np.asarray(jps.pair_logits_tiled(
        j_fold, jnp.asarray(P_e).astype(jdt), jnp.asarray(L_e).astype(jdt),
        label_tile=64, compute_dtype=jdt))
    plan = tps.launch_plan(B, Lc, width, n_layers - 1, target_rows=B * 128)
    assert [(ch.nl, ch.nl_pad) for ch in plan.chunks] == [(128, 128), (128, 128), (44, 128)]
    t_fold = tps.fold_output_mlp(tp, ts, "concatenation_diff", D, dtype=tdt)
    got = tps.pair_logits_plan_reference(
        t_fold, torch.from_numpy(P_e).to(tdt), torch.from_numpy(L_e).to(tdt), plan,
        compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (B, Lc)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype], rtol=0)
    assert np.std(want) > 0.05
