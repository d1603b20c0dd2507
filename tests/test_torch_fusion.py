"""The port's ProtNote fusion model, eval half (protnote_tpu_torch/models/
fusion.py), against the JAX one on the same weights.

Tolerances on logits and latents of std ~1-2 (weights He-scaled):
* float32: 1e-5 absolute (JAX at Precision.HIGHEST, torch in full f32; only
  summation order differs; measured <= 3.6e-6).
* bfloat16: 2e-2 absolute. Both sides round at the same points, but may sum
  in other orders, so a latent can land one bf16 step (2^-8 relative) apart
  and move every logit of its row (measured: identical at this size).
* bfloat16 similarity: in addition a relative 2^-6. Its logits are bf16
  themselves (cosine / temperature, up to ~14): JAX and torch reduce the
  bf16 norms differently, the normalised vectors then differ by a step, and
  the output by one or two of its own steps (measured 3.1e-2 at |logit| ~5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import fusion as jfu
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models.convert import from_jax_tree

B, L, K, P_DIM, L_DIM = 3, 11, 2, 24, 16
TOL = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(protein_embedding_dim=P_DIM, label_embedding_dim=L_DIM, latent_dim=8,
             projection_head_num_layers=2, projection_head_hidden_dim_scale_factor=2,
             output_mlp_num_layers=3, output_mlp_hidden_dim_scale_factor=4,
             label_tile=4)


def _model(fusion="concatenation", k=K, dtype="f32", seed=0):
    """JAX-initialised ProtNote with random BN statistics, as numpy."""
    jdt, tdt = DTYPES[dtype]
    jcfg = jfu.ProtNoteConfig(**SMALL, feature_fusion=fusion,
                              inference_descriptions_per_label=k, compute_dtype=jdt)
    tcfg = tfu.ProtNoteConfig(**SMALL, feature_fusion=fusion,
                              inference_descriptions_per_label=k, compute_dtype=tdt)
    params, state = jfu.init_protnote(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed)

    def randomize(bns_p, bns_s):
        for i, s in enumerate(bns_s):
            n = s["mean"].shape[0]
            bns_p[i] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
            bns_s[i] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}

    for head in ("W_p", "W_l", "output_mlp"):
        if head in params:
            randomize(params[head]["bns"], state[head]["bns"])
            # He-scale the default init, so logits spread over O(1)
            for lin in params[head]["layers"] + [params[head].get("out", {})]:
                if "kernel" in lin:
                    lin["kernel"] = lin["kernel"] * np.float32(6 ** 0.5)
    return jcfg, tcfg, params, state


def _inputs(seed=1, k=K):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, P_DIM)).astype(np.float32),
            rng.normal(size=(L * k, L_DIM)).astype(np.float32))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_label_latents_match_jax(dtype):
    jcfg, tcfg, params, state = _model(dtype=dtype)
    _, labels = _inputs()
    want = jfu.compute_label_latents(_jax(params), _jax(state), jnp.asarray(labels), jcfg)
    t = from_jax_tree({"p": params, "s": state})
    got = tfu.compute_label_latents(t["p"], t["s"], torch.from_numpy(labels), tcfg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (L * K, 8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


def test_ensemble_logits_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 4, size=(B, L * 3)).astype(np.float32)
    logits[0, :3] = 40.0  # saturates: the clip at 1e-7 decides
    want = np.asarray(jfu.ensemble_logits(jnp.asarray(logits), 3))
    got = tfu.ensemble_logits(torch.from_numpy(logits), 3)
    assert got.shape == (B, L)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-6)


def test_additive_attention_matches_jax():
    """Pooling "all": (L, T, D) token states with a padded token mask."""
    rng = np.random.default_rng(4)
    p = {"kernel": rng.normal(size=(L_DIM, 1)).astype(np.float32),
         "bias": np.array([0.1], np.float32)}
    hidden = rng.normal(size=(L, 6, L_DIM)).astype(np.float32)
    mask = (np.arange(6)[None, :] < rng.integers(1, 7, size=L)[:, None]).astype(np.float32)
    want = np.asarray(jfu.additive_attention(_jax(p), jnp.asarray(hidden), jnp.asarray(mask)))
    got = tfu.additive_attention(from_jax_tree({"p": p})["p"], torch.from_numpy(hidden),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["f32"], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fusion,k", [("concatenation", 2), ("concatenation_diff", 1),
                                      ("similarity", 2)])
def test_protnote_forward_eval_matches_jax(fusion, k, dtype):
    jcfg, tcfg, params, state = _model(fusion, k, dtype)
    seqs, labels = _inputs(k=k)
    want, _ = jfu.protnote_forward(_jax(params), _jax(state), jnp.asarray(seqs),
                                   jnp.asarray(labels), jcfg, train=False)
    t = from_jax_tree({"p": params, "s": state})
    got, new_state = tfu.protnote_forward(t["p"], t["s"], torch.from_numpy(seqs),
                                          torch.from_numpy(labels), tcfg)
    assert got.shape == (B, L)
    assert new_state["output_mlp" if "output_mlp" in t["s"] else "W_p"] is not None
    rtol = 2.0 ** -6 if (fusion, dtype) == ("similarity", "bf16") else 0.0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=rtol)
    # the latents fast path gives the same logits
    lat = tfu.compute_label_latents(t["p"], t["s"], torch.from_numpy(labels), tcfg)
    fast, _ = tfu.protnote_forward(t["p"], t["s"], torch.from_numpy(seqs), None, tcfg,
                                   label_latents=lat)
    torch.testing.assert_close(fast, got, rtol=0, atol=0)


@pytest.mark.parametrize("what,match", [
    ("train", "training slice"), ("dense", "training slice"),
])
def test_later_slices_raise(what, match):
    """What the port leaves out: output-MLP dropout in training (it needs
    the materialised dense scorer), PAIR_BACKEND=dense."""
    jcfg, tcfg, params, state = _model()
    seqs, labels = _inputs()
    t = from_jax_tree({"p": params, "s": state})
    kw = {}
    if what == "train":
        kw["train"] = True
        tcfg = tfu.ProtNoteConfig(**{**tcfg.__dict__, "dropout": 0.1})
    else:
        tcfg = tfu.ProtNoteConfig(**{**tcfg.__dict__, "pair_backend": what})
    with pytest.raises(NotImplementedError, match=match):
        tfu.protnote_forward(t["p"], t["s"], torch.from_numpy(seqs),
                             torch.from_numpy(labels), tcfg, **kw)


@pytest.mark.parametrize("static", [True, False])
def test_int8_forward_matches_jax(static):
    """PAIR_BACKEND=tiled_int8 in evaluation: static scales from
    ``calibrate_int8`` on the same batch (1e-5 relative), then the logits
    of the whole forward (heads, quantize_folded on every call, the int8
    scorer with a ragged last tile, the K=2 ensemble) within 1e-4: float32
    towers that sum in other orders feed the scorer, so a code on a
    rounding edge may move (none does here)."""
    jcfg, tcfg, params, state = _model()
    seqs, labels = _inputs()
    t = from_jax_tree({"p": params, "s": state})
    jp, js = _jax(params), _jax(state)
    jscales = tscales = None
    if static:
        jscales = jfu.calibrate_int8(jp, js, jnp.asarray(seqs), jcfg,
                                     label_embeddings=jnp.asarray(labels))
        tscales = tfu.calibrate_int8(t["p"], t["s"], torch.from_numpy(seqs), tcfg,
                                     label_embeddings=torch.from_numpy(labels))
        np.testing.assert_allclose(tscales, jscales, rtol=1e-5, atol=0)
    jcfg8 = jfu.ProtNoteConfig(**{**jcfg.__dict__, "pair_backend": "tiled_int8",
                                  "int8_act_scales": jscales})
    tcfg8 = tfu.ProtNoteConfig(**{**tcfg.__dict__, "pair_backend": "tiled_int8",
                                  "int8_act_scales": jscales})
    want, _ = jfu.protnote_forward(jp, js, jnp.asarray(seqs), jnp.asarray(labels), jcfg8)
    got, _ = tfu.protnote_forward(t["p"], t["s"], torch.from_numpy(seqs),
                                  torch.from_numpy(labels), tcfg8)
    assert got.shape == (B, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    bf16, _ = tfu.protnote_forward(t["p"], t["s"], torch.from_numpy(seqs),
                                   torch.from_numpy(labels), tcfg)
    assert np.abs(got.numpy() - bf16.numpy()).max() > 0  # the int8 path ran
    cfg_p = tfu.ProtNoteConfig.from_params({"PAIR_BACKEND": "tiled_int8",
                                            "INT8_ACT_SCALES": [0.5, 0.25]})
    assert cfg_p.int8_act_scales == (0.5, 0.25) and cfg_p.pair_backend == "tiled_int8"


def test_from_params_matches_jax():
    params = {"LATENT_EMBEDDING_DIM": 64, "OUTPUT_MLP_NUM_LAYERS": 2,
              "OUTPUT_NEURON_PROBABILITY_BIAS": 0.01, "FEATURE_FUSION": "concatenation_diff",
              "SUPCON_TEMP": 0.1, "PAIR_BACKEND": "tiled"}
    j = jfu.ProtNoteConfig.from_params(params, label_tile=128)
    t = tfu.ProtNoteConfig.from_params(params, label_tile=128)
    for name in t.__dataclass_fields__:
        if name != "compute_dtype":
            assert getattr(t, name) == pytest.approx(getattr(j, name)), name
    assert t.output_mlp_hidden_dim == j.output_mlp_hidden_dim
    with pytest.raises(ValueError, match="PAIR_BACKEND"):
        tfu.ProtNoteConfig.from_params({"PAIR_BACKEND": "pallas"})


def test_init_protnote_tree_matches_jax_layout():
    jcfg, tcfg, params, state = _model()
    tp, ts = tfu.init_protnote(torch.Generator().manual_seed(0), tcfg)
    jshapes = jax.tree_util.tree_map(np.shape, (params, state))
    tshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), (tp, ts))
    assert jax.tree_util.tree_structure(jshapes) == jax.tree_util.tree_structure(tshapes)
    assert jax.tree_util.tree_leaves(jshapes) == jax.tree_util.tree_leaves(tshapes)
