"""The port's ProteInfer encoder (protnote_tpu_torch/models/proteinfer.py)
against the JAX one on the same weights, eval mode.

Tolerances on the pooled embedding (values of order 0.1-1):
* float32: 1e-5 absolute. JAX convs run at Precision.HIGHEST, torch's in
  full f32 (TF32 is switched off for f32 compute); only summation order
  differs (measured <= 1.2e-7).
* bfloat16: 5e-3 absolute. Both round every conv output, bias add, BN output
  and residual to bf16 at the same points, but may run the conv sums in
  other orders, so an activation can land one bf16 step (2^-8 = 3.9e-3
  relative) apart (measured: identical at this size).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import proteinfer as jpi
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree

PAD = 20
TOL = {"f32": 1e-5, "bf16": 5e-3}
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _weights(n_blocks, seed=0):
    """JAX-initialised encoder with random BN affine and statistics."""
    cfg = jpi.ProteInferConfig(output_channels=24, kernel_size=5,
                               num_resnet_blocks=n_blocks, num_labels=5)
    params, state = jpi.init_proteinfer(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed)
    for bp, bs in zip(params["blocks"], state["blocks"]):
        for name in ("bn1", "bn2"):
            n = bp[name]["scale"].shape[0]
            bp[name] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
            bs[name] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    return cfg, params, state


def _ids(rng, B=4, T=40):
    """Residue ids with padding, the pad id inside a sequence (where an
    unknown residue lands after encoding), out-of-range ids and a row of
    length 0."""
    lengths = np.array([T, 23, 7, 0], np.int32)[:B]
    ids = rng.integers(0, PAD, size=(B, T)).astype(np.int8)
    ids[1, 5] = PAD
    ids[2, 3] = 27
    for r, n in enumerate(lengths):
        ids[r, n:] = PAD
    return ids, lengths


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_blocks", [1, 2])
def test_embed_from_ids_matches_jax(n_blocks, dtype):
    cfg, params, state = _weights(n_blocks)
    jdt, tdt = DTYPES[dtype]
    jcfg = jpi.ProteInferConfig(**{**cfg.__dict__, "compute_dtype": jdt})
    tcfg = tpi.ProteInferConfig(output_channels=24, kernel_size=5,
                                num_resnet_blocks=n_blocks, num_labels=5,
                                compute_dtype=tdt)
    ids, lengths = _ids(np.random.default_rng(1))
    want, _ = jpi.embed_from_ids(jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, state),
                                 jnp.asarray(ids), jnp.asarray(lengths), jcfg)
    tree = from_jax_tree({"p": params, "s": state})
    got, _ = tpi.embed_from_ids(tree["p"], tree["s"], torch.from_numpy(ids),
                                torch.from_numpy(lengths), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, 24)
    assert torch.isfinite(got).all()
    assert float(got[3].abs().max()) == 0.0  # length 0: zero, not NaN
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[dtype], rtol=0)
    # the plain chain the kernels are held to on the card is this one on the CPU
    onehot = tpi.one_hot_sequences(torch.from_numpy(ids), 20, dtype=tcfg.runtime_dtype)
    ref, _ = tpi.proteinfer_embed_reference(tree["p"], tree["s"], onehot,
                                            torch.from_numpy(lengths), tcfg)
    assert torch.equal(ref, got)


def test_one_hot_pad_and_out_of_range_ids_are_zero_rows():
    ids = torch.tensor([[0, 19, PAD, 27, -1]])
    onehot = tpi.one_hot_sequences(ids, 20)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(ids.numpy()), 20))
    np.testing.assert_array_equal(onehot.numpy(), want)
    assert onehot[0, 2:].sum() == 0 and onehot[0, :2].sum() == 2


def test_conv_kernels_convert_to_torch_layout():
    """Conv kernels cross unchanged: the port keeps the JAX (k, cin, cout)
    layout, which K7's kernels read."""
    cfg, params, state = _weights(1)
    tree = from_jax_tree({"p": params})["p"]
    k_jax = params["blocks"][0]["conv_dilated"]["kernel"]  # (k, cin, cout)
    k_t = tree["blocks"][0]["conv_dilated"]["kernel"]
    assert tuple(k_t.shape) == k_jax.shape
    np.testing.assert_array_equal(k_t.numpy(), k_jax)
    assert tuple(tree["output"]["kernel"].shape) == params["output"]["kernel"].shape


def test_init_proteinfer_shapes_and_seed():
    cfg = tpi.ProteInferConfig(output_channels=24, kernel_size=5, num_resnet_blocks=2,
                               num_labels=5)
    p1, s1 = tpi.init_proteinfer(torch.Generator().manual_seed(3), cfg)
    p2, _ = tpi.init_proteinfer(torch.Generator().manual_seed(3), cfg)
    assert tuple(p1["conv1"]["kernel"].shape) == (5, 20, 24)
    assert tuple(p1["blocks"][1]["conv_dilated"]["kernel"].shape) == (5, 24, 12)
    assert tuple(p1["blocks"][1]["conv_1x1"]["kernel"].shape) == (1, 12, 24)
    assert torch.equal(p1["blocks"][1]["conv_1x1"]["kernel"],
                       p2["blocks"][1]["conv_1x1"]["kernel"])
    assert torch.equal(s1["blocks"][0]["bn1"]["var"], torch.ones(24))


def _leaf_pairs(jtree, ttree, path=""):
    """(path, JAX array, port tensor) of every leaf of two parallel trees."""
    if isinstance(jtree, dict):
        return [x for k in sorted(jtree) for x in _leaf_pairs(jtree[k], ttree[k], f"{path}/{k}")]
    if isinstance(jtree, (list, tuple)):
        return [x for i, (a, b) in enumerate(zip(jtree, ttree))
                for x in _leaf_pairs(a, b, f"{path}/{i}")]
    return [(path, jtree, ttree)]


@pytest.mark.parametrize("em", [None, [1, 1, 0, 1], [0, 1, 1, 1]])
def test_embed_from_ids_train_mode_matches_jax(em):
    """``train=True`` against JAX in float32: the pooled embedding, the new
    BatchNorm state and the gradients of every encoder parameter under one
    cotangent, with rows of lengths 40, 23, 7 and 0, the pad id inside a
    sequence and an example mask that drops the length-7 row (the count
    falls to 3 rows) or the longest one (the count's max length falls to
    23).  Tolerance 1e-5 of each tensor's largest |value|."""
    cfg, params, state = _weights(2)
    tcfg = tpi.ProteInferConfig(output_channels=24, kernel_size=5, num_resnet_blocks=2,
                                num_labels=5)
    ids, lengths = _ids(np.random.default_rng(4))
    cot = np.random.default_rng(5).normal(size=(4, 24)).astype(np.float32)
    em_np = None if em is None else np.asarray(em, np.float32)
    enc = {k: v for k, v in params.items() if k != "output"}

    def f(p):
        pooled, new = jpi.embed_from_ids(p, jax.tree_util.tree_map(jnp.asarray, state),
                                         jnp.asarray(ids), jnp.asarray(lengths), cfg, train=True,
                                         example_mask=None if em is None else jnp.asarray(em_np))
        return jnp.sum(pooled * cot), (pooled, new)

    grads, (want, want_state) = jax.grad(f, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, enc))
    tree = from_jax_tree({"p": enc, "s": state})
    leaves = [t for _, _, t in _leaf_pairs(enc, tree["p"])]
    for t in leaves:
        t.requires_grad_(True)
    got, got_state = tpi.embed_from_ids(tree["p"], tree["s"], torch.from_numpy(ids),
                                        torch.from_numpy(lengths), tcfg, train=True,
                                        example_mask=None if em is None
                                        else torch.from_numpy(em_np))
    (got * torch.from_numpy(cot)).sum().backward()

    def close(a, b, name):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-5 * np.abs(b).max(), rtol=0,
                                   err_msg=name)

    close(got.detach().numpy(), want, "pooled")
    assert float(got.detach()[3].abs().max()) == 0.0  # length 0: zero, not NaN
    for path, a, b in _leaf_pairs(want_state, got_state):
        close(b.numpy(), a, path)
    assert not np.allclose(np.asarray(want_state["blocks"][0]["bn1"]["mean"]),
                           state["blocks"][0]["bn1"]["mean"])
    for path, g, t in _leaf_pairs(grads, tree["p"]):
        close(t.grad.numpy(), g, path)
