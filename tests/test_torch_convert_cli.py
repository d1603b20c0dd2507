"""The port's checkpoint conversion CLI (protnote_tpu_torch/cli/
convert_checkpoint.py) against the JAX ``cli.convert_checkpoint`` on one
reference-format ``.pt`` and one ProteInfer TF pickle, on the CPU.

Both files are read back through the JAX package's ``restore_checkpoint``
(into a JAX ``init_train_state`` template, or ``{"params", "state"}`` for the
encoder) and through the raw msgpack trees: equal trees, leaf for leaf,
exactly (conversion moves bits, it computes nothing), and equal metadata
(epoch, best metric, source, kind).  A ``.pt`` without an embedded encoder
gets a random one on each side (torch's and JAX's generators differ): there
the ProtNote weights, the optimizer state and the encoder's shapes agree.
"""

import pickle

import numpy as np
import pytest
import torch

import jax

from protnote_tpu.core.checkpoint import restore_checkpoint as jax_restore
from protnote_tpu.core.config import DEFAULT_CONFIG_PATH, load_config, override_config
from protnote_tpu.models import convert as jconvert
from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state
from protnote_tpu_torch.core.checkpoint import read_checkpoint
from test_torch_checkpoint import PI, PN, _torch_proteinfer_sd, _torch_protnote_sd

SMALL = ["OUTPUT_CHANNELS", str(PI["output_channels"]), "KERNEL_SIZE", str(PI["kernel_size"]),
         "NUM_RESNET_BLOCKS", str(PI["num_resnet_blocks"]),
         "PROTEINFER_NUM_GO_LABELS", str(PI["num_labels"]),
         "LABEL_EMBEDDING_DIM", str(PN["label_embedding_dim"]),
         "LATENT_EMBEDDING_DIM", str(PN["latent_dim"]),
         "PROJECTION_HEAD_NUM_LAYERS", str(PN["projection_head_num_layers"]),
         "PROJECTION_HEAD_HIDDEN_DIM_SCALE_FACTOR",
         str(PN["projection_head_hidden_dim_scale_factor"]),
         "OUTPUT_MLP_NUM_LAYERS", str(PN["output_mlp_num_layers"]),
         "OUTPUT_MLP_HIDDEN_DIM_SCALE_FACTOR", str(PN["output_mlp_hidden_dim_scale_factor"])]


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict/list/tuple tree (None and
    scalars as they are)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree, key=str):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) or hasattr(tree, "_fields"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree) if hasattr(tree, "shape") else tree}


def _assert_same(got, want, skip=()):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w) and len(w) > 10
    for k in w:
        if any(k.startswith(s) for s in skip):
            assert np.shape(g[k]) == np.shape(w[k]), k
            continue
        if hasattr(w[k], "shape"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g[k] == w[k], k


def _convert_both(kind, src, tmp_path):
    from protnote_tpu.cli import convert_checkpoint as jcli
    from protnote_tpu_torch.cli import convert_checkpoint as tcli

    out = {}
    for side, cli in (("jax", jcli), ("port", tcli)):
        out[side] = str(tmp_path / f"{side}.ckpt")
        cli.main([kind, "--input", src, "--output", out[side], "--override", *SMALL])
    return out["jax"], out["port"]


def _template(params):
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(0), ProteInferConfig(**PI))
    pn = ProtNoteConfig.from_params(params, protein_embedding_dim=PI["output_channels"])
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(1), pn)
    return init_train_state(pn_p, pn_s, pi_p, pi_s, make_optimizer(params))


@pytest.mark.parametrize("encoder", [True, False])
def test_protnote_pt_converts_as_the_jax_cli(tmp_path, encoder):
    g = torch.Generator().manual_seed(5)
    sd = _torch_protnote_sd(g)
    if encoder:
        sd.update({f"sequence_encoder.{k}": v for k, v in _torch_proteinfer_sd(g).items()})
    src = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 7,
                "best_val_metric": 0.3}, src)
    jpath, tpath = _convert_both("protnote", src, tmp_path)
    skip = () if encoder else ("/enc_params",)
    (jraw, jmeta), (traw, tmeta) = read_checkpoint(jpath), read_checkpoint(tpath)
    _assert_same(traw, jraw, skip)
    for k in ("epoch", "best_val_metric", "source", "kind"):
        assert tmeta[k] == jmeta[k], k
    assert tmeta["epoch"] == 7 and tmeta["kind"] == "protnote"
    params = override_config(load_config(DEFAULT_CONFIG_PATH), SMALL)["params"]
    template = _template(params)
    jts, _ = jax_restore(jpath, template)
    tts, _ = jax_restore(tpath, template)
    _assert_same(jax.tree_util.tree_map(np.asarray, tts),
                 jax.tree_util.tree_map(np.asarray, jts), skip)


def test_proteinfer_pickle_converts_as_the_jax_cli(tmp_path):
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(2), ProteInferConfig(**PI))
    rng = np.random.default_rng(2)
    values = [np.asarray(c[k]) + rng.normal(0, 0.1, np.shape(c[k])).astype(np.float32)
              for c, k, _ in jconvert._proteinfer_slots(pi_p, pi_s)]
    src = str(tmp_path / "weights.pkl")
    with open(src, "wb") as fh:
        pickle.dump({f"v{i}": v for i, v in enumerate(values)}, fh)
    jpath, tpath = _convert_both("proteinfer", src, tmp_path)
    (jraw, jmeta), (traw, tmeta) = read_checkpoint(jpath), read_checkpoint(tpath)
    _assert_same(traw, jraw)
    assert {k: tmeta[k] for k in ("epoch", "source", "kind")} == \
        {k: jmeta[k] for k in ("epoch", "source", "kind")}
    template = {"params": pi_p, "state": pi_s}
    jtree, _ = jax_restore(jpath, template)
    ttree, _ = jax_restore(tpath, template)
    _assert_same(jax.tree_util.tree_map(np.asarray, ttree),
                 jax.tree_util.tree_map(np.asarray, jtree))
