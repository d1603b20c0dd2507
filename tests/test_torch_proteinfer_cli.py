"""The port's standalone ProteInfer evaluation (``proteinfer_forward`` and
protnote_tpu_torch/cli/test_proteinfer.py) against the JAX package's, on
the CPU.

``proteinfer_forward`` (embedding + the float32 classifier head) on the
same weights: float32 to 1e-5 absolute (only the order of float32 sums
differs: JAX's convs run at Precision.HIGHEST, the port's with TF32 off),
bfloat16 to 5e-3 absolute (tests/test_torch_proteinfer.py's tolerance: an
activation can land one bf16 step apart; the head is float32 on both sides).

Both ``test_proteinfer`` CLIs read one TF pickle written by the test (the
positional layout of the JAX reader, random BatchNorm statistics) and a
12-sequence test FASTA over 10 labels, the head 14 labels wide: metric
dicts to 1e-6 absolute, after checking that no probability lies within
1e-6 of the threshold and no two probabilities of a label lie within 1e-6
of each other (the counts and the exact AP's ranks are then equal, and only
float sums of them differ by rounding).  ``--save-prediction-results``:
the same files, float16 logits to one float16 step, labels exactly.
"""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import convert as jconvert
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import masked_conv as k7

AAS = "ACDEFGHIKLMNPQRSTVWY"
PAD = 20
HEAD = 14  # the classifier head's labels; the dataset has 10 of them
DATA_LABELS = [f"GO:{i:07d}" for i in range(10)]
SMALL = ["OUTPUT_CHANNELS", "24", "KERNEL_SIZE", "5", "NUM_RESNET_BLOCKS", "2",
         "PROTEINFER_NUM_GO_LABELS", str(HEAD)]


def _weights(seed=0):
    """A JAX-initialised encoder with a 14-label head and random BatchNorm
    affines and statistics (numpy leaves)."""
    cfg = jpi.ProteInferConfig(output_channels=24, kernel_size=5, num_resnet_blocks=2,
                               num_labels=HEAD)
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
    params["output"]["kernel"] = params["output"]["kernel"] * np.float32(4.0)
    return cfg, params, state


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 5e-3)])
def test_proteinfer_forward_matches_jax(dtype, tol):
    cfg, params, state = _weights()
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = jpi.ProteInferConfig(**{**cfg.__dict__, "compute_dtype": jdt})
    tcfg = tpi.ProteInferConfig(output_channels=24, kernel_size=5, num_resnet_blocks=2,
                                num_labels=HEAD, compute_dtype=tdt)
    rng = np.random.default_rng(1)
    lengths = np.array([40, 23, 7, 0], np.int32)
    ids = rng.integers(0, PAD, size=(4, 40)).astype(np.int8)
    for r, n in enumerate(lengths):
        ids[r, n:] = PAD
    want, _ = jpi.proteinfer_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, state),
        jpi.one_hot_sequences(jnp.asarray(ids), 20, jdt or jnp.float32), jnp.asarray(lengths),
        jcfg)
    tree = from_jax_tree({"p": params, "s": state})
    onehot = tpi.one_hot_sequences(torch.from_numpy(ids), 20, tdt or torch.float32)
    got, new_state = tpi.proteinfer_forward(tree["p"], tree["s"], onehot,
                                            torch.from_numpy(lengths), tcfg)
    plain, _ = tpi.proteinfer_forward_reference(tree["p"], tree["s"], onehot,
                                                torch.from_numpy(lengths), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, HEAD)
    assert new_state is tree["s"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)
    assert torch.equal(got, plain)  # the CPU dispatch is the plain chain
    assert float(np.abs(np.asarray(want)).max()) > 0.5  # the head spreads the logits


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_card_dispatch_dtypes(dtype, grad, monkeypatch):
    """What the card's K7 dispatch takes: bf16 and float32, with a gradient
    (training: the conv's ``autograd.Function``, whose backward launches the
    dtype's dX and dW kernels) or without (the dtype's forward wrapper, as
    the eval chain of ``test_proteinfer`` runs it); another dtype raises.
    The input is a stub of a CUDA tensor (device, dtype, requires_grad); the
    routes taken are recorded, nothing runs."""
    seen = []
    monkeypatch.setattr(k7, "_MaskedConv", types.SimpleNamespace(
        apply=lambda *a: seen.append("autograd")))
    for name in ("masked_conv_cuda", "masked_conv_f32_cuda"):
        monkeypatch.setattr(k7, name, lambda *a, _n=name, **kw: seen.append(_n))
    rng = np.random.default_rng(0)
    p = {"kernel": torch.from_numpy(rng.normal(size=(3, 8, 6)).astype(np.float32)),
         "bias": torch.zeros(6)}
    stub = types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype, requires_grad=grad)
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            k7.masked_conv(stub, p, torch.tensor([4, 2]), 1)
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            k7.check_compute_dtype(dtype)
        return
    k7.check_compute_dtype(dtype)
    k7.masked_conv(stub, p, torch.tensor([4, 2]), 1)
    forward = "masked_conv_f32_cuda" if dtype == torch.float32 else "masked_conv_cuda"
    assert seen == ["autograd" if grad else forward]


def test_float32_kernel_layout_and_plan():
    """The float32 conv's B operand (W[j]^T's three bf16 pieces, (3, taps,
    C_out rounded up to 112, C_in to 64), zero-padded, summing to the
    float32 weight exactly) and its plan on 128 x 112 tiles: every tile
    with a valid first row once, the rows it skips counted."""
    w = torch.randn(9, 550, 1100)
    lay = k7.conv_weight_layout_f32(w)
    assert lay.shape == (3, 9, 1120, 576) and lay.is_contiguous()
    assert lay.dtype == torch.bfloat16
    total = (lay[0].float() + lay[1].float()) + lay[2].float()
    assert torch.equal(total[:, :1100, :550], w.transpose(1, 2)) and not total[:, 1100:].any()
    assert not total[:, :, 550:].any()
    lengths = np.array([512, 300, 129, 128, 1, 0])
    plan = k7.conv_tile_plan(lengths, 512, 9, 3, 550, False, k7.F32_BLOCK_M, k7.F32_BLOCK_N)
    ntiles, mtiles = 5, 4
    rows = [(c // ntiles) // mtiles * 100 + (c // ntiles) % mtiles for c in plan]
    want_tiles = {b * 100 + m for b, L in enumerate(lengths) for m in range(mtiles)
                  if m * 128 < L}
    assert set(rows) == want_tiles and len(plan) == len(want_tiles) * ntiles
    assert k7.skipped_rows(lengths, 512, 128) == 0 + 128 + 256 + 384 + 384 + 512


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The test FASTA (12 sequences, 1-3 of 10 labels each), a TF pickle of
    :func:`_weights` in the JAX reader's positional layout, the head's label
    order (the dataset's 10 labels shuffled among 4 it does not have) and a
    parenthood JSON."""
    from protnote_tpu.data.fasta import save_to_fasta

    root = tmp_path_factory.mktemp("proteinfer_cli")
    split = root / "data" / "swissprot" / "proteinfer_splits" / "random"
    split.mkdir(parents=True)
    rng = np.random.default_rng(7)
    recs = []
    for i in range(12):
        seq = "".join(rng.choice(list(AAS), int(rng.integers(20, 120))))
        labs = list(rng.choice(DATA_LABELS[:8], size=int(rng.integers(1, 4)), replace=False))
        recs.append((seq, f"T{i}", labs))
    save_to_fasta(recs, str(split / "test_GO.fasta"))
    cfg, params, state = _weights(3)
    values = [np.asarray(c[k]) for c, k, _ in jconvert._proteinfer_slots(params, state)]
    with open(root / "weights.pkl", "wb") as fh:
        pickle.dump({f"v{i}": v for i, v in enumerate(values)}, fh)
    head = DATA_LABELS + [f"GO:{i:07d}" for i in range(100, 104)]
    head = [head[j] for j in rng.permutation(len(head))]
    (root / "head_vocab.json").write_text(json.dumps(head))
    (root / "parenthood.json").write_text(json.dumps(
        {DATA_LABELS[3]: [DATA_LABELS[0], DATA_LABELS[1]], DATA_LABELS[4]: [DATA_LABELS[0]],
         DATA_LABELS[5]: [DATA_LABELS[0], DATA_LABELS[2]], DATA_LABELS[6]: [DATA_LABELS[2]]}))
    return root


@pytest.fixture()
def env(toy, monkeypatch):
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(toy / "data"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(toy / "outputs"))
    return toy


OPTIONS = {
    "plain": [],
    "represented": ["--only-represented-labels"],
    "vocab": ["--vocab-json", "{root}/head_vocab.json"],
    "vocab_represented": ["--vocab-json", "{root}/head_vocab.json", "--only-represented-labels"],
    "normalized": ["--normalize-probabilities", "--parenthood-json", "{root}/parenthood.json"],
}


def _cli_args(env, option, extra=()):
    opts = [a.format(root=env) for a in OPTIONS[option]]
    return ["--weights", str(env / "weights.pkl"), "--batch-size", "5", "--override", *SMALL,
            *opts, *extra]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_port_cli_matches_jax_cli(env, capsys, option):
    from protnote_tpu.cli import test_proteinfer as jcli
    from protnote_tpu_torch.cli import test_proteinfer as tcli

    want = jcli.main(_cli_args(env, option))
    capsys.readouterr()
    got = tcli.main(_cli_args(env, option, ["--device", "cpu"]))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == pytest.approx(got)
    assert set(got) == set(want) and "map_macro" in got and "f1_micro" in got
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], abs=1e-6, rel=0), k
    assert 0 < got["map_micro"] < 1


def test_probabilities_stay_off_the_edges(env):
    """The premise of the 1e-6 comparison: the port's probabilities on the
    toy set lie farther than 1e-6 from the threshold and from each other
    within a label."""
    from protnote_tpu_torch.cli._model_setup import proteinfer_config
    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.data.dataset import DatasetConfig, ProteinDataset
    from protnote_tpu_torch.models.convert import proteinfer_from_tf_pickle

    cfg = proteinfer_config({"OUTPUT_CHANNELS": 24, "KERNEL_SIZE": 5, "NUM_RESNET_BLOCKS": 2,
                             "PROTEINFER_NUM_GO_LABELS": HEAD})
    params, state = proteinfer_from_tf_pickle(str(env / "weights.pkl"), cfg)
    ds = ProteinDataset(str(env / "data" / "swissprot" / "proteinfer_splits" / "random"
                            / "test_GO.fasta"), DatasetConfig(dataset_type="test"))
    probs = []
    for batch in BucketBatcher(ds, 5, return_label_multihots=False):
        onehot = tpi.one_hot_sequences(torch.from_numpy(batch.aa_ids), 20)
        logits, _ = tpi.proteinfer_forward(params, state, onehot,
                                           torch.from_numpy(batch.lengths), cfg)
        probs.append(torch.sigmoid(logits).numpy()[np.asarray(batch.example_mask, bool)])
    probs = np.concatenate(probs)
    assert probs.shape == (12, HEAD)
    assert np.abs(probs - 0.5).min() > 1e-6
    gaps = np.diff(np.sort(probs, axis=0), axis=0)
    assert gaps.min() > 1e-6


def test_save_prediction_results_match(env, tmp_path, capsys):
    import pandas as pd

    from protnote_tpu.cli import test_proteinfer as jcli
    from protnote_tpu_torch.cli import test_proteinfer as tcli

    save = ["--save-prediction-results", "--name", "pi"]
    jcli.main(_cli_args(env, "vocab_represented", save + ["--output-dir", str(tmp_path / "j")]))
    tcli.main(_cli_args(env, "vocab_represented",
                        save + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]))
    capsys.readouterr()
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 2
    for name in names:
        want = pd.read_parquet(tmp_path / "j" / name)
        got = pd.read_parquet(tmp_path / "t" / name)
        assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
        a, b = got.to_numpy(), want.to_numpy()
        if "logits" in name:
            step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
            assert np.all(np.abs(a - b) <= step.astype(np.float32)), name
        else:
            np.testing.assert_array_equal(a, b)


def test_normalize_needs_parenthood(env):
    from protnote_tpu_torch.cli import test_proteinfer as tcli

    with pytest.raises(SystemExit, match="parenthood"):
        tcli.main(["--weights", str(env / "weights.pkl"), "--normalize-probabilities",
                   "--device", "cpu", "--override", *SMALL])
