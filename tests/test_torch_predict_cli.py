"""The port's batched-inference CLI (protnote_tpu_torch/cli/predict.py)
against the JAX ``cli.predict`` on one PNTPU1 checkpoint, on the CPU.

A toy environment (6 GO labels with two descriptions each in the label
cache, a small encoder through ``--override``, ``MIXED_PRECISION False``)
and one random JAX ``init_train_state`` written by the JAX
``save_checkpoint``; both CLIs score the same FASTA with ``--model-file``.

Tolerances: the shards' names (after the run's timestamp), row split,
index and columns exactly; the float16 logits within one float16 step of
each other (the float32 forward passes agree to ~1e-6 and sum in other
orders, so a logit may round to the neighbouring float16 value).  The int8
run (``PAIR_BACKEND tiled_int8``, scales auto-calibrated on the first batch)
to the same step: the int8 codes on both sides come from the same float32
towers, as in tests/test_torch_eval_cli.py's int8 comparison.
"""

import glob
import json
import os
import re

import numpy as np
import pytest

import jax

AAS = "ACDEFGHIKLMNPQRSTVWY"
LABELS = [f"GO:{i:07d}" for i in range(6)]
TINY = [
    "OUTPUT_CHANNELS", "32", "KERNEL_SIZE", "5", "NUM_RESNET_BLOCKS", "1",
    "PROTEINFER_NUM_GO_LABELS", "6", "LABEL_EMBEDDING_DIM", "16",
    "LATENT_EMBEDDING_DIM", "8", "PROJECTION_HEAD_NUM_LAYERS", "2",
    "OUTPUT_MLP_NUM_LAYERS", "2", "OUTPUT_MLP_HIDDEN_DIM_SCALE_FACTOR", "2",
    "PROJECTION_HEAD_HIDDEN_DIM_SCALE_FACTOR", "2", "MIXED_PRECISION", "False",
    "SEQUENCE_BUCKETS", "[128]",
]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """Two FASTAs (11 sequences, every third unlabeled; 7 sequences with no
    labels at all), the label cache and a JAX checkpoint at TINY's shapes
    (output-MLP weights scaled so the logits spread over O(1))."""
    from protnote_tpu.core.checkpoint import save_checkpoint
    from protnote_tpu.core.config import DEFAULT_CONFIG_PATH, load_config, override_config
    from protnote_tpu.data.fasta import save_to_fasta
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu.models.label_encoder import HashLabelEncoder
    from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu.train.optim import make_optimizer
    from protnote_tpu.train.step import init_train_state

    root = tmp_path_factory.mktemp("predict")
    (root / "data" / "embeddings").mkdir(parents=True)
    rng = np.random.default_rng(0)
    recs = []
    for i in range(11):
        seq = "".join(rng.choice(list(AAS), int(rng.integers(15, 60))))
        recs.append((seq, f"Q{i}", [] if i % 3 == 0 else [LABELS[i % 6]]))
    save_to_fasta(recs, str(root / "query.fasta"))
    save_to_fasta([("".join(rng.choice(list(AAS), int(rng.integers(10, 90)))), f"U{i}", [])
                   for i in range(7)], str(root / "unlabeled.fasta"))
    enc = HashLabelEncoder(dim=16)
    ids, dts, txts = [], [], []
    for g in LABELS:
        for dt in ("name", "label"):
            ids.append(g), dts.append(dt), txts.append(f"{dt} {g}")
    LabelEmbeddingCache.save(
        str(root / "data" / "embeddings" / "frozen_label_embeddings_E5multilingual_mean.npz"),
        enc.embed(txts), ids, dts, txts, enc.token_counts(txts))
    params = override_config(load_config(DEFAULT_CONFIG_PATH), TINY)["params"]
    pi = ProteInferConfig(input_channels=20, output_channels=32, kernel_size=5,
                          num_resnet_blocks=1, num_labels=6)
    pn = ProtNoteConfig.from_params(params, protein_embedding_dim=32, label_embedding_dim=16,
                                    inference_descriptions_per_label=2)
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(3), pi)
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(4), pn)
    pn_p["output_mlp"] = jax.tree_util.tree_map(lambda x: x * 4.0, pn_p["output_mlp"])
    save_checkpoint(str(root / "random.ckpt"),
                    init_train_state(pn_p, pn_s, pi_p, pi_s, make_optimizer(params)), epoch=1)
    return root


@pytest.fixture()
def env(toy, monkeypatch):
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(toy / "data"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(toy / "outputs"))
    return toy


def _args(env, fasta, name, out, overrides=()):
    return ["--fasta", str(env / f"{fasta}.fasta"), "--name", name, "--output-dir", str(out),
            "--model-file", str(env / "random.ckpt"), "--rows-per-shard", "6",
            "--batch-size", "4", "--override", *TINY, *overrides]


def _shards(out):
    """{shard suffix (the run's timestamp dropped): frame}."""
    import pandas as pd

    paths = sorted(glob.glob(str(out / "predict_logits_*.parquet")))
    return {re.sub(r"^predict_logits_\d{4}-\d\d-\d\d_\d\d-\d\d-\d\d_", "",
                   os.path.basename(p)): pd.read_parquet(p) for p in paths}


def _assert_same_shards(got, want):
    assert list(got) == list(want) and len(got) >= 1
    for name in want:
        g, w = got[name], want[name]
        assert list(g.index) == list(w.index), name
        assert list(g.columns) == list(w.columns), name
        a, b = g.to_numpy(), w.to_numpy()
        assert a.dtype == b.dtype == np.float32
        step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16)).astype(np.float32)
        assert np.all(np.abs(a - b) <= step), (name, float(np.abs(a - b).max()))


def _run_both(env, tmp_path, capsys, fasta, overrides=()):
    from protnote_tpu.cli import predict as jpredict
    from protnote_tpu_torch.cli import predict as tpredict

    jpredict.main(_args(env, fasta, "p", tmp_path / "jax", overrides))
    jsummary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    summary = tpredict.main(_args(env, fasta, "p", tmp_path / "port", overrides)
                            + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    return jsummary, summary


@pytest.mark.parametrize("fasta", ["query", "unlabeled"])
def test_port_predict_writes_the_jax_shards(env, tmp_path, capsys, fasta):
    """The same shards from both CLIs: 11 rows split 8 + 3 at 6 rows a shard
    (whole batches of 4), the sequence ids as the index, one column a label
    of the cache's vocabulary; the summary line's counts equal."""
    jsummary, summary = _run_both(env, tmp_path, capsys, fasta)
    got, want = _shards(tmp_path / "port"), _shards(tmp_path / "jax")
    _assert_same_shards(got, want)
    n = 11 if fasta == "query" else 7
    assert summary["sequences"] == jsummary["sequences"] == n
    assert summary["labels"] == jsummary["labels"] == len(LABELS)
    assert set(summary) == set(jsummary) and summary["seqs_per_sec"] > 0
    assert [len(f) for f in got.values()] == ([8, 3] if n == 11 else [7])
    assert list(next(iter(got.values())).columns) == LABELS


def test_port_predict_int8_matches_jax(env, tmp_path, capsys):
    """``PAIR_BACKEND tiled_int8``: both CLIs calibrate static scales on the
    first batch; the shards agree to one float16 step and differ from the
    float32 scorer's."""
    from protnote_tpu_torch.cli import predict as tpredict

    _run_both(env, tmp_path, capsys, "query", ["PAIR_BACKEND", "tiled_int8"])
    got = _shards(tmp_path / "port")
    _assert_same_shards(got, _shards(tmp_path / "jax"))
    tpredict.main(_args(env, "query", "tf", tmp_path / "f32") + ["--device", "cpu"])
    capsys.readouterr()
    f32 = _shards(tmp_path / "f32")
    a = np.concatenate([f.to_numpy() for f in got.values()])
    b = np.concatenate([f.to_numpy() for f in f32.values()])
    assert not np.array_equal(a, b)
    assert np.max(np.abs(1 / (1 + np.exp(-a)) - 1 / (1 + np.exp(-b)))) < 5e-2


@pytest.mark.parametrize("extra,match", [
    (["--mesh-label", "2"], "mesh"),
    (["--distributed"], "multi-process"),
    (["--coordinator-address", "localhost:1234"], "multi-process"),
])
def test_port_predict_refuses_several_cards(env, tmp_path, extra, match):
    from protnote_tpu_torch.cli import predict as tpredict

    with pytest.raises(NotImplementedError, match=match):
        tpredict.main(_args(env, "query", "x", tmp_path) + ["--device", "cpu", *extra])
    assert not glob.glob(str(tmp_path / "*.parquet"))


def test_scoring_generator_and_writer(env, tmp_path):
    """``score_batches`` yields float16 rows of the real sequences at the
    valid columns, whole batches; ``write_shards`` writes them as the CLI
    does (a shard per 5 rows or more: 8, 3 with batches of 4)."""
    from protnote_tpu_torch.cli import predict as tpredict

    args = tpredict.build_argparser().parse_args(
        _args(env, "query", "g", tmp_path) + ["--device", "cpu"])
    _, _, _, ds, trainer, batcher, label_matrix, vocab = tpredict.build_predictor(args)
    batches = list(tpredict.score_batches(trainer, batcher, label_matrix))
    assert [len(ids) for _, ids, _ in batches] == [4, 4, 3]
    for logits, ids, cols in batches:
        assert logits.dtype == np.float16 and logits.shape == (len(ids), len(LABELS))
        assert list(cols) == list(range(len(LABELS)))
    assert sorted(i for _, ids, _ in batches for i in ids) == sorted(ds.sequence_ids)
    written = tpredict.write_shards(iter(batches), vocab, str(tmp_path / "w"), "run", 5)
    assert written == 11
    assert sorted(os.listdir(tmp_path / "w")) == [
        "predict_logits_run_00000.parquet", "predict_logits_run_00001.parquet"]
