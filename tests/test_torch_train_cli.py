"""The port's training CLI (protnote_tpu_torch/cli/main.py) against the JAX
``cli.main.run`` on the CPU.

The toy fixture is the one of tests/test_train_e2e.py: 10 GO labels, 24
training, 8 validation and 8 test sequences, a small encoder through a
patched ``load_config``.  Both CLIs start from one random JAX
``init_train_state`` saved by the JAX ``save_checkpoint`` (``--model-file``),
train 2 epochs with validation and test in float32 (``MIXED_PRECISION
False``) with label noising off (JAX's random bits cannot be matched), on the
same batches: the data pipeline is the JAX package's host-only one, seeded.

Tolerances: train and validation losses 1e-5 absolute (float32 steps that
sum in other orders, as tests/test_torch_train_step.py); F1/precision/recall
and mAP 1e-6 absolute: the logits of both sides agree to ~1e-6, so the
integer counts behind those metrics are equal unless a probability lies
within that of the decision threshold or an AUPRC bin edge (none does on
this fixture), and only float32 sums of the counts differ.  The port's
``last_epoch`` checkpoint restores in the JAX ``restore_checkpoint``, and
the JAX CLI evaluates it to the port's metrics.
"""

import json

import numpy as np
import pytest

import jax

AAS = "ACDEFGHIKLMNPQRSTVWY"
NUM_LABELS = 10
OVERRIDES = [
    "NUM_EPOCHS", "2", "TRAIN_BATCH_SIZE", "8", "VALIDATION_BATCH_SIZE", "8",
    "TEST_BATCH_SIZE", "8", "SEQUENCE_BUCKETS", "[128]",
    "EXTRACT_VOCABULARIES_FROM", "null",
    "PROTEIN_EMBEDDING_DIM", "48", "LABEL_EMBEDDING_DIM", "32",
    "LATENT_EMBEDDING_DIM", "16", "PROJECTION_HEAD_NUM_LAYERS", "2",
    "OUTPUT_MLP_NUM_LAYERS", "2", "OUTPUT_MLP_HIDDEN_DIM_SCALE_FACTOR", "2",
    "PROJECTION_HEAD_HIDDEN_DIM_SCALE_FACTOR", "2",
    "MIXED_PRECISION", "False", "ESTIMATE_MAP", "True", "DECISION_TH", "0.5",
    "LABEL_EMBEDDING_NOISING_ALPHA", "0", "LEARNING_RATE", "0.003",
]
RATES = ("seqs_per_sec", "pairs_per_sec")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from protnote_tpu.data.fasta import save_to_fasta
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.models.label_encoder import HashLabelEncoder

    root = tmp_path_factory.mktemp("toy_train")
    data_dir = root / "data"
    split_dir = data_dir / "swissprot" / "proteinfer_splits" / "random"
    split_dir.mkdir(parents=True)
    (data_dir / "embeddings").mkdir(parents=True)
    (root / "outputs").mkdir()
    rng = np.random.default_rng(0)
    labels_all = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    for name, n in (("train_GO.fasta", 24), ("dev_GO.fasta", 8), ("test_GO.fasta", 8)):
        recs = []
        for i in range(n):
            seq = "".join(rng.choice(list(AAS), int(rng.integers(20, 120))))
            labs = list(rng.choice(labels_all, size=int(rng.integers(1, 4)), replace=False))
            recs.append((seq, f"{name}{i}", labs))
        save_to_fasta(recs, str(split_dir / name))
    enc = HashLabelEncoder(dim=32)
    ids, dtypes, texts = [], [], []
    for g in labels_all:
        for dt in ("name", "label"):
            ids.append(g)
            dtypes.append(dt)
            texts.append(f"{dt} description of {g}")
    LabelEmbeddingCache.save(
        str(data_dir / "embeddings" / "frozen_label_embeddings_E5multilingual_mean.npz"),
        enc.embed(texts), ids, dtypes, texts, enc.token_counts(texts))
    return root


@pytest.fixture()
def env(toy, monkeypatch):
    """Data/output roots and the small encoder: a patched ``load_config``
    in the JAX package's config module and in the port's copy, which the
    two CLIs read."""
    from protnote_tpu.core import config as cfgmod
    from protnote_tpu_torch.core import config as tcfgmod

    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(toy / "data"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(toy / "outputs"))
    for mod in (cfgmod, tcfgmod):
        monkeypatch.setattr(mod, "load_config", _small_loader(mod.load_config))
    return toy


def _small_loader(orig_load):
    def load_small(path):
        cfg = orig_load(path)
        cfg["embed_sequences_params"].update(
            OUTPUT_CHANNELS=48, KERNEL_SIZE=5, NUM_RESNET_BLOCKS=1,
            PROTEINFER_NUM_GO_LABELS=NUM_LABELS)
        return cfg

    return load_small


def _jax_template(params):
    from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu.train.optim import make_optimizer
    from protnote_tpu.train.step import init_train_state

    pi = ProteInferConfig(input_channels=20, output_channels=48, kernel_size=5,
                          num_resnet_blocks=1, num_labels=NUM_LABELS)
    pn = ProtNoteConfig.from_params(params, protein_embedding_dim=48, label_embedding_dim=32,
                                    inference_descriptions_per_label=2)
    return pn, pi, init_protnote, init_proteinfer, init_train_state, make_optimizer


@pytest.fixture()
def start(env):
    """A random JAX train state at the CLI's shapes (output MLP He-scaled,
    so the logits spread), saved by the JAX ``save_checkpoint``."""
    from protnote_tpu.core.checkpoint import save_checkpoint
    from protnote_tpu.core.config import DEFAULT_CONFIG_PATH, load_config, override_config

    params = override_config(load_config(DEFAULT_CONFIG_PATH), OVERRIDES)["params"]
    pn, pi, init_pn, init_pi, init_ts, make_opt = _jax_template(params)
    pi_p, pi_s = init_pi(jax.random.PRNGKey(3), pi)
    pn_p, pn_s = init_pn(jax.random.PRNGKey(4), pn)
    pn_p["output_mlp"] = jax.tree_util.tree_map(lambda x: x * 4.0, pn_p["output_mlp"])
    path = env / "outputs" / "start.ckpt"
    save_checkpoint(str(path), init_ts(pn_p, pn_s, pi_p, pi_s, make_opt(params)), epoch=0)
    return str(path), params


def _run(module, name, extra):
    args = module.build_argparser().parse_args(
        ["--name", name, *extra, "--override", *OVERRIDES])
    return module.run(args)


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], (int, float)) and not k.endswith(RATES):
            assert np.isfinite(got[k]), k
            tol = 1e-5 if k.endswith("loss") else 1e-6
            assert got[k] == pytest.approx(want[k], abs=tol, rel=0), k


def test_port_training_matches_jax_cli(start, env, tmp_path):
    """2 epochs from one checkpoint: the ``train_summary`` histories (train
    loss and F1s, every validation metric) and the test metrics agree; the
    port wrote its checkpoints and reloaded the best one."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain
    from protnote_tpu.core.checkpoint import restore_checkpoint

    ckpt, params = start
    roles = ["--train-path-name", "TRAIN_DATA_PATH", "--validation-path-name",
             "VAL_DATA_PATH", "--test-paths-names", "TEST_DATA_PATH", "--model-file", ckpt]
    want = _run(jmain, "jaxrun", roles)
    out = tmp_path / "metrics.json"
    got = _run(tmain, "portrun", roles + ["--device", "cpu", "--save-val-test-metrics",
                                          "--save-val-test-metrics-file", str(out)])
    assert got["train_summary"]["epochs"] == want["train_summary"]["epochs"] == 2
    assert got["train_summary"]["best_val_metric"] == pytest.approx(
        want["train_summary"]["best_val_metric"], abs=1e-6)
    for g, w in zip(got["train_summary"]["history"], want["train_summary"]["history"]):
        _assert_metrics_close(g, w)
    h = got["train_summary"]["history"]
    assert h[1]["loss"] < h[0]["loss"]  # it learns
    _assert_metrics_close(got["test"], want["test"])
    assert json.loads(out.read_text())[-1]["metrics"]["test"]["loss"] == got["test"]["loss"]

    ckpts = {p.name.split("portrun_", 1)[1]: p
             for p in (env / "outputs" / "checkpoints").glob("*portrun_*.ckpt")}
    assert {"best_val_metric.ckpt", "best_val_loss.ckpt", "last_epoch.ckpt"} <= set(ckpts)
    # the port's checkpoint in the JAX restore, Adam moments and step included
    pn, pi, init_pn, init_pi, init_ts, make_opt = _jax_template(params)
    template = init_ts(*init_pn(jax.random.PRNGKey(0), pn), *init_pi(jax.random.PRNGKey(0), pi),
                       make_opt(params))
    restored, meta = restore_checkpoint(str(ckpts["last_epoch.ckpt"]), template)
    assert meta["epoch"] == 1 and int(restored["step"]) == 2 * 3  # 24 seqs / batch 8
    mu = jax.tree_util.tree_leaves(restored["opt_state"])
    assert any(np.abs(np.asarray(x)).max() > 0 for x in mu if np.ndim(x) > 0)

    # both CLIs evaluate the port's last checkpoint alike
    test_only = ["--test-paths-names", "TEST_DATA_PATH", "--model-file",
                 str(ckpts["last_epoch.ckpt"])]
    _assert_metrics_close(_run(tmain, "porteval", test_only + ["--device", "cpu"])["test"],
                          _run(jmain, "jaxeval", test_only)["test"])


def test_from_checkpoint_resumes_with_moments(start, env):
    """``--from-checkpoint`` on a JAX checkpoint written after one epoch of
    JAX training: the port resumes at epoch 1 with its Adam moments and ends
    where the JAX CLI's resumed run ends."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain

    ckpt, _ = start
    one = ["NUM_EPOCHS", "1"]
    roles = ["--train-path-name", "TRAIN_DATA_PATH", "--model-file", ckpt]
    args = jmain.build_argparser().parse_args(
        ["--name", "jaxone", *roles, "--override", *OVERRIDES, *one])
    jmain.run(args)
    first = next((env / "outputs" / "checkpoints").glob("*jaxone_last_epoch.ckpt"))
    resume = ["--train-path-name", "TRAIN_DATA_PATH", "--model-file", str(first),
              "--from-checkpoint", "--test-paths-names", "TEST_DATA_PATH"]
    want = _run(jmain, "jaxresume", resume)
    got = _run(tmain, "portresume", resume + ["--device", "cpu"])
    assert [m["epoch"] for m in got["train_summary"]["history"]] == [1]
    _assert_metrics_close(got["train_summary"]["history"][0],
                          want["train_summary"]["history"][0])
    _assert_metrics_close(got["test"], want["test"])
