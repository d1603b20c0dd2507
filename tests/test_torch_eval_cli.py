"""The port's evaluation CLI (protnote_tpu_torch/cli/main.py) against the
JAX ``cli.main.run`` on the same PNTPU1 checkpoint, on the CPU.

The toy fixture is the one of tests/test_train_e2e.py: 10 GO labels, a
small encoder through a patched ``load_config``, two descriptions per label.
Both CLIs load one random ``init_train_state`` checkpoint written by the
JAX ``save_checkpoint`` and evaluate the test split with
``ESTIMATE_MAP True`` and ``MIXED_PRECISION False`` (float32 throughout).

Tolerances: logits 1e-5 absolute (float32 forward passes that sum in other
orders); metric dicts 1e-6 absolute, after the test has checked that no
probability lies within 1e-6 of a histogram bin edge or of the decision
threshold (the integer counts are then equal, and only float32 sums of
them differ by rounding).
"""

import json

import numpy as np
import pytest

import jax

AAS = "ACDEFGHIKLMNPQRSTVWY"
NUM_LABELS = 10
OVERRIDES = [
    "TEST_BATCH_SIZE", "8", "SEQUENCE_BUCKETS", "[128]",
    "EXTRACT_VOCABULARIES_FROM", "null",
    "PROTEIN_EMBEDDING_DIM", "48", "LABEL_EMBEDDING_DIM", "32",
    "LATENT_EMBEDDING_DIM", "16", "PROJECTION_HEAD_NUM_LAYERS", "2",
    "OUTPUT_MLP_NUM_LAYERS", "2", "OUTPUT_MLP_HIDDEN_DIM_SCALE_FACTOR", "2",
    "PROJECTION_HEAD_HIDDEN_DIM_SCALE_FACTOR", "2",
    "MIXED_PRECISION", "False", "ESTIMATE_MAP", "True", "DECISION_TH", "0.5",
]
RATES = ("seqs_per_sec", "pairs_per_sec")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from protnote_tpu.data.fasta import save_to_fasta
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.models.label_encoder import HashLabelEncoder

    root = tmp_path_factory.mktemp("toy_eval")
    data_dir = root / "data"
    split_dir = data_dir / "swissprot" / "proteinfer_splits" / "random"
    split_dir.mkdir(parents=True)
    (data_dir / "embeddings").mkdir(parents=True)
    (root / "outputs").mkdir()
    rng = np.random.default_rng(0)
    labels_all = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    recs = []
    for i in range(12):
        seq = "".join(rng.choice(list(AAS), int(rng.integers(20, 120))))
        labs = list(rng.choice(labels_all, size=int(rng.integers(1, 4)), replace=False))
        recs.append((seq, f"test{i}", labs))
    save_to_fasta(recs, str(split_dir / "test_GO.fasta"))
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


@pytest.fixture()
def checkpoint(env):
    """A random JAX ``init_train_state`` at the CLI's shapes, saved by the
    JAX ``save_checkpoint``.  Output-MLP weights are He-scaled so the
    logits spread over O(1) and the metrics are not degenerate."""
    from protnote_tpu.core.checkpoint import save_checkpoint
    from protnote_tpu.core.config import (
        DEFAULT_CONFIG_PATH, load_config, override_config)
    from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu.train.optim import make_optimizer
    from protnote_tpu.train.step import init_train_state

    params = override_config(load_config(DEFAULT_CONFIG_PATH), OVERRIDES)["params"]
    pi = ProteInferConfig(input_channels=20, output_channels=48, kernel_size=5,
                          num_resnet_blocks=1, num_labels=NUM_LABELS)
    pn = ProtNoteConfig.from_params(params, protein_embedding_dim=48,
                                    label_embedding_dim=32,
                                    inference_descriptions_per_label=2)
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(3), pi)
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(4), pn)
    pn_p["output_mlp"] = jax.tree_util.tree_map(lambda x: x * 4.0, pn_p["output_mlp"])
    ts = init_train_state(pn_p, pn_s, pi_p, pi_s, make_optimizer(params))
    path = env / "outputs" / "random.ckpt"
    save_checkpoint(str(path), ts, epoch=3, best_val_metric=0.25)
    return str(path)


def _args(module, extra):
    return module.build_argparser().parse_args(extra)


def _cli_args(ckpt, extra=(), overrides=()):
    return ["--test-paths-names", "TEST_DATA_PATH", "--model-file", ckpt,
            "--override", *OVERRIDES, *overrides, *extra]


@pytest.mark.parametrize("decision_th", ["0.5", "null"])
def test_port_cli_matches_jax_cli(checkpoint, env, tmp_path, decision_th):
    """``DECISION_TH null`` on test sets alone: AP metrics only, as the
    JAX CLI (the threshold sweep needs a validation set)."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain

    out = tmp_path / "metrics.json"
    th = ["DECISION_TH", decision_th]
    jax_metrics = jmain.run(_args(jmain, _cli_args(checkpoint, overrides=th)))["test"]
    port_metrics = tmain.run(_args(tmain, _cli_args(checkpoint, overrides=th, extra=[
        "--device", "cpu", "--save-val-test-metrics",
        "--save-val-test-metrics-file", str(out)])))["test"]
    assert set(port_metrics) == set(jax_metrics) and "loss" in port_metrics
    for k in set(port_metrics) - set(RATES):
        assert np.isfinite(port_metrics[k]), k
        assert port_metrics[k] == pytest.approx(jax_metrics[k], abs=1e-6, rel=0), k
    assert port_metrics["seqs_per_sec"] > 0 and port_metrics["pairs_per_sec"] > 0
    assert 0 < port_metrics["map_macro"] < 1
    if decision_th == "null":
        assert set(port_metrics) == {"map_micro", "map_macro", "loss", *RATES}
    else:
        assert 0 < port_metrics["f1_micro"] < 1
    saved = json.loads(out.read_text())
    assert saved[-1]["metrics"]["test"]["map_micro"] == port_metrics["map_micro"]


@pytest.mark.parametrize("calibrate", ["True", "False"])
def test_port_cli_int8_matches_jax_cli(checkpoint, env, calibrate):
    """``PAIR_BACKEND tiled_int8`` on the test set: static scales
    calibrated on the first batch (``INT8_CALIBRATE True``, the default) or
    dynamic per-row scales.  Metrics to 1e-6, as the bf16 comparison above:
    the int8 codes on both sides come from the same float32 towers, and the
    toy logits stay off the bin edges (checked below for the bf16 path)."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain

    int8 = ["PAIR_BACKEND", "tiled_int8", "INT8_CALIBRATE", calibrate]
    jax_metrics = jmain.run(_args(jmain, _cli_args(checkpoint, overrides=int8)))["test"]
    port_metrics = tmain.run(_args(tmain, _cli_args(checkpoint, overrides=int8,
                                                    extra=["--device", "cpu"])))["test"]
    bf16_metrics = tmain.run(_args(tmain, _cli_args(checkpoint, extra=["--device", "cpu"])))["test"]
    assert set(port_metrics) == set(jax_metrics)
    for k in set(port_metrics) - set(RATES):
        assert np.isfinite(port_metrics[k]), k
        assert port_metrics[k] == pytest.approx(jax_metrics[k], abs=1e-6, rel=0), k
    # int8 is close to, but not the same as, the float32 scorer
    assert port_metrics["loss"] != bf16_metrics["loss"]
    assert port_metrics["loss"] == pytest.approx(bf16_metrics["loss"], abs=1e-2)


def test_logits_match_and_stay_off_bin_edges(checkpoint, env):
    """The same checkpoint through both trainers' eval steps on every test
    batch: logits to 1e-5, and no probability near a bin edge or 0.5 (the
    premise of the 1e-6 metric comparison above)."""
    import jax.numpy as jnp

    import protnote_tpu_torch.cli.main as tmain
    from protnote_tpu.data.batching import BucketBatcher
    from protnote_tpu.data.dataset import DatasetConfig, ProteinDataset
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu.train.optim import make_optimizer
    from protnote_tpu.train.step import batch_to_device_dict as jbatch
    from protnote_tpu.train.step import init_train_state
    from protnote_tpu.train.trainer import Trainer as JaxTrainer
    from protnote_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
    from protnote_tpu_torch.cli._model_setup import build_models
    from protnote_tpu_torch.train.step import batch_to_device_dict
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    config, _, _ = tmain.load_setup(_args(tmain, _cli_args(checkpoint)))
    params = config["params"]
    cache = LabelEmbeddingCache.load(config["LABEL_EMBEDDING_PATH"],
                                     config["LABEL_EMBEDDING_INDEX_PATH"])
    ds = ProteinDataset(config["dataset_paths"]["test"][0],
                        DatasetConfig.from_params(params, "test"),
                        label_embedding_cache=cache)
    pi_cfg, pn_cfg, ts = build_models(config, cache.dim, num_aa=20, seed=0,
                                      gate_pretrained=True)
    port = Trainer(ts, pi_cfg, pn_cfg, TrainerConfig.from_params(params), device="cpu")
    port.load(checkpoint)
    jpi = ProteInferConfig(input_channels=20, output_channels=48, kernel_size=5,
                           num_resnet_blocks=1, num_labels=NUM_LABELS)
    jpn = ProtNoteConfig.from_params(params, protein_embedding_dim=48,
                                     label_embedding_dim=32,
                                     inference_descriptions_per_label=2,
                                     compute_dtype=jnp.float32)
    jts = init_train_state(*init_protnote(jax.random.PRNGKey(0), jpn),
                           *init_proteinfer(jax.random.PRNGKey(0), jpi),
                           make_optimizer(params))
    jtr = JaxTrainer(jts, jpi, jpn, None, make_optimizer(params),
                     JaxTrainerConfig.from_params(params))
    jtr.load(checkpoint)

    batcher = BucketBatcher(ds, 8, buckets=(128,), descriptions_per_label=2,
                            device_label_gather=True)
    jm, tm = jtr._label_matrix_for(ds), port._label_matrix_for(ds)
    n = 0
    for batch in batcher:
        ja = jtr._place(jbatch(batch), batch, jm)
        ja = jtr._swap_in_latents(ja, jtr._label_latents(ja))
        want = np.asarray(jtr._eval_step(jtr.ts, ja)["logits"])
        ta = port._place(batch_to_device_dict(batch, "cpu"), tm)
        ta = port._swap_in_latents(ta, port._label_latents(ta))
        got = port._eval_step(port.ts, ta)["logits"].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        p = 1.0 / (1.0 + np.exp(-want[batch.example_mask].astype(np.float64)))
        edge = np.abs(p * 512 - np.round(p * 512)) / 512
        assert edge.min() > 1e-6 and np.abs(p - 0.5).min() > 1e-6
        assert want.std() > 0.1
        n += int(batch.example_mask.sum())
    assert n == 12


@pytest.mark.parametrize("extra, overrides, match", [
    (["--train-path-name", "TRAIN_DATA_PATH", "--validation-path-name", "VAL_DATA_PATH"],
     ["TRAIN_SEQUENCE_ENCODER", "True"], "training"),
    (["--validation-path-name", "VAL_DATA_PATH"], ["DECISION_TH", "null"], "sweep"),
    (["--train-path-name", "TRAIN_DATA_PATH"], ["TRAIN_LABEL_SAMPLE_SIZE", "4"], "training"),
    (["--profile-dir", "prof"], [], "training"),
    (["--save-prediction-results"], [], "ROADMAP"),
    (["--save-embeddings"], [], "ROADMAP"),
    (["--only-represented-labels"], [], "ROADMAP"),
    ([], ["NORMALIZE_PROBABILITIES", "True"], "ROADMAP"),
    ([], ["ESTIMATE_MAP", "False"], "ExactAUPRC"),
    ([], ["LABEL_ENCODER_NUM_TRAINABLE_LAYERS", "1"], "text tower"),
    ([], ["PAIR_BACKEND", "dense"], "dense"),
    (["--mesh-label", "2"], [], "multi-GPU"),
    ([], ["DEVICE_RESIDENT_LABEL_EMBEDDINGS", "False"], "resident"),
])
def test_unported_branches_raise(checkpoint, env, extra, overrides, match):
    import protnote_tpu_torch.cli.main as tmain

    args = _args(tmain, _cli_args(checkpoint, extra=["--device", "cpu", *extra],
                                  overrides=overrides))
    with pytest.raises(NotImplementedError, match=match):
        tmain.run(args)


def test_unported_evaluate_arguments_raise(checkpoint, env):
    """The threshold sweep and the host-logits branches of ``evaluate``,
    and label-subsampled batchers."""
    import protnote_tpu_torch.cli.main as tmain
    from protnote_tpu_torch.cli._model_setup import build_models
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    class _Ds:
        num_labels = NUM_LABELS

    config, _, _ = tmain.load_setup(_args(tmain, _cli_args(checkpoint)))
    pi_cfg, pn_cfg, ts = build_models(config, 32, num_aa=20)
    tr = Trainer(ts, pi_cfg, pn_cfg, TrainerConfig(estimate_map=True), device="cpu")
    fake = type("B", (), {"ds": _Ds(), "label_sample_size": 4})()
    with pytest.raises(NotImplementedError, match="sweep"):
        tr.evaluate(fake, threshold_sweep=np.array([0.5], np.float32))
    with pytest.raises(NotImplementedError, match="save_results"):
        tr.evaluate(fake, save_results=True)
    with pytest.raises(NotImplementedError, match="label-subsampled"):
        tr.evaluate(fake)
    with pytest.raises(NotImplementedError, match="ExactAUPRC"):
        Trainer(tr.ts, tr.pi_cfg, tr.pn_cfg, TrainerConfig(estimate_map=False),
                device="cpu").evaluate(fake)
