"""The port's evaluation CLI (protnote_tpu_torch/cli/main.py) against the
JAX ``cli.main.run`` on the same PNTPU1 checkpoint, on the CPU.

The toy fixture is the one of tests/test_train_e2e.py: 10 GO labels, a
small encoder through a patched ``load_config``, two descriptions per label.
Both CLIs load one random ``init_train_state`` checkpoint written by the
JAX ``save_checkpoint`` and evaluate the test split with
``ESTIMATE_MAP True`` and ``MIXED_PRECISION False`` (float32 throughout).

The host branches (``ESTIMATE_MAP False``, the decision-threshold sweep on
a validation set, prediction and embedding export, represented-label
slicing, GO-DAG normalisation with a small parenthood JSON) run through both
CLIs on the same checkpoint too, as does ``cli/test_models.py``.

Tolerances: logits 1e-5 absolute (float32 forward passes that sum in other
orders); metric dicts 1e-6 absolute, after the test has checked that no
probability lies within 1e-6 of a histogram bin edge, of the decision
threshold or of a swept threshold, and that no two probabilities of a label
lie within 1e-6 (the integer counts and the exact AP's ranks are then
equal, and only float sums of them differ by rounding); the chosen threshold
and its score exactly; saved float16 logits to one float16 step (2^-10
relative: the float32 logits agree to 1e-5, and one may round to the
neighbouring float16 value); saved float16 embeddings likewise.
"""

import glob
import json
import os

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
    for name, n in (("test", 12), ("dev", 10)):
        recs = []
        for i in range(n):
            seq = "".join(rng.choice(list(AAS), int(rng.integers(20, 120))))
            labs = list(rng.choice(labels_all, size=int(rng.integers(1, 4)), replace=False))
            recs.append((seq, f"{name}{i}", labs))
        save_to_fasta(recs, str(split_dir / f"{name}_GO.fasta"))
    # GO-DAG parenthood (child -> ancestors) for NORMALIZE_PROBABILITIES
    (data_dir / "vocabularies").mkdir()
    (data_dir / "vocabularies" / "parenthood_jul_2024.json").write_text(json.dumps(
        {labels_all[3]: [labels_all[0], labels_all[1]], labels_all[4]: [labels_all[0]],
         labels_all[5]: [labels_all[0], labels_all[2]], labels_all[6]: [labels_all[2]]}))
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


def test_port_cli_dense_matches_jax_cli(checkpoint, env):
    """``PAIR_BACKEND dense`` on the test set: the materialised scorer with
    eval BatchNorm on every pair row, through both CLIs; metrics to 1e-6 as
    the comparisons above, and within 1e-4 of the folded scorer's (the same
    function, the BatchNorm applied after the rows' product, not folded
    into the weights)."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain

    dense = ["PAIR_BACKEND", "dense"]
    jax_metrics = jmain.run(_args(jmain, _cli_args(checkpoint, overrides=dense)))["test"]
    port_metrics = tmain.run(_args(tmain, _cli_args(checkpoint, overrides=dense,
                                                    extra=["--device", "cpu"])))["test"]
    tiled = tmain.run(_args(tmain, _cli_args(checkpoint, extra=["--device", "cpu"])))["test"]
    assert set(port_metrics) == set(jax_metrics)
    for k in set(port_metrics) - set(RATES):
        assert np.isfinite(port_metrics[k]), k
        assert port_metrics[k] == pytest.approx(jax_metrics[k], abs=1e-6, rel=0), k
    assert port_metrics["loss"] == pytest.approx(tiled["loss"], abs=1e-4)


def _trainers(checkpoint):
    """(config, the port's CPU trainer, the JAX trainer, cache) on the
    checkpoint, at the CLI's toy shapes, with the validation split."""
    import jax.numpy as jnp

    import protnote_tpu_torch.cli.main as tmain
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu.train.optim import make_optimizer
    from protnote_tpu.train.step import init_train_state
    from protnote_tpu.train.trainer import Trainer as JaxTrainer
    from protnote_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
    from protnote_tpu_torch.cli._model_setup import build_models
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    config, _, _ = tmain.load_setup(_args(tmain, _cli_args(
        checkpoint, extra=["--validation-path-name", "VAL_DATA_PATH"])))
    params = config["params"]
    cache = LabelEmbeddingCache.load(config["LABEL_EMBEDDING_PATH"],
                                     config["LABEL_EMBEDDING_INDEX_PATH"])
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
    return config, port, jtr, cache


def test_find_optimal_threshold_matches_jax(checkpoint, env):
    """``Trainer.find_optimal_threshold`` (the sweep-only pass, no metrics)
    on the validation split: the JAX trainer's threshold and score, with
    the CLI's thresholds and with an unsorted set holding a duplicate."""
    from protnote_tpu.data.batching import BucketBatcher
    from protnote_tpu.data.dataset import DatasetConfig, ProteinDataset

    config, port, jtr, cache = _trainers(checkpoint)
    ds = ProteinDataset(config["dataset_paths"]["validation"][0],
                        DatasetConfig.from_params(config["params"], "validation"),
                        label_embedding_cache=cache)
    batcher = BucketBatcher(ds, 8, buckets=(128,), descriptions_per_label=2,
                            device_label_gather=True)
    for thresholds in (None, np.array([0.7, 0.3, 0.45, 0.3, 0.05], np.float32)):
        got = port.find_optimal_threshold(batcher, thresholds)
        assert got == jtr.find_optimal_threshold(batcher, thresholds)
        assert 0 < got[1] <= 1


EVAL_LAYOUTS = {
    # (batcher arguments, GridBatcher tile, ESTIMATE_MAP)
    "fixed_device": (dict(label_sample_size=4), None, True),
    "fixed_host": (dict(label_sample_size=4), None, False),
    "shuffled": (dict(label_sample_size=4, shuffle_labels=True), None, True),
    "in_batch": (dict(in_batch_sampling=True), None, True),
    "grid": ({}, 4, True),
    "shipped_device": (dict(device_label_gather=False), None, True),
    "shipped_host": (dict(device_label_gather=False), None, False),
}


@pytest.mark.parametrize("layout", sorted(EVAL_LAYOUTS))
def test_subset_evaluation_matches_jax(checkpoint, env, layout):
    """``Trainer.evaluate`` on the validation split through label-subset
    batchers (a fixed sampled prefix on the device and on the host; shuffled,
    in-batch and grid subsets that change every batch, which K3 scatters
    through its ``cols`` path) and with the label embeddings shipped in
    every batch (``DEVICE_RESIDENT_LABEL_EMBEDDINGS False``): the metric
    dicts of the JAX and the port's trainers on the same batches."""
    from protnote_tpu.data.batching import BucketBatcher, GridBatcher
    from protnote_tpu.data.dataset import DatasetConfig, ProteinDataset

    config, port, jtr, cache = _trainers(checkpoint)
    kwargs, tile, estimate = EVAL_LAYOUTS[layout]
    port.cfg.estimate_map = jtr.cfg.estimate_map = estimate
    ds = ProteinDataset(config["dataset_paths"]["validation"][0],
                        DatasetConfig.from_params(config["params"], "validation"),
                        label_embedding_cache=cache)
    kwargs = dict(dict(device_label_gather=True), **kwargs)

    def batcher():
        b = BucketBatcher(ds, 4, buckets=(128,), descriptions_per_label=2, seed=3, **kwargs)
        return GridBatcher(b, tile) if tile else b

    got = port.evaluate(batcher(), data_split_name="validation")["metrics"]
    want = jtr.evaluate(batcher(), data_split_name="validation")["metrics"]
    assert set(got) == set(want) and "map_macro" in got
    for k, v in want.items():
        if not k.endswith(RATES):
            assert got[k] == pytest.approx(v, abs=1e-6, rel=0), k
    widths = {len(b.label_indices) for b in batcher()}
    if layout.startswith(("fixed", "shuffled", "grid")):
        assert max(widths) == 4 < ds.num_labels
    if layout == "in_batch":
        assert len(widths) > 1  # the label count changes from batch to batch


def test_logits_match_and_stay_off_bin_edges(checkpoint, env):
    """The same checkpoint through both trainers' eval steps on every test
    and validation batch: logits to 1e-5, and no probability near a bin
    edge, 0.5 or a swept threshold, nor within 1e-6 of another probability
    of its label (the premise of the 1e-6 metric comparisons)."""
    from protnote_tpu.data.batching import BucketBatcher
    from protnote_tpu.data.dataset import DatasetConfig, ProteinDataset
    from protnote_tpu.train.step import batch_to_device_dict as jbatch
    from protnote_tpu_torch.train.step import batch_to_device_dict

    config, port, jtr, cache = _trainers(checkpoint)
    params = config["params"]
    swept = np.arange(0.01, 1.0, 0.01, dtype=np.float32).astype(np.float64)
    for role, n_seqs in (("test", 12), ("validation", 10)):
        ds = ProteinDataset(config["dataset_paths"][role][0],
                            DatasetConfig.from_params(params, "test"),
                            label_embedding_cache=cache)
        batcher = BucketBatcher(ds, 8, buckets=(128,), descriptions_per_label=2,
                                device_label_gather=True)
        jm, tm = jtr._label_matrix_for(ds), port._label_matrix_for(ds)
        n, probs = 0, []
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
            assert np.abs(p[..., None] - swept).min() > 1e-6
            assert want.std() > 0.1
            probs.append(p)
            n += int(batch.example_mask.sum())
        assert n == n_seqs
        p = np.sort(np.concatenate(probs), axis=0)
        assert np.diff(p, axis=0).min() > 1e-6


@pytest.mark.parametrize("extra, overrides, match", [
    (["--profile-dir", "prof"], [], "training"),
    (["--use-wandb"], [], "training"),
    (["--mesh-label", "2"], [], "multi-GPU"),
])
def test_unported_branches_raise(checkpoint, env, extra, overrides, match):
    import protnote_tpu_torch.cli.main as tmain

    args = _args(tmain, _cli_args(checkpoint, extra=["--device", "cpu", *extra],
                                  overrides=overrides))
    with pytest.raises(NotImplementedError, match=match):
        tmain.run(args)


def test_unported_evaluate_arguments_raise(checkpoint, env):
    """The combinations the JAX ``evaluate`` refuses raise its
    ``ValueError``s."""
    import protnote_tpu_torch.cli.main as tmain
    from protnote_tpu_torch.cli._model_setup import build_models
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    class _Ds:
        num_labels = NUM_LABELS
        represented_vocabulary_mask = np.ones(NUM_LABELS, bool)

    config, _, _ = tmain.load_setup(_args(tmain, _cli_args(checkpoint)))
    pi_cfg, pn_cfg, ts = build_models(config, 32, num_aa=20)
    tr = Trainer(ts, pi_cfg, pn_cfg, TrainerConfig(estimate_map=True), device="cpu")
    fake = type("B", (), {"ds": _Ds(), "label_sample_size": 4})()
    with pytest.raises(ValueError, match="threshold sweep requires full-vocabulary"):
        tr.evaluate(fake, threshold_sweep=np.array([0.5], np.float32))
    with pytest.raises(ValueError, match="cannot export full-vocabulary"):
        tr.evaluate(fake, save_results=True)
    full = type("B", (), {"ds": _Ds()})()
    with pytest.raises(ValueError, match="sweep-only fast path"):
        tr.evaluate(full, compute_metrics=False, only_represented_labels=True)


HOST_BRANCHES = {
    "sweep": (["--validation-path-name", "VAL_DATA_PATH"], ["DECISION_TH", "null"]),
    "exact_auprc": ([], ["ESTIMATE_MAP", "False"]),
    "save_prediction_results": (["--save-prediction-results"], []),
    "save_embeddings": (["--save-embeddings"], []),
    "only_represented_labels": (["--only-represented-labels"], []),
    "normalize_probabilities": ([], ["NORMALIZE_PROBABILITIES", "True"]),
}


def _close(got, want, where):
    assert set(got) == set(want), where
    for k in set(want) - set(RATES):
        assert np.isfinite(got[k]), (where, k)
        assert got[k] == pytest.approx(want[k], abs=1e-6, rel=0), (where, k)


@pytest.mark.parametrize("branch", list(HOST_BRANCHES))
def test_host_branches_match_jax_cli(checkpoint, env, branch):
    """Each host branch through both CLIs on the same checkpoint: metric
    dicts to 1e-6; the sweep's threshold and score exactly; the saved
    parquet frames (labels exactly, float16 logits to one float16 step) and
    the embedding rows (float16, likewise)."""
    import pandas as pd

    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain

    extra, overrides = HOST_BRANCHES[branch]
    results = env / "outputs" / "results"
    before = set(glob.glob(str(results / "*")))
    jax_all = jmain.run(_args(jmain, _cli_args(checkpoint, overrides=overrides,
                                               extra=["--name", "jaxrun", *extra])))
    port_all = tmain.run(_args(tmain, _cli_args(checkpoint, overrides=overrides, extra=[
        "--name", "portrun", "--device", "cpu", *extra])))
    assert set(port_all) == set(jax_all)
    _close(port_all["test"], jax_all["test"], "test")
    if branch == "sweep":
        assert port_all["decision_threshold"] == jax_all["decision_threshold"]
        assert 0 < port_all["decision_threshold"]["score"] <= 1
        _close(port_all["validation_at_sweep"], jax_all["validation_at_sweep"], "validation")
        assert "f1_macro" not in port_all["validation_at_sweep"]  # null threshold: AP only
        assert "f1_macro" in port_all["test"]  # the test set at the swept threshold
    if branch == "exact_auprc":
        binned = tmain.run(_args(tmain, _cli_args(checkpoint, extra=["--device", "cpu"])))
        assert port_all["test"]["map_micro"] != binned["test"]["map_micro"]
    new = set(glob.glob(str(results / "*"))) - before

    def one(kind, run):
        (path,) = [p for p in new if kind in os.path.basename(p) and run in p]
        return path

    if branch == "save_prediction_results":
        for kind in ("logits", "labels"):
            got = pd.read_parquet(one(f"test_{kind}_", "portrun"))
            want = pd.read_parquet(one(f"test_{kind}_", "jaxrun"))
            assert list(got.columns) == list(want.columns) and len(got.columns) == NUM_LABELS
            assert list(got.index) == list(want.index) and len(got) == 12
            if kind == "labels":
                assert got.equals(want)
            else:
                np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=2.0 ** -10,
                                           atol=1e-5)
    if branch == "save_embeddings":
        got, want = (np.load(one("test_sequence_embeddings_", run))
                     for run in ("portrun", "jaxrun"))
        assert list(got["sequence_ids"]) == list(want["sequence_ids"])
        # every 100th batch: the first of two 8-row batches
        assert got["embeddings"].shape == want["embeddings"].shape == (8, 48)
        np.testing.assert_allclose(got["embeddings"].astype(np.float32),
                                   want["embeddings"].astype(np.float32),
                                   rtol=2.0 ** -10, atol=1e-5)


def test_port_test_models_matches_jax(checkpoint, env, tmp_path):
    """``cli/test_models.py`` of both packages on the TEST_DATA_PATH
    template and the same checkpoint: the metrics files agree to 1e-6."""
    from protnote_tpu.cli import test_models as jtm
    from protnote_tpu_torch.cli import test_models as ttm

    files = {}
    for name, mod, extra in (("jax", jtm, []), ("port", ttm, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.json"
        mod.main(["--model-files", checkpoint, "--test-sets", "TEST_DATA_PATH",
                  "--metrics-file", str(files[name]), "--extra-args", *extra,
                  "--override", *OVERRIDES])
    got, want = (json.loads(files[k].read_text()) for k in ("port", "jax"))
    assert len(got) == len(want) == 1
    assert got[0]["run_name"].endswith("eval_TEST_DATA_PATH_random")
    _close(got[0]["metrics"]["test"], want[0]["metrics"]["test"], "test_models")
