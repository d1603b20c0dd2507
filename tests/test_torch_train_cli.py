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

The training settings of the JAX CLI run through both CLIs the same way:
label-subset training (fixed, shuffled, in-batch and grid layouts, where
the scorer runs at each batch's label count), a validation label subset (on
the device through K3's ``cols`` path and on the host), label embeddings
shipped with every batch, ``GRADIENT_CHECKPOINTING``, a bfloat16 Adam
first moment and the streamed scorer (``TRAIN_STREAMING_LABEL_TILE 8``
over the 10 labels, so the second tile is ragged; with the z1 cache; and
with 4-label subsets, one padded tile): histories and test metrics as
above, and the trainable
parameters and Adam moments of both last checkpoints to 1e-5 absolute and
1e-4 relative.  The two sides' float32 parameters differ in their last bits
after a few steps, and Adam magnifies that where a gradient is near its
eps (it divides two tiny moments): on this fixture one parameter in a
thousand moves by ~1e-5.  The in-batch layout trains one epoch, for a
reason that ``test_in_batch_step_matches_jax_from_one_state`` pins down:
its fifth step is at a ReLU gate's edge, see there.
With the bfloat16 first moment, an f32 moment whose last bit differs can
round to the neighbouring bf16 value (tests/test_torch_optim.py), which
moves its parameter by up to LEARNING_RATE x 2^-8 = 1.2e-5 a step: there
parameters and moments to 1e-4 absolute.
``TrainConfusionAccumulator`` is held to the JAX accumulator exactly
(integer counts).
Training the encoder (``TRAIN_SEQUENCE_ENCODER``) and the encoder's
train-mode BatchNorm (``ENCODER_BN_TRAIN_MODE``) run through both CLIs the
same way (histories and test metrics), and each CLI evaluates the other's
last checkpoint to the metrics the other gives it.
"""

import json

import numpy as np
import pytest
import torch

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


def _run(module, name, extra, overrides=()):
    args = module.build_argparser().parse_args(
        ["--name", name, *extra, "--override", *OVERRIDES, *overrides])
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


SETTINGS = {
    "fixed": ["TRAIN_LABEL_SAMPLE_SIZE", "4"],
    "shuffled": ["TRAIN_LABEL_SAMPLE_SIZE", "4", "SHUFFLE_LABELS", "True"],
    "in_batch": ["IN_BATCH_SAMPLING", "True", "NUM_EPOCHS", "1"],
    "grid": ["GRID_SAMPLER", "True", "TRAIN_LABEL_SAMPLE_SIZE", "4"],
    "val_subset": ["VALIDATION_LABEL_SAMPLE_SIZE", "4"],
    "val_subset_host": ["VALIDATION_LABEL_SAMPLE_SIZE", "4", "ESTIMATE_MAP", "False"],
    "shipped": ["DEVICE_RESIDENT_LABEL_EMBEDDINGS", "False"],
    "remat": ["GRADIENT_CHECKPOINTING", "True"],
    "bf16_moment": ["OPTIMIZER_MOMENT_DTYPE", "bfloat16"],
    "streaming": ["TRAIN_STREAMING_LABEL_TILE", "8"],
    "streaming_cached": ["TRAIN_STREAMING_LABEL_TILE", "8", "TRAIN_STREAMING_CACHE", "True"],
    "streaming_subset": ["TRAIN_STREAMING_LABEL_TILE", "8", "TRAIN_LABEL_SAMPLE_SIZE", "4"],
    "dense": ["PAIR_BACKEND", "dense"],
    "tiled": ["PAIR_BACKEND", "tiled"],
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_training_settings_match_jax_cli(start, env, setting, monkeypatch):
    """2 epochs from one checkpoint with one training setting on both CLIs:
    the histories (train loss and F1s from the scatter-added counts, the
    validation metrics), the test metrics, and the trainable parameters and
    Adam moments of the two last checkpoints.  The streaming settings train
    every step of the port through the streamed scorer, with the cache as
    set; ``dense`` (training and evaluation) and ``tiled`` (training) run
    the materialised dense scorer on both sides."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain
    import protnote_tpu_torch.ops.streaming_train as tst
    from protnote_tpu.core.checkpoint import restore_checkpoint

    ckpt, params = start
    roles = ["--train-path-name", "TRAIN_DATA_PATH", "--validation-path-name",
             "VAL_DATA_PATH", "--test-paths-names", "TEST_DATA_PATH", "--model-file", ckpt]
    overrides = SETTINGS[setting]
    want = _run(jmain, f"jax{setting}", roles, overrides)
    streamed, scorer = [], tst._streaming
    monkeypatch.setattr(tst, "_streaming", lambda *a: streamed.append(a[7:10]) or scorer(*a))
    got = _run(tmain, f"port{setting}", roles + ["--device", "cpu"], overrides)
    if setting.startswith("streaming"):  # 2 epochs of 3 batches of the 24 sequences
        cache = True if setting == "streaming_cached" else None
        assert streamed == [(8, torch.float32, cache)] * (2 * 24 // 8)
    else:
        assert not streamed
    assert len(got["train_summary"]["history"]) == (1 if setting == "in_batch" else 2)
    for g, w in zip(got["train_summary"]["history"], want["train_summary"]["history"]):
        _assert_metrics_close(g, w)
    _assert_metrics_close(got["test"], want["test"])
    pn, pi, init_pn, init_pi, init_ts, make_opt = _jax_template(params)
    template = init_ts(*init_pn(jax.random.PRNGKey(0), pn), *init_pi(jax.random.PRNGKey(0), pi),
                       make_opt(params))
    out = env / "outputs" / "checkpoints"
    trees = [restore_checkpoint(str(next(out.glob(f"*_{name}{setting}_last_epoch.ckpt"))),
                                template)[0] for name in ("port", "jax")]
    atol = 1e-4 if setting == "bf16_moment" else 1e-5
    for key in ("trainable", "opt_state"):
        a, b = (jax.tree_util.tree_leaves(t[key]) for t in trees)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                       atol=atol, rtol=1e-4)


# Training the encoder runs with SGD: with Adam, the last block's 1 x 1 conv
# bias (whose gradient is zero in exact arithmetic, the W_p head's
# train-mode BatchNorm taking the shift of every pooled embedding out) takes
# a random walk of up to a learning rate a step from float32 noise on each
# side, and the eval-mode BatchNorm of validation does not take two
# different walks out (validation loss 0.3028 against 0.3004 after one
# epoch, training losses equal to 1e-6).  Adam on the encoder is held to
# JAX step by step in tests/test_torch_train_step.py.
ENCODER_SETTINGS = {
    "train_sequence_encoder": ["TRAIN_SEQUENCE_ENCODER", "True", "OPTIMIZER", "SGD",
                               "LEARNING_RATE", "0.1"],
    "encoder_bn_train_mode": ["ENCODER_BN_TRAIN_MODE", "True"],
}


@pytest.fixture()
def start_encoder(env, start):
    """The state of ``start`` in the layout of a run that trains the
    encoder with SGD (``trainable["encoder"]``, ``enc_params`` None), saved
    by the JAX ``save_checkpoint``."""
    from protnote_tpu.core.checkpoint import restore_checkpoint, save_checkpoint

    ckpt, params = start
    pn, pi, init_pn, init_pi, init_ts, make_opt = _jax_template(params)
    template = init_ts(*init_pn(jax.random.PRNGKey(0), pn), *init_pi(jax.random.PRNGKey(0), pi),
                       make_opt(params))
    tree, _ = restore_checkpoint(ckpt, template)
    path = env / "outputs" / "start_encoder.ckpt"
    sgd = make_opt(dict(params, OPTIMIZER="SGD"))
    save_checkpoint(str(path), init_ts(tree["trainable"]["protnote"], tree["model_state"],
                                       tree["enc_params"], tree["enc_state"], sgd,
                                       train_sequence_encoder=True), epoch=0)
    return str(path), params


@pytest.mark.parametrize("setting", sorted(ENCODER_SETTINGS))
def test_encoder_settings_match_jax_cli(start, start_encoder, env, setting):
    """2 epochs through both CLIs with ``TRAIN_SEQUENCE_ENCODER`` (from a
    checkpoint with ``trainable["encoder"]``) or ``ENCODER_BN_TRAIN_MODE``:
    the histories and test metrics agree; each CLI evaluates the other's
    last checkpoint (the encoder's weights, running statistics and moments
    in the other package's layout) to the metrics the other CLI gives it."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain

    ckpt = (start_encoder if setting == "train_sequence_encoder" else start)[0]
    roles = ["--train-path-name", "TRAIN_DATA_PATH", "--validation-path-name",
             "VAL_DATA_PATH", "--test-paths-names", "TEST_DATA_PATH", "--model-file", ckpt]
    overrides = ENCODER_SETTINGS[setting]
    want = _run(jmain, f"jax{setting}", roles, overrides)
    got = _run(tmain, f"port{setting}", roles + ["--device", "cpu"], overrides)
    assert len(got["train_summary"]["history"]) == 2
    for g, w in zip(got["train_summary"]["history"], want["train_summary"]["history"]):
        _assert_metrics_close(g, w)
    _assert_metrics_close(got["test"], want["test"])
    out = env / "outputs" / "checkpoints"
    for name in ("port", "jax"):
        last = str(next(out.glob(f"*_{name}{setting}_last_epoch.ckpt")))
        test_only = ["--test-paths-names", "TEST_DATA_PATH", "--model-file", last]
        _assert_metrics_close(
            _run(tmain, f"porteval{name}{setting}", test_only + ["--device", "cpu"],
                 overrides)["test"],
            _run(jmain, f"jaxeval{name}{setting}", test_only, overrides)["test"])


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def test_in_batch_step_matches_jax_from_one_state(start, env, monkeypatch):
    """The sixth in-batch step from one state, on both sides: loss, every
    gradient and every update to 1e-5.

    The JAX CLI trains the in-batch setting 2 epochs (6 steps of 8
    sequences) while its train step records the state and the placed batch
    before each step and the state after it.  The state before step 6 is
    converted with ``from_jax_tree``; the port's step runs from it with a
    recording optimizer (its gradients) and with the real one (its
    update, against the JAX CLI's recorded update), and the JAX step runs
    from it once more with an optax transform that keeps the gradients.

    Why the in-batch setting trains one epoch in
    ``test_training_settings_match_jax_cli``: on this fixture the fifth step
    (epoch 2, its second batch: 6 labels padded to 8) has a pre-activation
    of the output MLP's first BN + ReLU at 1.43e-6 from zero, and the two
    sides round it to opposite signs (-1.4305115e-6 in eager JAX,
    +1.4305115e-6 in the port; its inputs z, inv and shift are float32 sums
    taken in other orders).  The flipped gate moves that step's gradients by
    up to 1.6e-2 (the loss agrees to 4e-7), Adam carries the difference into
    the sixth step's loss (1.1e-4).  The same step run from one state
    agrees to ~1e-6 on every other step, padded or not; the padded columns
    change neither side's gradients (a probe on this fixture, 1e-6).  The
    step below is the sixth: its gates sit clear of zero."""
    import jax.numpy as jnp
    import optax
    import torch

    import protnote_tpu.cli.main as jmain
    import protnote_tpu.train.trainer as jtrainer
    from protnote_tpu.train.losses import get_loss_fn as jax_loss
    from protnote_tpu.train.step import make_train_step as jax_train_step
    from protnote_tpu_torch.models import fusion as tfu
    from protnote_tpu_torch.models import proteinfer as tpi
    from protnote_tpu_torch.models.convert import from_jax_tree
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer, tree_leaves
    from protnote_tpu_torch.train.step import make_train_step

    record = []
    orig = jtrainer.make_train_step

    def recording_step(*args, **kw):
        step = orig(*args, **kw)

        def run(ts, arrays, rng):
            before = _copy_tree((ts, arrays, rng))  # the step donates ts
            new_ts, metrics = step(ts, arrays, rng)
            record.append((before, _copy_tree((new_ts, metrics))))
            return new_ts, metrics

        return run

    monkeypatch.setattr(jtrainer, "make_train_step", recording_step)
    ckpt, params = start
    _run(jmain, "jaxsteps", ["--train-path-name", "TRAIN_DATA_PATH", "--model-file", ckpt],
         ["IN_BATCH_SAMPLING", "True"])
    assert len(record) == 6
    (ts, arrays, rng), (jax_next, jax_metrics) = record[5]
    assert arrays["label_multihots"].shape[1] < NUM_LABELS  # an in-batch label subset

    # the JAX gradients, from an optax transform that stores them
    def keep_grads():
        return optax.GradientTransformation(
            lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), {"g": g}))

    pn, pi, *_ = _jax_template(params)
    tx = keep_grads()
    jstep = jax_train_step(pi, pn, jax_loss(params), tx, donate=False)
    jts = dict(ts, opt_state=tx.init(ts["trainable"]))
    out, _ = jstep(jax.tree_util.tree_map(jnp.asarray, jts),
                   {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(rng))
    jax_grads = _leaves(out["opt_state"]["g"])

    tpn = tfu.ProtNoteConfig.from_params(params, protein_embedding_dim=48,
                                         label_embedding_dim=32,
                                         inference_descriptions_per_label=2,
                                         compute_dtype=torch.float32)
    tpi_cfg = tpi.ProteInferConfig(input_channels=20, output_channels=48, kernel_size=5,
                                   num_resnet_blocks=1, num_labels=NUM_LABELS)

    def batch():
        out = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
        for k in ("example_mask", "label_mask"):
            if k in out:
                out[k] = out[k].float()
        return out

    class KeepGrads:
        def update(self, grads, trainable, state):
            self.grads = [g.numpy() for g in grads]
            return state

    keep = KeepGrads()
    _, port_metrics = make_train_step(tpi_cfg, tpn, get_loss_fn(params), keep)(
        from_jax_tree(ts), batch(), None)
    assert float(port_metrics["loss"]) == pytest.approx(float(jax_metrics["loss"]),
                                                        abs=1e-5, rel=0)
    assert float(port_metrics["grad_norm"]) == pytest.approx(float(jax_metrics["grad_norm"]),
                                                             abs=1e-5, rel=0)
    assert len(keep.grads) == len(jax_grads) > 0
    for g, w in zip(keep.grads, jax_grads):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)

    opt = Optimizer(params)
    port_ts = from_jax_tree(ts)
    before = [t.clone() for t in tree_leaves(port_ts["trainable"])]
    port_next, _ = make_train_step(tpi_cfg, tpn, get_loss_fn(params), opt)(
        port_ts, batch(), None)
    jax_before, jax_after = _leaves(ts["trainable"]), _leaves(jax_next["trainable"])
    for p0, p1, w0, w1 in zip(before, tree_leaves(port_next["trainable"]), jax_before,
                              jax_after):
        np.testing.assert_allclose((p1 - p0).numpy(), w1 - w0, atol=1e-5, rtol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def test_train_confusion_accumulator_matches_jax():
    """Full-width, subset (with padded slots past its labels) and again
    full-width batches: the port's totals equal the JAX accumulator's,
    including the promotion of the full-width totals summed before the
    first subset, and a run that starts with a subset."""
    import jax.numpy as jnp
    import torch

    from protnote_tpu.train.trainer import TrainConfusionAccumulator as JaxAcc
    from protnote_tpu_torch.train.trainer import TrainConfusionAccumulator as PortAcc

    rng = np.random.default_rng(5)
    L = 12

    def counts(width):
        return {k: rng.integers(0, 5, width).astype(np.int32) for k in ("tp", "fp", "fn")}

    sub_a = np.array([3, 7, 1, 11])
    sub_b = np.array([0, 5, 7, 2, 9])
    for seq in ([(L, None), (6, sub_a), (L, None), (8, sub_b), (L, np.arange(L))],
                [(5, sub_b), (L, None), (4, sub_a)]):
        jacc, tacc = JaxAcc(L), PortAcc(L)
        for width, idx in seq:
            m = counts(width)
            jacc.update({k: jnp.asarray(v) for k, v in m.items()}, idx)
            tacc.update({k: torch.from_numpy(v) for k, v in m.items()}, idx)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(getattr(tacc, k).numpy(), np.asarray(getattr(jacc, k)))
        assert tacc.compute() == pytest.approx(jacc.compute(), abs=0)
