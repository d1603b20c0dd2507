"""The int8 backend's wiring in the port against the JAX package, on the CPU:
``Trainer`` (auto calibration on the first evaluation batch, its
invalidation by a training epoch and by ``load``, supplied scales kept),
``ServingEngine`` (``calibrate_from``, scoring, ``warmup`` without scales,
``reload``) and ``cli.serve --calibration-fasta``.  Ports of
tests/test_int8_static.py:165-316 and of the JAX engine's int8 behaviour.

Tolerances: calibrated scales 1e-5 relative (float32 towers that sum in
other orders feed the same max); serving probabilities 2e-3 absolute, as
tests/test_torch_serving.py (both engines read logits back in float16).
"""

import numpy as np
import pytest
import torch

import jax

from protnote_tpu.data.batching import BucketBatcher as JaxBatcher
from protnote_tpu.data.dataset import DatasetConfig as JaxDatasetConfig
from protnote_tpu.data.dataset import ProteinDataset as JaxDataset
from protnote_tpu.data.fasta import save_to_fasta
from protnote_tpu.data.label_cache import LabelEmbeddingCache as JaxCache
from protnote_tpu.models.fusion import ProtNoteConfig as JaxPN
from protnote_tpu.models.fusion import init_protnote as jax_init_protnote
from protnote_tpu.models.proteinfer import ProteInferConfig as JaxPI
from protnote_tpu.models.proteinfer import init_proteinfer as jax_init_proteinfer
from protnote_tpu.serving import ServingEngine as JaxEngine
from protnote_tpu.train.losses import get_loss_fn as jax_loss_fn
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state as jax_init_train_state
from protnote_tpu.train.trainer import Trainer as JaxTrainer
from protnote_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from protnote_tpu_torch.data.batching import BucketBatcher
from protnote_tpu_torch.data.dataset import DatasetConfig, ProteinDataset
from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.serving import ServingEngine
from protnote_tpu_torch.train.losses import get_loss_fn
from protnote_tpu_torch.train.optim import Optimizer
from protnote_tpu_torch.train.step import init_train_state
from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

AAS = "ACDEFGHIKLMNPQRSTVWY"
N_LABELS, K, D = 12, 2, 16
SMALL_PI = dict(output_channels=32, kernel_size=5, num_resnet_blocks=2, num_labels=8)
SMALL_PN = dict(protein_embedding_dim=32, label_embedding_dim=D, latent_dim=16,
                projection_head_num_layers=2, projection_head_hidden_dim_scale_factor=2,
                output_mlp_num_layers=2, output_mlp_hidden_dim_scale_factor=2,
                label_tile=8, pair_backend="tiled_int8")
OPT = {"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2}
SCALE_RTOL = 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An evaluation FASTA, a training FASTA and a label-embedding cache
    (two descriptions per label)."""
    root = tmp_path_factory.mktemp("int8_wiring")
    rng = np.random.default_rng(0)
    labels = [f"GO:{i:07d}" for i in range(N_LABELS)]
    for name, n in (("eval", 10), ("train", 8)):
        save_to_fasta([("".join(rng.choice(list(AAS), 20 + i)), f"{name}{i}",
                        [labels[i % N_LABELS], labels[(3 * i) % N_LABELS]])
                       for i in range(n)], str(root / f"{name}.fasta"))
    JaxCache.save(str(root / "cache.npz"), rng.normal(size=(N_LABELS * K, D)).astype(np.float32),
                  [g for g in labels for _ in range(K)], ["name", "label"] * N_LABELS,
                  ["d"] * (N_LABELS * K), [3] * (N_LABELS * K))
    return root


def _port_ds(files, name="eval"):
    role = "train" if name == "train" else "test"
    return ProteinDataset(str(files / f"{name}.fasta"), DatasetConfig(dataset_type=role),
                          label_embedding_cache=LabelEmbeddingCache.load(str(files / "cache.npz")))


def _jax_ds(files, name="eval"):
    role = "train" if name == "train" else "test"
    return JaxDataset(str(files / f"{name}.fasta"), JaxDatasetConfig(dataset_type=role),
                      label_embedding_cache=JaxCache.load(str(files / "cache.npz")))


def _eval_batcher(ds, cls=BucketBatcher):
    return cls(ds, 4, buckets=(64,), device_label_gather=True)


def _weights():
    pi_p, pi_s = jax_init_proteinfer(jax.random.PRNGKey(0), JaxPI(**SMALL_PI))
    pn_p, pn_s = jax_init_protnote(jax.random.PRNGKey(1), JaxPN(**SMALL_PN))
    return pi_p, pi_s, pn_p, pn_s


def _port_trainer(files, pn_cfg=None, **cfg):
    pi_p, pi_s, pn_p, pn_s = _weights()
    tree = from_jax_tree(jax.tree_util.tree_map(np.asarray, {
        "pn_p": pn_p, "pn_s": pn_s, "pi_p": pi_p, "pi_s": pi_s}))
    opt = Optimizer(OPT)
    ts = init_train_state(tree["pn_p"], tree["pn_s"], tree["pi_p"], tree["pi_s"], opt)
    return Trainer(ts, tpi.ProteInferConfig(**SMALL_PI), pn_cfg or tfu.ProtNoteConfig(**SMALL_PN),
                   TrainerConfig(estimate_map=True, **cfg), device="cpu",
                   loss_fn=get_loss_fn({"LOSS_FN": "BCE"}), optimizer=opt)


@pytest.mark.parametrize("calibrate", [True, False])
def test_trainer_auto_calibrates_like_jax(files, calibrate):
    """The first evaluate() calibrates on the first batch, with the JAX
    trainer's scales on the same weights; the second does not recalibrate;
    INT8_CALIBRATE False keeps the dynamic path."""
    pi_p, pi_s, pn_p, pn_s = _weights()
    tx = make_optimizer(OPT)
    jtr = JaxTrainer(jax_init_train_state(pn_p, pn_s, pi_p, pi_s, tx), JaxPI(**SMALL_PI),
                     JaxPN(**SMALL_PN), jax_loss_fn({"LOSS_FN": "BCE"}), tx,
                     JaxTrainerConfig(int8_calibrate=calibrate, estimate_map=True))
    jm = jtr.evaluate(_eval_batcher(_jax_ds(files), JaxBatcher))["metrics"]
    tr = _port_trainer(files, int8_calibrate=calibrate)
    assert TrainerConfig.from_params({"INT8_CALIBRATE": calibrate}).int8_calibrate is calibrate
    m = tr.evaluate(_eval_batcher(_port_ds(files)))["metrics"]
    assert np.isfinite(m["loss"]) and np.isfinite(m["map_micro"])
    if not calibrate:
        assert tr.pn_cfg.int8_act_scales is None and jtr.pn_cfg.int8_act_scales is None
        return
    scales = tr.pn_cfg.int8_act_scales
    assert scales is not None and len(scales) == 1 and all(s > 0 for s in scales)
    np.testing.assert_allclose(scales, jtr.pn_cfg.int8_act_scales, rtol=SCALE_RTOL, atol=0)
    assert m["loss"] == pytest.approx(jm["loss"], abs=1e-5)
    tr.evaluate(_eval_batcher(_port_ds(files)))
    assert tr.pn_cfg.int8_act_scales is scales  # frozen after the first


def test_training_epoch_drops_auto_scales(files):
    """A training epoch resets auto scales (the next evaluate recalibrates,
    to other scales: the weights moved); supplied scales survive it."""
    tr = _port_trainer(files)
    ds, train = _port_ds(files), _port_ds(files, "train")

    def epoch(trainer):
        trainer.train_one_epoch(BucketBatcher(train, 4, buckets=(64,), shuffle=True,
                                              drop_last=True, seed=0, device_label_gather=True),
                                torch.Generator().manual_seed(0))

    tr.evaluate(_eval_batcher(ds))
    first = tr.pn_cfg.int8_act_scales
    assert first is not None
    epoch(tr)
    assert tr.pn_cfg.int8_act_scales is None
    tr.evaluate(_eval_batcher(ds))
    assert tr.pn_cfg.int8_act_scales is not None and tr.pn_cfg.int8_act_scales != first

    supplied = _port_trainer(files, pn_cfg=tfu.ProtNoteConfig(**SMALL_PN, int8_act_scales=first))
    epoch(supplied)
    assert supplied.pn_cfg.int8_act_scales == first
    supplied.evaluate(_eval_batcher(ds))
    assert supplied.pn_cfg.int8_act_scales == first


def test_load_drops_auto_scales(files, tmp_path):
    """``load`` restores other weights than the auto scales were made for:
    it drops them; supplied scales survive a restore."""
    tr = _port_trainer(files, checkpoint_dir=str(tmp_path), run_name="r")
    tr.save("x")
    path = str(tmp_path / "r_x.ckpt")
    ds = _port_ds(files)
    tr.evaluate(_eval_batcher(ds))
    assert tr.pn_cfg.int8_act_scales is not None
    tr.load(path)
    assert tr.pn_cfg.int8_act_scales is None
    tr.evaluate(_eval_batcher(ds))
    assert tr.pn_cfg.int8_act_scales is not None
    supplied = tr.pn_cfg.int8_act_scales
    tr2 = _port_trainer(files, pn_cfg=tfu.ProtNoteConfig(**SMALL_PN, int8_act_scales=supplied))
    tr2.load(path)
    assert tr2.pn_cfg.int8_act_scales == supplied
    with pytest.raises(ValueError, match="tiled_int8"):
        _port_trainer(files, pn_cfg=tfu.ProtNoteConfig(**{**SMALL_PN, "pair_backend": "tiled"})
                      ).calibrate_int8(_eval_batcher(ds))


def _engines(scales=None):
    pi_p, pi_s, pn_p, pn_s = _weights()
    ts = jax_init_train_state(pn_p, pn_s, pi_p, pi_s, make_optimizer(OPT))
    matrix = np.random.default_rng(3).normal(size=(N_LABELS * K, D)).astype(np.float32)
    vocab = [f"GO:{i:07d}" for i in range(N_LABELS)]
    kw = dict(buckets=(32, 64), max_batch=4)
    pn = dict(SMALL_PN, inference_descriptions_per_label=K, int8_act_scales=scales)
    jax_engine = JaxEngine(ts, JaxPI(**SMALL_PI), JaxPN(**pn), matrix, vocab, **kw)
    port = ServingEngine(from_jax_tree(jax.tree_util.tree_map(np.asarray, ts)),
                         tpi.ProteInferConfig(**SMALL_PI), tfu.ProtNoteConfig(**pn),
                         matrix, vocab, device="cpu", **kw)
    return jax_engine, port


def _seqs(rng, n, lo=10, hi=60):
    return ["".join(rng.choice(list(AAS), int(rng.integers(lo, hi)))) for _ in range(n)]


def test_serving_int8_matches_jax_engine(rng):
    jax_engine, port = _engines()
    assert port._needs_calibration
    port.warmup()  # skipped: the synthetic motif must not set the scales
    assert port.stats.snapshot()["batches"] == 0 and port.pn_cfg.int8_act_scales is None
    calib = _seqs(rng, 6)
    jax_engine.calibrate_from(calib)
    port.calibrate_from(calib)
    scales = port.pn_cfg.int8_act_scales
    assert scales is not None and not port._needs_calibration
    np.testing.assert_allclose(scales, jax_engine.pn_cfg.int8_act_scales, rtol=SCALE_RTOL, atol=0)
    port.calibrate_from(_seqs(rng, 3))  # once calibrated, it stays
    assert port.pn_cfg.int8_act_scales is scales
    seqs = _seqs(rng, 5, lo=5, hi=60)
    want, got = jax_engine.score(seqs), port.score(seqs)
    assert got.shape == (5, N_LABELS) and np.all((got > 0) & (got < 1))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    port.warmup()  # with scales it runs
    assert port.stats.snapshot()["batches"] >= 1 + 2

    # reload: auto scales dropped, recalibrated on the next scored batch
    port.reload(port.ts)
    assert port.pn_cfg.int8_act_scales is None and port._needs_calibration
    port.score(seqs[:2])
    assert port.pn_cfg.int8_act_scales is not None


def test_serving_supplied_scales_survive_reload(rng):
    jax_engine, port = _engines(scales=(0.05,))
    assert not port._needs_calibration
    seqs = _seqs(rng, 3)
    np.testing.assert_allclose(port.score(seqs), jax_engine.score(seqs), atol=2e-3, rtol=0)
    port.reload(port.ts)
    assert port.pn_cfg.int8_act_scales == (0.05,) and not port._needs_calibration


def test_serving_lazy_calibration_matches_jax(rng):
    """Without ``calibrate_from``, both engines calibrate on the first batch
    they score (the same sequences), to the same scales and probabilities."""
    jax_engine, port = _engines()
    seqs = _seqs(rng, 4)
    np.testing.assert_allclose(port.score(seqs), jax_engine.score(seqs), atol=2e-3, rtol=0)
    np.testing.assert_allclose(port.pn_cfg.int8_act_scales, jax_engine.pn_cfg.int8_act_scales,
                               rtol=SCALE_RTOL, atol=0)


def test_serve_cli_calibration_fasta(files, tmp_path, monkeypatch):
    """``cli.serve --calibration-fasta``: the engine starts with scales
    calibrated from the file's sequences (read with the port's own
    ``read_fasta``)."""
    import yaml

    from protnote_tpu_torch.cli import serve as tserve
    from protnote_tpu_torch.core.config import DEFAULT_CONFIG_PATH

    with open(DEFAULT_CONFIG_PATH) as fh:
        cfg = yaml.safe_load(fh)
    cfg["embed_sequences_params"].update(OUTPUT_CHANNELS=24, KERNEL_SIZE=5, NUM_RESNET_BLOCKS=1,
                                         PROTEINFER_NUM_GO_LABELS=N_LABELS)
    cfg["params"].update(LATENT_EMBEDDING_DIM=8, PROJECTION_HEAD_NUM_LAYERS=2,
                         OUTPUT_MLP_NUM_LAYERS=2, SEQUENCE_BUCKETS=[32, 64])
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    emb_dir = tmp_path / "embeddings"
    emb_dir.mkdir()
    cache = JaxCache.load(str(files / "cache.npz"))
    JaxCache.save(str(emb_dir / "frozen_label_embeddings_E5multilingual_mean.npz"),
                  cache.embeddings, cache.ids, cache.description_types, cache.descriptions,
                  cache.token_counts)
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path))
    base = ["--config", str(path), "--device", "cpu", "--max-batch", "2", "--override",
            "MIXED_PRECISION", "False", "PAIR_BACKEND", "tiled_int8"]
    engine, _ = tserve.build_engine(tserve.build_argparser().parse_args(
        base + ["--calibration-fasta", str(files / "eval.fasta")]))
    assert engine.pn_cfg.int8_act_scales is not None and not engine._needs_calibration
    probs = engine.score(_seqs(np.random.default_rng(1), 3))
    assert probs.shape == (3, N_LABELS) and np.all((probs > 0) & (probs < 1))
    lazy, _ = tserve.build_engine(tserve.build_argparser().parse_args(base))
    assert lazy._needs_calibration
    empty = tmp_path / "empty.fasta"
    empty.write_text("")
    with pytest.raises(ValueError, match="no sequences"):
        tserve.build_engine(tserve.build_argparser().parse_args(
            base + ["--calibration-fasta", str(empty)]))
