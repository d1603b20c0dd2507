"""Train and evaluate a ProtNote model with the PyTorch port.

    python -m protnote_tpu_torch.cli.main --train-path-name TRAIN_DATA_PATH \\
        --validation-path-name VAL_DATA_PATH --test-paths-names TEST_DATA_PATH \\
        --override ESTIMATE_MAP True
    python -m protnote_tpu_torch.cli.main --test-paths-names TEST_DATA_PATH \\
        --model-file run.ckpt --override ESTIMATE_MAP True DECISION_TH 0.5

The argument surface of ``protnote_tpu.cli.main``.  Ported are training,
validation and the test sets with all metrics on the device: config, the
label-embedding cache, ``ProteinDataset`` -> ``BucketBatcher`` (device label
gather; for training shuffled, ``drop_last`` and weighted by
``WEIGHTED_SAMPLING``) -> ``PrefetchBatcher`` (the port's copies of the JAX
package's host data layer), weights from ``--model-file`` (a ``PNTPU1``
``.ckpt`` of either package, or a reference ``.pt``; ``--from-checkpoint``
resumes its epoch and optimizer state), ``Trainer.train`` (train steps
through K4 + K5, validation through K1 + K3, checkpoints, the best one
reloaded), and the metric dict of every test set (``EvalMetrics.compute()``,
the eval ``loss``, seqs/s and pairs/s), with ``train_summary``, optionally
appended to the ``--save-val-test-metrics`` JSON.  ``PAIR_BACKEND
tiled_int8`` evaluates through the int8 scorer (K2) with static scales
calibrated on each evaluation's first batch (``INT8_CALIBRATE``, default
True; ``INT8_ACT_SCALES`` supplies them); training then still runs the
decomposed scorer.  ``--device cpu`` runs the same path with the kernels'
plain versions (for tests).  The config is read with
``load_config``/``override_config``/``resolve_paths`` of
:mod:`protnote_tpu_torch.core.config`.

The threshold sweep, the exact host AUPRC, prediction and embedding export,
GO-DAG normalisation, represented-label slicing, label sampling, encoder
training, the text tower, profiler traces, wandb and a mesh raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
from typing import Dict, List

import numpy as np

from protnote_tpu_torch.train.trainer import SWEEP_LATER, TRAIN_SUBSET_LATER

logger = logging.getLogger(__name__)

ROADMAP_HOST_PATH = ("reads logits back to the host (prediction/embedding export, "
                     "GO-DAG normalisation, label slicing): not ported yet "
                     "(ROADMAP.md queue 1, item 3)")
ROADMAP_TRAINING_EXTRAS = ("{} is not ported for training (ROADMAP.md queue 1, item 5h): "
                           "torch.profiler traces and wandb logging of training runs")
ROADMAP_ENCODER = ("{} (training the sequence encoder) is not ported (ROADMAP.md queue 1, "
                   "item 5d)")


def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's arguments, plus ``--device``."""
    ap = argparse.ArgumentParser(description="ProtNote training and evaluation (PyTorch port)")
    ap.add_argument("--train-path-name", default=None)
    ap.add_argument("--validation-path-name", default=None)
    ap.add_argument("--test-paths-names", nargs="+", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--name", default="ProtNoteTPU")
    ap.add_argument("--override", nargs="*", default=None)
    ap.add_argument("--model-file", default=None,
                    help="checkpoint to load (.ckpt of the JAX package, .pt reference)")
    ap.add_argument("--from-checkpoint", action="store_true")
    ap.add_argument("--annotations-path-name", default="GO_ANNOTATIONS_PATH")
    ap.add_argument("--base-label-embedding-name", default="GO_BASE_LABEL_EMBEDDING_PATH")
    ap.add_argument("--save-prediction-results", action="store_true")
    ap.add_argument("--save-embeddings", action="store_true")
    ap.add_argument("--save-val-test-metrics", action="store_true")
    ap.add_argument("--save-val-test-metrics-file", default="val_test_metrics.json")
    ap.add_argument("--use-wandb", action="store_true")
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--only-represented-labels", action="store_true")
    ap.add_argument("--mesh-dp", type=int, default=None)
    ap.add_argument("--mesh-label", type=int, default=None)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator-address", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of training and evaluation (default: cuda)")
    return ap


def refuse_unported(args, params: Dict) -> None:
    """Raise ``NotImplementedError`` for what the port does not run.
    ``DECISION_TH null`` alone is ported: as in the JAX CLI, test sets are
    then scored for AP only; the threshold sweep runs on a validation set."""
    if args.validation_path_name and params.get("DECISION_TH") is None:
        raise NotImplementedError(SWEEP_LATER)
    for flag, name in ((args.use_wandb, "--use-wandb"), (args.profile_dir, "--profile-dir")):
        if flag:
            raise NotImplementedError(ROADMAP_TRAINING_EXTRAS.format(name))
    for key in ("TRAIN_SEQUENCE_ENCODER", "ENCODER_BN_TRAIN_MODE"):
        if args.train_path_name and params.get(key):
            raise NotImplementedError(ROADMAP_ENCODER.format(key))
    if args.train_path_name and (
            params.get("GRID_SAMPLER") or params.get("TRAIN_LABEL_SAMPLE_SIZE")
            or params.get("SHUFFLE_LABELS") or params.get("IN_BATCH_SAMPLING")):
        raise NotImplementedError(TRAIN_SUBSET_LATER)
    if args.validation_path_name and params.get("VALIDATION_LABEL_SAMPLE_SIZE"):
        raise NotImplementedError("VALIDATION_LABEL_SAMPLE_SIZE: label-subsampled "
                                  "evaluation is not ported (ROADMAP.md queue 1, item 3)")
    for flag, name in ((args.save_prediction_results, "--save-prediction-results"),
                       (args.save_embeddings, "--save-embeddings"),
                       (args.only_represented_labels, "--only-represented-labels"),
                       (params.get("NORMALIZE_PROBABILITIES"), "NORMALIZE_PROBABILITIES")):
        if flag:
            raise NotImplementedError(f"{name} {ROADMAP_HOST_PATH}")
    if not params.get("ESTIMATE_MAP", False):
        raise NotImplementedError(
            "ESTIMATE_MAP False (the exact host AUPRC, ExactAUPRC) is not ported yet "
            "(ROADMAP.md queue 1, item 3); pass --override ESTIMATE_MAP True")
    if (params.get("LABEL_ENCODER_NUM_TRAINABLE_LAYERS") or 0) > 0:
        raise NotImplementedError("the text tower (K8) is not ported yet "
                                  "(ROADMAP.md queue 1, item 8)")
    mesh = [v for v in (args.mesh_dp, args.mesh_label) if v not in (None, 1)]
    if mesh or params.get("DISTRIBUTE_LABELS") or args.distributed:
        raise NotImplementedError("meshes and several cards come with the multi-GPU "
                                  "slice (ROADMAP.md queue 1, item 9)")
    if not params.get("DEVICE_RESIDENT_LABEL_EMBEDDINGS", True):
        raise NotImplementedError("DEVICE_RESIDENT_LABEL_EMBEDDINGS False is not ported "
                                  "(ROADMAP.md queue 1, item 3); the port gathers from "
                                  "the resident label matrix")


def load_setup(args):
    """-> (config, run_name, log): the JAX ``get_setup`` for test-set roles,
    without jax: overrides, resolved paths, ``dataset_paths``, the
    label-embedding paths and a timestamped run name."""
    from protnote_tpu_torch.core.config import (
        DEFAULT_CONFIG_PATH,
        generate_label_embedding_path,
        label_embedding_index_path,
        load_config,
        override_config,
        resolve_paths,
        setup_logging,
    )

    config = load_config(args.config or DEFAULT_CONFIG_PATH)
    override_config(config, args.override)
    resolve_paths(config)
    params, paths = config["params"], config["paths_resolved"]
    refuse_unported(args, params)
    timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_name = f"{timestamp}_{args.name}"
    roles = {"train": [args.train_path_name] if args.train_path_name else [],
             "validation": [args.validation_path_name] if args.validation_path_name else [],
             "test": args.test_paths_names or []}
    config["dataset_paths"] = {role: [paths[name] for name in names]
                               for role, names in roles.items() if names}
    config["ANNOTATIONS_PATH"] = paths.get(args.annotations_path_name)
    base_emb = paths.get(args.base_label_embedding_name)
    if base_emb is not None:
        config["LABEL_EMBEDDING_PATH"] = generate_label_embedding_path(params, base_emb)
        config["LABEL_EMBEDDING_INDEX_PATH"] = label_embedding_index_path(
            config["LABEL_EMBEDDING_PATH"])
    log = setup_logging(paths.get("LOG_DIR"), run_name)
    return config, run_name, log


def run(args) -> Dict:
    from protnote_tpu_torch.data.batching import BucketBatcher, PrefetchBatcher
    from protnote_tpu_torch.data.dataset import DatasetConfig, ProteinDataset
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache
    from protnote_tpu_torch.data.vocab import generate_vocabularies
    from protnote_tpu_torch.cli._model_setup import build_models
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer
    from protnote_tpu_torch.train.step import init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    import torch

    config, run_name, log = load_setup(args)
    params = config["params"]
    if args.seed is not None:
        params["SEED"] = args.seed
    seed = params["SEED"]

    cache = LabelEmbeddingCache.load(config["LABEL_EMBEDDING_PATH"],
                                     config["LABEL_EMBEDDING_INDEX_PATH"])
    vocab_source = params.get("EXTRACT_VOCABULARIES_FROM")
    vocabularies = None
    if vocab_source:
        vocab_path = config["paths_resolved"].get(vocab_source)
        if not vocab_path or not os.path.exists(vocab_path):
            raise FileNotFoundError(
                f"EXTRACT_VOCABULARIES_FROM={vocab_source!r} -> {vocab_path!r} does "
                "not exist; set the path or override EXTRACT_VOCABULARIES_FROM null "
                "to derive per-dataset vocabularies deliberately")
        vocabularies = generate_vocabularies(file_path=vocab_path)

    datasets: Dict[str, List[ProteinDataset]] = {
        role: [ProteinDataset(p, DatasetConfig.from_params(params, role),
                              label_embedding_cache=cache, vocabularies=vocabularies,
                              seed=seed) for p in paths]
        for role, paths in config["dataset_paths"].items()}
    if not datasets:
        raise SystemExit("No datasets selected; pass --train-path-name or --test-paths-names")
    num_aa = len(next(iter(datasets.values()))[0].amino_acid_vocabulary)

    pi_cfg, pn_cfg, ts = build_models(
        config, cache.dim, num_aa=num_aa, seed=seed, gate_pretrained=True,
        train_sequence_encoder=params.get("TRAIN_SEQUENCE_ENCODER", False), log=log)
    device = torch.device(args.device)

    # ---------------- loss / optimizer / trainer ----------------
    train_ds = datasets.get("train", [None])[0]
    label_weights = label_counts = None
    if train_ds is not None and params.get("LOSS_FN") == "WeightedBCE":
        label_weights = torch.as_tensor(train_ds.calculate_label_weights(
            power=params.get("INV_FREQUENCY_POWER", 0.5)), dtype=torch.float32).to(device)
    if train_ds is not None and params.get("LOSS_FN") == "CBLoss":
        # raw per-label sample counts, as the JAX CLI
        label_counts = torch.as_tensor(train_ds.calculate_label_counts()).to(device)
    loss_fn = get_loss_fn(params, label_weights=label_weights, label_counts=label_counts,
                          bce_pos_weight=params.get("BCE_POS_WEIGHT"))
    optimizer = None
    if train_ds is not None:
        optimizer = Optimizer(params)
        ts = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                              ts["enc_params"], ts["enc_state"], optimizer)
    out_dir = config["paths_resolved"].get("OUTPUT_MODEL_DIR", "outputs/checkpoints")
    trainer = Trainer(ts, pi_cfg, pn_cfg,
                      TrainerConfig.from_params(params, checkpoint_dir=out_dir,
                                                run_name=run_name),
                      device=device, loss_fn=loss_fn, optimizer=optimizer)
    if args.model_file:
        trainer.load(args.model_file, from_checkpoint=args.from_checkpoint)
    elif train_ds is None:
        log.warning("no --model-file: evaluating randomly initialised weights")

    buckets = tuple(params.get("SEQUENCE_BUCKETS",
                               (256, 512, 1024, 2048, 4096, 8192, 12288)))
    tokens_pb = params.get("TOKENS_PER_BATCH")
    prefetch_n = int(params.get("PREFETCH_BATCHES", 2) or 0)

    def with_prefetch(batcher):
        return PrefetchBatcher(batcher, prefetch=prefetch_n) if prefetch_n > 0 else batcher

    def eval_batcher(ds, batch_size):
        return with_prefetch(BucketBatcher(
            ds, batch_size, buckets=buckets, seed=seed,
            descriptions_per_label=pn_cfg.inference_descriptions_per_label,
            device_label_gather=True, tokens_per_batch=tokens_pb))

    # ---------------- train ----------------
    all_metrics: Dict[str, Dict] = {}
    if train_ds is not None:
        sequence_weights = None
        if params.get("WEIGHTED_SAMPLING"):
            lw = train_ds.calculate_label_weights(power=params.get("INV_FREQUENCY_POWER", 0.5))
            sequence_weights = train_ds.calculate_sequence_weights(
                lw, params.get("SEQUENCE_WEIGHT_AGG", "sum"))
            lo = params.get("SAMPLING_LOWER_CLAMP_BOUND")
            hi = params.get("SAMPLING_UPPER_CLAMP_BOUND")
            if lo is not None or hi is not None:
                sequence_weights = np.clip(sequence_weights, lo, hi)
        train_batcher = with_prefetch(BucketBatcher(
            train_ds, params["TRAIN_BATCH_SIZE"], buckets=buckets, shuffle=True,
            drop_last=True, seed=seed, sequence_weights=sequence_weights,
            device_label_gather=True, tokens_per_batch=tokens_pb))
        val_batcher = None
        if "validation" in datasets:
            val_batcher = eval_batcher(datasets["validation"][0],
                                       params["VALIDATION_BATCH_SIZE"])
        summary = trainer.train(train_batcher, val_batcher)
        all_metrics["train_summary"] = {
            "best_val_metric": summary["best_val_metric"],
            "epochs": len(summary["history"]),
            "history": [{k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                         for k, v in m.items()} for m in summary["history"]],
        }

    # ---------------- test ----------------
    tests = datasets.get("test", [])
    for i, test_ds in enumerate(tests):
        split = f"test_{i}" if len(tests) > 1 else "test"
        res = trainer.evaluate(eval_batcher(test_ds, params["TEST_BATCH_SIZE"]),
                               data_split_name=split)
        all_metrics[split] = res["metrics"]
        log.info("%s metrics: %s", split, json.dumps(res["metrics"], default=float))

    if args.save_val_test_metrics and all_metrics:
        path = args.save_val_test_metrics_file
        existing = []
        if os.path.exists(path):
            with open(path) as fh:
                try:
                    existing = json.load(fh)
                except json.JSONDecodeError:
                    existing = []
        existing.append({"run_name": run_name, "metrics": all_metrics})
        with open(path, "w") as fh:
            json.dump(existing, fh, indent=2, default=float)
    return all_metrics


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
