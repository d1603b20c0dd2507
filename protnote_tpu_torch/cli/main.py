"""Train and evaluate a ProtNote model with the PyTorch port.

    python -m protnote_tpu_torch.cli.main --train-path-name TRAIN_DATA_PATH \\
        --validation-path-name VAL_DATA_PATH --test-paths-names TEST_DATA_PATH
    python -m protnote_tpu_torch.cli.main --validation-path-name VAL_DATA_PATH \\
        --test-paths-names TEST_DATA_PATH --model-file run.ckpt --override DECISION_TH null

The argument surface of ``protnote_tpu.cli.main``.  Ported are training,
validation, the decision-threshold sweep and the test sets: config, the
label-embedding cache, ``ProteinDataset`` -> ``BucketBatcher`` (device label
gather; for training shuffled, ``drop_last`` and weighted by
``WEIGHTED_SAMPLING``) -> ``PrefetchBatcher`` (the port's copies of the JAX
package's host data layer), weights from ``--model-file`` (a ``PNTPU1``
``.ckpt`` of either package, or a reference ``.pt``; ``--from-checkpoint``
resumes its epoch and optimizer state), ``Trainer.train`` (train steps
through K4 + K5, validation through K1 + K3, checkpoints, the best one
reloaded), with ``DECISION_TH null`` and a validation set one validation
pass that also sweeps 99 thresholds (K9) and sets the test sets' threshold,
and the metric dict of every test set (``EvalMetrics.compute()``: with
``ESTIMATE_MAP`` on the device through K3, else on the host with the exact
AUPRC; the eval ``loss``, seqs/s and pairs/s), with ``train_summary``,
``decision_threshold`` and ``validation_at_sweep``, optionally appended to
the ``--save-val-test-metrics`` JSON.  ``--save-prediction-results``,
``--save-embeddings``, ``--only-represented-labels`` and
``NORMALIZE_PROBABILITIES`` (with ``PARENTHOOD_LIB_PATH``) take the host
path, as in the JAX CLI.  ``PAIR_BACKEND
tiled_int8`` evaluates through the int8 scorer (K2) with static scales
calibrated on each evaluation's first batch (``INT8_CALIBRATE``, default
True; ``INT8_ACT_SCALES`` supplies them); training then still runs the
decomposed scorer.  ``--device cpu`` runs the same path with the kernels'
plain versions (for tests).  The config is read with
``load_config``/``override_config``/``resolve_paths`` of
:mod:`protnote_tpu_torch.core.config`.

Training takes the label layouts of the JAX CLI (``TRAIN_LABEL_SAMPLE_SIZE``,
``SHUFFLE_LABELS``, ``IN_BATCH_SAMPLING``, ``GRID_SAMPLER``), validation
during training ``VALIDATION_LABEL_SAMPLE_SIZE``, and every batcher ships
the label embeddings with each batch when ``DEVICE_RESIDENT_LABEL_EMBEDDINGS``
is False.  ``GRADIENT_CHECKPOINTING`` and ``OPTIMIZER_MOMENT_DTYPE bfloat16``
reach the scorer and the optimizer through the config.

``LABEL_ENCODER_NUM_TRAINABLE_LAYERS`` > 0 embeds the label text through
the tower of ``LABEL_ENCODER_CHECKPOINT`` (local files, as the JAX CLI) in
every step: with ``LORA`` the adapters of the last n layers train
(``LORA_RANK``, ``LORA_ALPHA``) and the tower stays frozen; without it the
whole tower joins the trainable tree and the optimizer's trainable mask
updates its last n layers only (the clip still sees every gradient).  The
tower computes in float32 on the CPU and, with ``MIXED_PRECISION False``,
on the card (as the JAX CLI trains it: K8a, K8b and their backward in
float32), and in bfloat16 on the card under ``MIXED_PRECISION``; its
weights stay float32.  ``TRAIN_SEQUENCE_ENCODER`` trains the ProteInfer
encoder (``trainable["encoder"]``, through K7's backward kernels on the
card) and ``ENCODER_BN_TRAIN_MODE`` runs the frozen encoder's BatchNorm on
batch statistics, as the JAX CLI does.  Profiler traces, wandb and a mesh
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
``MIXED_PRECISION False`` evaluates in float32 on the card (K7, K1 and K2
in float32; ``PAIR_BACKEND dense`` through the dense scorer's float32
kernels) and trains through every scorer (the decomposed one: K4, K4-bwd
and K5 in float32; the streamed one: K6 in float32 too; the dense one: its
first layer, prod GEMMs and K5 forms in float32) and, with
``TRAIN_SEQUENCE_ENCODER`` or ``ENCODER_BN_TRAIN_MODE``, the encoder (K7's
float32 dX, dW and dbias, train-mode BatchNorm and pool transpose), and
with ``LABEL_ENCODER_NUM_TRAINABLE_LAYERS`` the label tower (K8a, K8b and
their backward in float32).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)

ROADMAP_TRAINING_EXTRAS = ("{} is not ported for training (ROADMAP.md queue 1, item 5h): "
                           "torch.profiler traces and wandb logging of training runs")


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
    """Raise ``NotImplementedError`` for what the port does not run."""
    for flag, name in ((args.use_wandb, "--use-wandb"), (args.profile_dir, "--profile-dir")):
        if flag:
            raise NotImplementedError(ROADMAP_TRAINING_EXTRAS.format(name))
    mesh = [v for v in (args.mesh_dp, args.mesh_label) if v not in (None, 1)]
    if mesh or params.get("DISTRIBUTE_LABELS") or args.distributed:
        raise NotImplementedError("meshes and several cards come with the multi-GPU "
                                  "slice (ROADMAP.md queue 1, item 9)")


def load_setup(args):
    """-> (config, run_name, log): ``core/config.py:get_setup`` on the
    CLI's arguments, then ``refuse_unported`` on the resolved params."""
    from protnote_tpu_torch.core.config import DEFAULT_CONFIG_PATH, get_setup

    config, run_name, log = get_setup(
        config_path=args.config or DEFAULT_CONFIG_PATH,
        run_name=args.name,
        overrides=args.override,
        train_path_name=args.train_path_name,
        val_path_name=args.validation_path_name,
        test_paths_names=args.test_paths_names,
        annotations_path_name=args.annotations_path_name,
        base_label_embedding_name=args.base_label_embedding_name,
    )
    refuse_unported(args, config["params"])
    return config, run_name, log


def build_label_tower(params: Dict, cache, pn_params, device, seed: int):
    """The trainable label tower of ``LABEL_ENCODER_NUM_TRAINABLE_LAYERS``
    (the JAX ``cli/main.py:216-267``): ``(text_cfg, text_params,
    lora_params, label_tokens, trainable_mask)``, the weights float32 on the
    CPU, ``label_tokens`` the tokenized ``cache.descriptions``.  The tower
    computes in float32 (``load_pretrained_tower``'s dtype, the JAX CLI's),
    on the card in bfloat16 under ``MIXED_PRECISION``."""
    import dataclasses

    import torch

    from protnote_tpu_torch.models.label_encoder import (
        load_pretrained_tower,
        tokenize_descriptions,
    )
    from protnote_tpu_torch.models.text_transformer import init_lora, trainable_mask
    from protnote_tpu_torch.train.optim import tree_map

    n_layers = int(params["LABEL_ENCODER_NUM_TRAINABLE_LAYERS"])
    checkpoint = params["LABEL_ENCODER_CHECKPOINT"]
    try:
        text_cfg, text_params, tokenizer = load_pretrained_tower(checkpoint)
    except Exception as e:
        raise SystemExit(f"LABEL_ENCODER_NUM_TRAINABLE_LAYERS={n_layers} requires the "
                         f"{checkpoint!r} weights locally (pre-seed the HF cache in offline "
                         f"environments): {e}") from e
    if device.type == "cuda" and params.get("MIXED_PRECISION", True):
        text_cfg = dataclasses.replace(text_cfg, dtype=torch.bfloat16)
    label_tokens = tokenize_descriptions(tokenizer, cache.descriptions)
    lora_params = mask = None
    if params.get("LORA", False):
        lora_params = init_lora(torch.Generator().manual_seed(seed + 2), text_cfg,
                                rank=params.get("LORA_RANK", 4), last_n_layers=n_layers)
    else:
        mask = {"protnote": tree_map(lambda _: True, pn_params),
                "text": trainable_mask(text_params, text_cfg, n_layers)}
    return text_cfg, text_params, lora_params, label_tokens, mask


def run(args) -> Dict:
    from protnote_tpu_torch.data.batching import BucketBatcher, GridBatcher, PrefetchBatcher
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

    train_encoder = bool(params.get("TRAIN_SEQUENCE_ENCODER", False))
    pi_cfg, pn_cfg, ts = build_models(
        config, cache.dim, num_aa=num_aa, seed=seed, gate_pretrained=True,
        train_sequence_encoder=train_encoder, log=log)
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
    # ---------------- the trainable label tower ----------------
    text_cfg = text_params = lora_params = label_tokens = mask = None
    if (params.get("LABEL_ENCODER_NUM_TRAINABLE_LAYERS") or 0) > 0:
        text_cfg, text_params, lora_params, label_tokens, mask = build_label_tower(
            params, cache, ts["trainable"]["protnote"], device, seed)
    tower = dict(text_params=text_params, train_label_encoder=mask is not None,
                 lora_params=lora_params)
    optimizer = None
    if train_ds is not None:
        optimizer = Optimizer(params, trainable_mask=mask)
        ts = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                              ts["trainable"].get("encoder", ts["enc_params"]), ts["enc_state"],
                              optimizer, train_sequence_encoder=train_encoder, **tower)
    elif text_cfg is not None:  # evaluation through the tower: the same layout
        if mask is not None:
            ts["trainable"]["text"] = text_params
        if lora_params is not None:
            ts["trainable"]["lora"] = lora_params
        ts["text_params"] = None if mask is not None else text_params
    out_dir = config["paths_resolved"].get("OUTPUT_MODEL_DIR", "outputs/checkpoints")
    results_dir = config["paths_resolved"].get("RESULTS_DIR", "outputs/results")
    trainer = Trainer(ts, pi_cfg, pn_cfg,
                      TrainerConfig.from_params(params, checkpoint_dir=out_dir,
                                                run_name=run_name),
                      device=device, loss_fn=loss_fn, optimizer=optimizer,
                      text_cfg=text_cfg, label_tokens=label_tokens,
                      pooling_method=params.get("LABEL_EMBEDDING_POOLING_METHOD", "mean"),
                      lora_alpha=params.get("LORA_ALPHA", 8),
                      lora_rank=params.get("LORA_RANK", 4),
                      train_sequence_encoder=train_encoder,
                      encoder_bn_train_mode=bool(params.get("ENCODER_BN_TRAIN_MODE", False)))
    if args.model_file:
        trainer.load(args.model_file, from_checkpoint=args.from_checkpoint)
    elif train_ds is None:
        log.warning("no --model-file: evaluating randomly initialised weights")

    buckets = tuple(params.get("SEQUENCE_BUCKETS",
                               (256, 512, 1024, 2048, 4096, 8192, 12288)))
    tokens_pb = params.get("TOKENS_PER_BATCH")
    prefetch_n = int(params.get("PREFETCH_BATCHES", 2) or 0)
    # label embeddings resident on the device (batches carry row indices), or
    # shipped with every batch
    dev_gather = bool(params.get("DEVICE_RESIDENT_LABEL_EMBEDDINGS", True))

    def with_prefetch(batcher):
        return PrefetchBatcher(batcher, prefetch=prefetch_n) if prefetch_n > 0 else batcher

    def eval_batcher(ds, batch_size, label_sample_size=None):
        return BucketBatcher(
            ds, batch_size, buckets=buckets, seed=seed, label_sample_size=label_sample_size,
            descriptions_per_label=pn_cfg.inference_descriptions_per_label,
            device_label_gather=dev_gather, tokens_per_batch=tokens_pb)

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
        grid = params.get("GRID_SAMPLER", False)
        train_batcher = BucketBatcher(
            train_ds, params["TRAIN_BATCH_SIZE"], buckets=buckets, shuffle=True,
            drop_last=True, seed=seed,
            label_sample_size=None if grid else params.get("TRAIN_LABEL_SAMPLE_SIZE"),
            shuffle_labels=params.get("SHUFFLE_LABELS", False),
            in_batch_sampling=params.get("IN_BATCH_SAMPLING", False),
            sequence_weights=sequence_weights, device_label_gather=dev_gather,
            tokens_per_batch=tokens_pb)
        if grid:
            sample = params.get("TRAIN_LABEL_SAMPLE_SIZE")
            if not sample:
                raise SystemExit("GRID_SAMPLER requires TRAIN_LABEL_SAMPLE_SIZE")
            train_batcher = GridBatcher(train_batcher, labels_batch_size=sample)
        train_batcher = with_prefetch(train_batcher)
        val_batcher = None
        if "validation" in datasets:
            val_batcher = with_prefetch(eval_batcher(
                datasets["validation"][0], params["VALIDATION_BATCH_SIZE"],
                label_sample_size=params.get("VALIDATION_LABEL_SAMPLE_SIZE")))
        summary = trainer.train(train_batcher, val_batcher)
        all_metrics["train_summary"] = {
            "best_val_metric": summary["best_val_metric"],
            "epochs": len(summary["history"]),
            "history": [{k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                         for k, v in m.items()} for m in summary["history"]],
        }

    # ---------------- decision threshold ----------------
    threshold = params.get("DECISION_TH")
    if threshold is None and "validation" in datasets:
        # one pass over validation: metrics and the threshold sweep
        val_batcher = eval_batcher(datasets["validation"][0],
                                   params["VALIDATION_BATCH_SIZE"])
        res = trainer.evaluate(val_batcher, data_split_name="validation",
                               threshold_sweep=np.arange(0.01, 1.0, 0.01, dtype=np.float32))
        threshold, score = res["threshold"]
        trainer.cfg.decision_threshold = threshold
        all_metrics["decision_threshold"] = {"threshold": threshold, "score": score}
        all_metrics["validation_at_sweep"] = res["metrics"]

    # ---------------- test ----------------
    parenthood = None
    if params.get("NORMALIZE_PROBABILITIES"):
        pl_path = config["paths_resolved"].get("PARENTHOOD_LIB_PATH")
        if pl_path and os.path.exists(pl_path):
            with open(pl_path) as fh:
                parenthood = json.load(fh)
    tests = datasets.get("test", [])
    for i, test_ds in enumerate(tests):
        split = f"test_{i}" if len(tests) > 1 else "test"
        res = trainer.evaluate(
            with_prefetch(eval_batcher(test_ds, params["TEST_BATCH_SIZE"])),
            save_results=args.save_prediction_results, output_dir=results_dir,
            data_split_name=split, only_represented_labels=args.only_represented_labels,
            normalize_probabilities=params.get("NORMALIZE_PROBABILITIES", False),
            parenthood=parenthood, save_embeddings=args.save_embeddings)
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
