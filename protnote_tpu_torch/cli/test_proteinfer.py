"""Standalone ProteInfer evaluation with the PyTorch port: score a test FASTA
with the ProteInfer classifier head alone (no fusion tower), optionally
restricted to the labels represented in the dataset and GO-DAG-normalised,
then report the usual metric suite and export logits.

    python -m protnote_tpu_torch.cli.test_proteinfer --weights GO_model_weights.pkl

The argument surface of ``protnote_tpu.cli.test_proteinfer``, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions,
for tests).  The encoder computes in float32, as the JAX CLI does at
``Precision.HIGHEST``: on the card through K7's float32 kernels
(``masked_conv_forward_f32``, ``masked_mean_pool_f32``), then the float32
head (``proteinfer_forward``).  Weights come from the reference TF pickle
(``--weights``, else the configured ``--weights-path-name``), else a seeded
random init.  Metrics are the port's copy of ``EvalMetrics``, on the host.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's arguments, plus ``--device``."""
    from protnote_tpu_torch.core.config import DEFAULT_CONFIG_PATH

    ap = argparse.ArgumentParser(description="Standalone ProteInfer evaluation (PyTorch port)")
    ap.add_argument("--config", default=str(DEFAULT_CONFIG_PATH))
    ap.add_argument("--test-path-name", default="TEST_DATA_PATH")
    ap.add_argument("--weights-path-name", default="PROTEINFER_GO_WEIGHTS_PATH")
    ap.add_argument("--weights", default=None, help="explicit TF pickle path")
    ap.add_argument("--vocab-json", default=None,
                    help="JSON list: label order of the classifier head")
    ap.add_argument("--only-represented-labels", action="store_true")
    ap.add_argument("--normalize-probabilities", action="store_true")
    ap.add_argument("--parenthood-json", default=None)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--save-prediction-results", action="store_true")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--name", default="proteinfer")
    ap.add_argument("--override", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoder and the head (default: cuda)")
    return ap


def head_columns(ds, num_labels: int, head_vocab: Optional[List[str]],
                 only_represented: bool):
    """``(eval_labels, cols)``: the dataset labels scored and their head
    columns (``head_vocab`` the head's label order; without it the dataset
    vocabulary is taken as the head order's prefix), restricted to the
    labels the dataset represents when asked."""
    if head_vocab is not None:
        col_of = {label: j for j, label in enumerate(head_vocab)}
        eval_labels = [label for label in ds.label_vocabulary if label in col_of]
        cols = np.array([col_of[label] for label in eval_labels], dtype=np.int64)
    else:
        eval_labels = ds.label_vocabulary[:num_labels]
        cols = np.arange(len(eval_labels))
    if only_represented:
        rep = np.array([label in ds.label_frequency for label in eval_labels], dtype=bool)
        eval_labels = [label for label, r in zip(eval_labels, rep) if r]
        cols = cols[rep]
    return eval_labels, cols


def main(argv=None) -> Dict[str, float]:
    from protnote_tpu_torch.cli._model_setup import proteinfer_config
    from protnote_tpu_torch.core.config import load_config, override_config, resolve_paths
    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.data.dataset import DatasetConfig, ProteinDataset
    from protnote_tpu_torch.evaln.metrics import EvalMetrics
    from protnote_tpu_torch.evaln.results_io import save_evaluation_results
    from protnote_tpu_torch.models.convert import proteinfer_from_tf_pickle
    from protnote_tpu_torch.models.proteinfer import (
        init_proteinfer,
        one_hot_sequences,
        proteinfer_forward,
    )
    from protnote_tpu_torch.train.optim import tree_map

    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = resolve_paths(override_config(load_config(args.config), args.override))
    paths = cfg["paths_resolved"]
    pi_cfg = proteinfer_config(cfg["embed_sequences_params"])
    weights = args.weights or paths.get(args.weights_path_name)
    if weights and os.path.exists(weights):
        params, state = proteinfer_from_tf_pickle(weights, pi_cfg)
    else:
        logger.warning("weights unavailable (%s); random init", weights)
        params, state = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    device = torch.device(args.device)
    params = tree_map(lambda t: t.to(device), params)
    state = tree_map(lambda t: t.to(device), state)

    head_vocab = None
    if args.vocab_json:
        with open(args.vocab_json) as fh:
            head_vocab = json.load(fh)
    ds = ProteinDataset(paths[args.test_path_name], DatasetConfig(dataset_type="test"))
    eval_labels, cols = head_columns(ds, pi_cfg.num_labels, head_vocab,
                                     args.only_represented_labels)
    label_idx = {label: j for j, label in enumerate(eval_labels)}
    cols_on = torch.as_tensor(cols, device=device)

    normalizer = None
    if args.normalize_probabilities:
        if not args.parenthood_json:
            raise SystemExit("--normalize-probabilities requires --parenthood-json")
        from protnote_tpu_torch.evaln.go_dag import DagNormalizer

        with open(args.parenthood_json) as fh:
            normalizer = DagNormalizer(eval_labels, json.load(fh))

    id_to_labels = {sid: ds.label_id_lists[i] for i, sid in enumerate(ds.sequence_ids)}
    metrics = EvalMetrics(num_labels=len(eval_labels), threshold=args.threshold)
    batcher = BucketBatcher(ds, args.batch_size, return_label_multihots=False)
    all_logits, all_labels, all_ids = [], [], []
    t0, scored = time.perf_counter(), 0
    for batch in batcher:
        aa = torch.from_numpy(np.ascontiguousarray(batch.aa_ids)).to(device)
        lengths = torch.from_numpy(np.ascontiguousarray(batch.lengths)).to(device)
        with torch.inference_mode():
            onehot = one_hot_sequences(aa, pi_cfg.input_channels)
            logits, _ = proteinfer_forward(params, state, onehot, lengths, pi_cfg)
            logits = logits.index_select(1, cols_on).cpu().numpy()
        keep = np.asarray(batch.example_mask, bool)
        logits = logits[keep]
        ids = [s for s, k in zip(batch.sequence_ids, keep) if k]
        labels = np.zeros((len(ids), len(eval_labels)), dtype=np.uint8)
        for r, sid in enumerate(ids):
            for li in id_to_labels.get(sid, []):
                j = label_idx.get(ds.int2label[int(li)])
                if j is not None:
                    labels[r, j] = 1
        probs = 1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
        if normalizer is not None:
            probs = normalizer(probs)
        metrics.update(probs, labels)
        scored += len(ids)
        if args.save_prediction_results:
            all_logits.append(logits.astype(np.float16))
            all_labels.append(labels)
            all_ids.extend(ids)

    result = metrics.compute()
    logger.info("scored %d sequences in %.2fs", scored, time.perf_counter() - t0)
    print(json.dumps(result, default=float))
    if args.save_prediction_results and all_logits:
        out_dir = args.output_dir or paths.get("RESULTS_DIR", "outputs/results")
        save_evaluation_results(
            {"logits": np.concatenate(all_logits), "labels": np.concatenate(all_labels),
             "sequence_ids": all_ids},
            eval_labels, args.name, out_dir, "test")
    return result


if __name__ == "__main__":
    main()
