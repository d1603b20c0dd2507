"""Canonical evaluation orchestrator of the port: runs the per-test-set
``cli/main.py`` command templates — supervised GO (threshold 0.5), zero-shot
GO leaf nodes and EC (threshold 0.3) — across one or more model checkpoints,
appending metrics to a shared JSON.

    python -m protnote_tpu_torch.cli.test_models --model-files run.ckpt \\
        --test-sets TEST_DATA_PATH --extra-args --device cuda

Port of ``protnote_tpu/cli/test_models.py``: the same ``TEST_COMMANDS``,
driving :mod:`protnote_tpu_torch.cli.main`."""

from __future__ import annotations

import argparse
import os
import logging
from typing import Dict, List

logger = logging.getLogger(__name__)

# test-set name -> (main.py arguments template)
TEST_COMMANDS: Dict[str, List[str]] = {
    "TEST_DATA_PATH": [
        "--test-paths-names", "TEST_DATA_PATH",
        "--override", "DECISION_TH", "0.5", "EXTRACT_VOCABULARIES_FROM", "null",
    ],
    "TEST_DATA_PATH_ZERO_SHOT": [
        "--test-paths-names", "TEST_DATA_PATH_ZERO_SHOT",
        "--annotations-path-name", "GO_ANNOTATIONS_PATH",
        "--base-label-embedding-name", "GO_2024_BASE_LABEL_EMBEDDING_PATH",
        "--override", "DECISION_TH", "0.3", "EXTRACT_VOCABULARIES_FROM", "null",
    ],
    "TEST_DATA_PATH_ZERO_SHOT_LEAF_NODES": [
        "--test-paths-names", "TEST_DATA_PATH_ZERO_SHOT_LEAF_NODES",
        "--annotations-path-name", "GO_ANNOTATIONS_PATH",
        "--base-label-embedding-name", "GO_2024_BASE_LABEL_EMBEDDING_PATH",
        "--override", "DECISION_TH", "0.3", "EXTRACT_VOCABULARIES_FROM", "null",
    ],
    "TEST_EC_DATA_PATH_ZERO_SHOT": [
        "--test-paths-names", "TEST_EC_DATA_PATH_ZERO_SHOT",
        "--annotations-path-name", "EC_ANNOTATIONS_PATH",
        "--base-label-embedding-name", "EC_BASE_LABEL_EMBEDDING_PATH",
        "--override", "DECISION_TH", "0.3", "EXTRACT_VOCABULARIES_FROM", "null",
    ],
    "TEST_2024_PINF_VOCAB_DATA_PATH": [
        "--test-paths-names", "TEST_2024_PINF_VOCAB_DATA_PATH",
        "--override", "DECISION_TH", "0.5", "EXTRACT_VOCABULARIES_FROM", "null",
    ],
    "TEST_TOP_LABELS_DATA_PATH": [
        "--test-paths-names", "TEST_TOP_LABELS_DATA_PATH",
        "--override", "DECISION_TH", "0.5", "EXTRACT_VOCABULARIES_FROM", "null",
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-files", nargs="+", required=True,
                    help="checkpoints to evaluate (.ckpt or reference .pt)")
    ap.add_argument("--test-sets", nargs="+", default=list(TEST_COMMANDS),
                    choices=list(TEST_COMMANDS))
    ap.add_argument("--save-prediction-results", action="store_true")
    ap.add_argument("--metrics-file", default="val_test_metrics.json")
    ap.add_argument("--extra-args", nargs=argparse.REMAINDER, default=[],
                help="remaining args forward to main.py verbatim "
                     "(REMAINDER: leading-dash tokens work)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from protnote_tpu_torch.cli.main import build_argparser, run

    for model_file in args.model_files:
        for test_set in args.test_sets:
            logger.info("=== %s on %s ===", model_file, test_set)
            cmd = [
                # the model name rides the run name so multi-checkpoint sweeps stay
                # distinguishable in the shared metrics JSON
                "--name",
                f"eval_{test_set}_"
                f"{os.path.splitext(os.path.basename(model_file))[0]}",
                "--model-file", model_file,
                "--save-val-test-metrics",
                "--save-val-test-metrics-file", args.metrics_file,
                *TEST_COMMANDS[test_set],
                *args.extra_args,
            ]
            if args.save_prediction_results:
                cmd.append("--save-prediction-results")
            run(build_argparser().parse_args(cmd))


if __name__ == "__main__":
    main()
