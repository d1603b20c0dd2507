"""Supervised metric tables across models/seeds (reference
bin/calculate_supervised_metrics.py:93-133): for each saved prediction set
(ProtNote seeds, ProteInfer seeds, BLAST), compute mAP micro/macro sliced by
GO ontology and write one parquet/JSON table.

    python -m protnote_tpu_torch.cli.calculate_supervised_metrics \
        --logits 'outputs/results/test_logits_*.parquet' \
        --labels outputs/results/test_labels_run.parquet --parenthood-json parenthood.json

Copy of the JAX package's ``cli/calculate_supervised_metrics.py`` on the
port's ``evaln/analysis.py`` and ``results_io``: it reads what the port's
``--save-prediction-results`` (``cli/main.py``, ``cli/test_proteinfer.py``)
and ``cli/predict.py`` write, on the host."""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

logger = logging.getLogger(__name__)


def main(argv=None):
    import pandas as pd

    from protnote_tpu_torch.evaln.analysis import complete_blast_preds, metrics_by_go_ontology
    from protnote_tpu_torch.evaln.results_io import load_logits

    ap = argparse.ArgumentParser()
    ap.add_argument("--logits", nargs="+", required=True,
                    help="prediction files (parquet/h5), one per model/seed; "
                         "globs allowed")
    ap.add_argument("--labels", required=True,
                    help="labels file (parquet/h5) shared across models")
    ap.add_argument("--parenthood-json", required=True)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--blast", nargs="*", default=[],
                    help="BLAST pseudo-logit files (completed to the grid)")
    ap.add_argument("--output", default="supervised_metrics.parquet")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    with open(args.parenthood_json) as fh:
        parenthood = json.load(fh)

    labels_df = load_logits(args.labels) if args.labels.endswith((".h5",)) else (
        pd.read_parquet(args.labels)
    )

    rows = []
    files = []
    for pattern in args.logits:
        files.extend(sorted(glob.glob(pattern)) or [pattern])
    for path in files:
        logits_df = load_logits(path)
        missing = labels_df.index.difference(logits_df.index)
        if len(missing):
            # reindex would silently fill NaN rows -> NaN mAP mistaken for
            # a real model score
            raise ValueError(
                f"{path}: {len(missing)} labeled sequences have no logits "
                f"(e.g. {list(missing[:3])}); logits/labels splits disagree"
            )
        logits_df = logits_df.reindex(labels_df.index)[labels_df.columns]
        res = metrics_by_go_ontology(logits_df, labels_df, parenthood, args.threshold)
        for ontology, metrics in res.items():
            rows.append({"model": os.path.basename(path), "ontology": ontology,
                         **metrics})
        logger.info("%s done", path)

    for path in args.blast:
        blast_df = load_logits(path)
        blast_df = complete_blast_preds(
            blast_df, list(labels_df.columns), list(labels_df.index)
        )
        res = metrics_by_go_ontology(blast_df, labels_df, parenthood, args.threshold)
        for ontology, metrics in res.items():
            rows.append({"model": f"blast:{os.path.basename(path)}",
                         "ontology": ontology, **metrics})

    table = pd.DataFrame(rows)
    # mean ± std across seeds per (model family, ontology) is left to the
    # caller; the raw per-file table carries everything needed
    if args.output.endswith(".json"):
        table.to_json(args.output, orient="records", indent=2)
    else:
        table.to_parquet(args.output)
    print(table.to_string(index=False))
    return table


if __name__ == "__main__":
    main()
