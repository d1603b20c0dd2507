"""Prediction/result serialization: a copy of
``protnote_tpu/evaln/results_io.py`` (tests/test_torch_host_copies.py holds it
equal to the original).  Logits + labels dataframes indexed by sequence id
with the label vocabulary as columns, written as parquet (float16 upcast to
float32) or HDF5; pandas is imported inside the functions."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def save_evaluation_results(
    results: Dict[str, np.ndarray],
    label_vocabulary: Sequence[str],
    run_name: str,
    output_dir: str,
    data_split_name: str,
    save_as_h5: bool = False,
) -> Dict[str, str]:
    """results: {'logits': (N, L), 'labels': (N, L) optional,
    'sequence_ids': list}.  Returns written paths."""
    import pandas as pd

    os.makedirs(output_dir, exist_ok=True)
    written = {}

    logits = np.asarray(results["logits"])
    if logits.dtype == np.float16:
        logits = logits.astype(np.float32)
    if len(label_vocabulary) != logits.shape[-1]:
        # numeric fallback columns would silently break every downstream
        # GO-term join (cli/calculate_supervised_metrics.py, analysis)
        raise ValueError(
            f"label vocabulary ({len(label_vocabulary)}) does not match the "
            f"logit width ({logits.shape[-1]}); pass the vocabulary that "
            f"produced these columns"
        )
    cols = list(label_vocabulary)

    seq_ids = list(results["sequence_ids"])
    ext = "h5" if save_as_h5 else "parquet"

    if "labels" in results:
        labels = np.asarray(results["labels"])
        labels_df = pd.DataFrame(labels, columns=cols, index=seq_ids)
        labels_path = os.path.join(
            output_dir, f"{data_split_name}_labels_{run_name}.{ext}"
        )
        if save_as_h5:
            labels_df.to_hdf(labels_path, key="labels_df", mode="w")
        else:
            labels_df.to_parquet(labels_path)
        written["labels"] = labels_path

    logits_df = pd.DataFrame(logits, columns=cols, index=seq_ids)
    logits_path = os.path.join(
        output_dir, f"{data_split_name}_logits_{run_name}.{ext}"
    )
    if save_as_h5:
        logits_df.to_hdf(logits_path, key="logits_df", mode="w")
    else:
        logits_df.to_parquet(logits_path)
    written["logits"] = logits_path
    return written


def load_logits(path: str):
    import pandas as pd

    if path.endswith(".h5"):
        # h5 artifacts carry a role-specific key (logits_df / labels_df,
        # see save_evaluation_results); try both so labels files load too
        try:
            return pd.read_hdf(path, key="logits_df")
        except KeyError:
            return pd.read_hdf(path, key="labels_df")
    return pd.read_parquet(path)
