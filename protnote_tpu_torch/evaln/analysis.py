"""Paper-reproduction analysis helpers (reference protnote/utils/notebooks.py
and evaluation.py:325-386): metric tables from saved logits/labels frames,
sliced by GO ontology or EC level-1 class, per-label metric frames, and BLAST
prediction completion.

Copy of ``protnote_tpu/evaln/analysis.py`` for the port, which imports
nothing of the JAX package (whose ``evaln`` package imports jax): the same
functions on the port's copies of the host metric classes."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from protnote_tpu_torch.data.annotations import ec_number_to_code
from protnote_tpu_torch.evaln.metrics import (
    ConfusionAccumulator,
    ExactAUPRC,
    average_precision,
)

GO_ROOTS = {
    "GO:0008150": "biological_process",
    "GO:0003674": "molecular_function",
    "GO:0005575": "cellular_component",
}
ONTOLOGIES = ["All", "biological_process", "cellular_component", "molecular_function"]


def ontology_of(go_term: str, parenthood: Mapping[str, Sequence[str]]) -> str:
    for parent in parenthood.get(go_term, []):
        if parent in GO_ROOTS:
            return GO_ROOTS[parent]
    return GO_ROOTS.get(go_term, "missing")


def get_metrics(logits: np.ndarray, labels: np.ndarray,
                threshold: Optional[float] = 0.5) -> Dict[str, float]:
    """mAP micro/macro + F1 family from a full prediction matrix."""
    probs = 1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
    out: Dict[str, float] = {}
    auprc = ExactAUPRC(num_labels=labels.shape[1])
    auprc.update(probs, labels)
    ap = auprc.compute()
    out["mAP Macro"] = ap["map_macro"]
    out["mAP Micro"] = ap["map_micro"]
    if threshold is not None:
        conf = ConfusionAccumulator(labels.shape[1], threshold)
        conf.update(probs, labels)
        for k, v in conf.compute().items():
            if k.startswith("f1"):
                out[k] = v
    return out


def filter_by_go_ontology(ontology: str, df, parenthood: Mapping[str, Sequence[str]]):
    """Column-filter a logits/labels DataFrame by GO ontology root."""
    if ontology == "All":
        return df
    keep = [ontology_of(c, parenthood) == ontology for c in df.columns]
    return df.iloc[:, keep]


def metrics_by_go_ontology(logits_df, labels_df,
                           parenthood: Mapping[str, Sequence[str]],
                           threshold: Optional[float] = 0.5) -> Dict[str, Dict]:
    results = {}
    for ontology in ONTOLOGIES:
        lg = filter_by_go_ontology(ontology, logits_df, parenthood)
        lb = filter_by_go_ontology(ontology, labels_df, parenthood)
        if lg.shape[1] == 0:
            continue
        results[ontology] = get_metrics(lg.values, lb.values, threshold)
    return results


def filter_by_ec_level_1(level_1_label: str, df, ec_class_descriptions: Dict):
    if level_1_label == "All":
        return df
    keep = []
    for c in df.columns:
        code = (ec_number_to_code(c.replace("EC:", ""))[0], 0, 0)
        entry = ec_class_descriptions.get(code)
        # a class absent from enzclass (e.g. translocases vs a pre-2018
        # file) matches no level-1 slice rather than raising KeyError
        keep.append(entry is not None and entry["label"] == level_1_label)
    return df.iloc[:, keep]


def metrics_by_ec_level_1(logits_df, labels_df, ec_class_descriptions: Dict,
                          threshold: Optional[float] = 0.5) -> Dict[str, Dict]:
    level_1s = [
        ec_class_descriptions[(i, 0, 0)]["label"]
        for i in range(1, 8)
        if (i, 0, 0) in ec_class_descriptions
    ]
    results = {}
    for lvl in ["All"] + level_1s:
        lg = filter_by_ec_level_1(lvl, logits_df, ec_class_descriptions)
        lb = filter_by_ec_level_1(lvl, labels_df, ec_class_descriptions)
        if lg.shape[1] == 0:
            continue
        results[lvl] = get_metrics(lg.values, lb.values, threshold)
    return results


def metrics_per_label_df(logits_df, labels_df, threshold: Optional[float] = None):
    """Per-label AUPRC (+P/R/F1 at a threshold); labels with no positives get
    NaN rows (reference evaluation.py:325-386)."""
    import pandas as pd

    probs = 1.0 / (1.0 + np.exp(-logits_df.values.astype(np.float32)))
    labels = labels_df.values
    rows = []
    for j, col in enumerate(labels_df.columns):
        t = labels[:, j]
        if not t.any():
            rows.append({"label": col, "AUPRC": np.nan})
            continue
        row = {"label": col, "AUPRC": average_precision(probs[:, j], t),
               "frequency": int(t.sum())}
        if threshold is not None:
            pred = probs[:, j] > threshold
            tp = int((pred & (t > 0)).sum())
            p = tp / max(pred.sum(), 1)
            r = tp / max(t.sum(), 1)
            row.update(
                Precision=p, Recall=r,
                F1=(2 * p * r / (p + r)) if (p + r) > 0 else 0.0,
            )
        rows.append(row)
    return pd.DataFrame(rows).set_index("label")


def complete_blast_preds(blast_df, labels: List[str], seqs: List[str],
                         fill_value: float = -15.0):
    """Align a BLAST logits frame onto a full (seqs x labels) grid
    (reference notebooks.py:12-26)."""
    missing_cols = [l for l in set(labels) - set(blast_df.columns)]
    if missing_cols:
        import pandas as pd

        blast_df = blast_df.join(
            pd.DataFrame(fill_value, index=blast_df.index, columns=missing_cols)
        )
    cols = [l for l in labels if l in blast_df.columns]
    return blast_df[cols].reindex(seqs).fillna(fill_value)


# ----------------------------------------------------------------------
# Seed-replicate statistics (reference Results.ipynb cell 42 + notebooks.py)


def welch_t_test(a: "np.ndarray", b: "np.ndarray"):
    """Two-sided Welch's t-test (unequal variances).

    Returns (t_statistic, p_value, dof).  Implemented directly (scipy is not
    a dependency); the p-value uses the Student-t survival function via the
    regularized incomplete beta function.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    na, nb = len(a), len(b)
    if na < 2 or nb < 2:
        raise ValueError("Welch t-test needs >=2 replicates per group")
    va, vb = a.var(ddof=1), b.var(ddof=1)
    se2 = va / na + vb / nb
    if se2 == 0:
        t = 0.0 if a.mean() == b.mean() else np.inf
        return float(np.sign(a.mean() - b.mean()) * t), 0.0 if t else 1.0, float(na + nb - 2)
    t = (a.mean() - b.mean()) / np.sqrt(se2)
    dof = se2 ** 2 / (
        (va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1)
    )
    p = _student_t_sf(abs(t), dof) * 2.0
    return float(t), float(min(p, 1.0)), float(dof)


def _student_t_sf(t: float, dof: float) -> float:
    """P(T > t) for Student's t via I_x(dof/2, 1/2), x = dof/(dof+t^2)."""
    x = dof / (dof + t * t)
    return 0.5 * _reg_inc_beta(dof / 2.0, 0.5, x)


def _reg_inc_beta(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b) by continued fraction
    (Numerical-Recipes-style Lentz algorithm)."""
    import math

    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_front = (
        math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
        + a * math.log(x) + b * math.log1p(-x)
    )
    front = math.exp(ln_front)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _beta_cf(a, b, x) / a
    return 1.0 - front * _beta_cf(b, a, 1.0 - x) / b


def _beta_cf(a: float, b: float, x: float, max_iter: int = 300,
             eps: float = 3e-14) -> float:
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    if abs(d) < tiny:
        d = tiny
    d = 1.0 / d
    h = d
    for m in range(1, max_iter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            break
    return h


def aggregate_seed_replicates(metric_files: "List[str]",
                              metrics: "Optional[List[str]]" = None,
                              split: str = "test"):
    """Aggregate per-seed metric JSONs (cli/main.py --save-val-test-metrics
    output) into a mean ± std frame.

    Each file holds a list of {"run": ..., "metrics": {split: {...}}} entries
    or a flat {split: {...}} dict.  Returns a DataFrame indexed by metric with
    columns (mean, std, n).
    """
    import json as _json

    import pandas as pd

    rows = []
    for path in metric_files:
        with open(path) as fh:
            data = _json.load(fh)
        if isinstance(data, list):
            entries = [d.get("metrics", d) for d in data]
        else:
            entries = [data]
        for entry in entries:
            m = entry.get(split, entry)
            if isinstance(m, dict):
                rows.append(m)
    if not rows:
        raise ValueError("no metric entries found")
    df = pd.DataFrame(rows)
    if metrics is not None:
        df = df[[c for c in metrics if c in df.columns]]
    out = pd.DataFrame({"mean": df.mean(), "std": df.std(ddof=1), "n": df.count()})
    return out


def compare_replicates(model_files: "Dict[str, List[str]]",
                       metric: str = "map_macro", split: str = "test"):
    """Reproduce the reference's seed-replicate comparison table
    (Results.ipynb cell 42: 5 seeds per model, Welch t-test vs the first
    model).  Returns a DataFrame: model x (mean, std, n, t_vs_<base>,
    p_value)."""
    import json as _json

    import pandas as pd

    values: Dict[str, np.ndarray] = {}
    for model, files in model_files.items():
        vals = []
        for path in files:
            with open(path) as fh:
                data = _json.load(fh)
            entries = data if isinstance(data, list) else [data]
            for d in entries:
                m = d.get("metrics", d)
                m = m.get(split, m)
                if isinstance(m, dict) and metric in m:
                    vals.append(float(m[metric]))
        if not vals:
            raise ValueError(f"{model}: no {metric!r} values found")
        values[model] = np.asarray(vals)

    base = next(iter(values))
    rows = []
    for model, v in values.items():
        row = {"model": model, "mean": v.mean(),
               "std": v.std(ddof=1) if len(v) > 1 else 0.0, "n": len(v)}
        if model != base and len(v) > 1 and len(values[base]) > 1:
            t, p, dof = welch_t_test(v, values[base])
            row.update({f"t_vs_{base}": t, "p_value": p, "dof": dof})
        rows.append(row)
    return pd.DataFrame(rows).set_index("model")
