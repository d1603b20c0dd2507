"""GO-DAG probability normalisation: a copy of ``protnote_tpu/evaln/go_dag.py``
(the port imports nothing of the JAX package; tests/test_torch_host_copies.py
holds it equal to the original).

A parent label's confidence becomes the max over its (transitive) children.
The parenthood JSON maps each label to all its ancestors; we invert it once
into a flat CSR-style child-index table and normalise a whole (N, L)
prediction matrix with numpy gather/max — no per-label Python loop over
sequences.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np


def reverse_map(applicable_label_dict: Mapping[str, Sequence[str]],
                label_vocab: set | None = None) -> Dict[str, frozenset]:
    """parents-of-child -> children-of-parent (transitive closure in == out)."""
    children: Dict[str, set] = {}
    for child, parents in applicable_label_dict.items():
        if label_vocab is None or child in label_vocab:
            for parent in parents:
                children.setdefault(parent, set()).add(child)
    return {k: frozenset(v) for k, v in children.items()}


class DagNormalizer:
    """Precompiled child-index table for a fixed label vocabulary."""

    def __init__(self, label_vocab: Sequence[str],
                 applicable_label_dict: Mapping[str, Sequence[str]]):
        vocab_index = {v: i for i, v in enumerate(label_vocab)}
        children = reverse_map(applicable_label_dict, set(vocab_index))
        # CSR layout: child_idx[offsets[j]:offsets[j+1]] are the child columns
        # feeding label j; labels with <=1 child map to themselves.
        idx_lists: List[np.ndarray] = []
        offsets = np.zeros(len(label_vocab) + 1, dtype=np.int64)
        for j, label in enumerate(label_vocab):
            kids = children.get(label, frozenset())
            cols = np.array(sorted(vocab_index[c] for c in kids), dtype=np.int64)
            if cols.size <= 1:
                cols = np.array([j], dtype=np.int64)
            idx_lists.append(cols)
            offsets[j + 1] = offsets[j] + len(cols)
        self.offsets = offsets
        self.child_idx = (
            np.concatenate(idx_lists) if idx_lists else np.zeros(0, dtype=np.int64)
        )
        self.num_labels = len(label_vocab)

    def __call__(self, predictions: np.ndarray) -> np.ndarray:
        """(N, L) -> (N, L) with parent >= max(children)."""
        preds = np.asarray(predictions)
        gathered = preds[:, self.child_idx]  # (N, total_children)
        out = np.maximum.reduceat(gathered, self.offsets[:-1], axis=1)
        # reduceat with empty segments can't happen (every label has >=1 col)
        return out


def normalize_confidences(predictions: np.ndarray, label_vocab: Sequence[str],
                          applicable_label_dict: Mapping[str, Sequence[str]]
                          ) -> np.ndarray:
    """One-shot form of :class:`DagNormalizer`."""
    return DagNormalizer(label_vocab, applicable_label_dict)(predictions)
