"""Label-embedding cache and per-vocabulary views.

Copy of ``protnote_tpu/data/label_cache.py`` for the port, which imports
nothing of the JAX package; ``LabelEmbeddingView.build`` looks labels up
with a dict where the original uses ``pandas.Index`` (same rows).

The cache is the offline product of cli/generate_label_embeddings.py —
one row per individual label description (reference
bin/generate_label_embeddings.py:104-166 saves a .pt tensor + pandas index;
here: one .npz containing embeddings + index columns, plus a standalone
parquet index for inspection, consumed at reference datasets.py:114-127).

``LabelEmbeddingView`` is the TPU-side contract: given a label vocabulary
and the allowed description types, it materialises ONE contiguous
``(rows, dim)`` matrix with each label's descriptions grouped together.
That matrix is uploaded to the device once per run and reused every step —
per-step batches then carry only int32 row indices into it (the
device-resident label path; the reference collator instead ships the
gathered float matrix with every batch, collators.py:100-105).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _indexer(keys: Sequence[str], values: np.ndarray) -> np.ndarray:
    """Position of each value in ``keys``, -1 where absent (what
    ``pandas.Index(keys).get_indexer(values)`` returns for unique keys)."""
    pos = {k: i for i, k in enumerate(keys)}
    if len(pos) != len(keys):
        raise ValueError("Reindexing only valid with uniquely valued Index objects")
    return np.fromiter((pos.get(v, -1) for v in values.tolist()), np.int64, len(values))


@dataclass
class LabelEmbeddingCache:
    """Row-per-description embedding store.

    embeddings: (N, D) float32; ids / description_types / descriptions:
    (N,) strings; token_counts: (N,) int32 (tokenizer length of each
    description — the reference records it in its index).
    """

    embeddings: np.ndarray
    ids: np.ndarray
    description_types: np.ndarray
    descriptions: np.ndarray
    token_counts: np.ndarray

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1])

    def __len__(self) -> int:
        return int(self.embeddings.shape[0])

    @staticmethod
    def save(
        path: str,
        embeddings: np.ndarray,
        ids: Sequence[str],
        description_types: Sequence[str],
        descriptions: Sequence[str],
        token_counts: Sequence[int],
    ) -> str:
        """Write the cache as one .npz plus a ``*_index.parquet`` sidecar
        (same roles as the reference's embeddings .pt + index .pt pair)."""
        embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        n = embeddings.shape[0]
        ids_a = np.asarray(ids, dtype=str)
        dt_a = np.asarray(description_types, dtype=str)
        desc_a = np.asarray(descriptions, dtype=str)
        tc_a = np.asarray(token_counts, dtype=np.int32)
        if not (len(ids_a) == len(dt_a) == len(desc_a) == len(tc_a) == n):
            raise ValueError("cache column lengths disagree")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # np.savez appends .npz when absent: return/derive everything from
        # the path ACTUALLY written, or load(returned_path) would miss
        path = path if path.endswith(".npz") else path + ".npz"
        np.savez(
            path,
            embeddings=embeddings,
            ids=ids_a,
            description_types=dt_a,
            descriptions=desc_a,
            token_counts=tc_a,
        )
        try:
            import pandas as pd

            from protnote_tpu_torch.core.config import label_embedding_index_path

            pd.DataFrame(
                {
                    "id": ids_a,
                    "description_type": dt_a,
                    "description": desc_a,
                    "token_count": tc_a,
                }
            ).to_parquet(label_embedding_index_path(path))
        except Exception:
            pass  # the .npz is self-contained; the parquet is a convenience
        return path

    @classmethod
    def load(cls, path: str, index_path: Optional[str] = None) -> "LabelEmbeddingCache":
        """Load a cache .npz.  ``index_path`` is accepted for API symmetry
        with the reference's two-file layout; the .npz already embeds the
        index, so it is only consulted if the .npz lacks index columns."""
        with np.load(path, allow_pickle=False) as z:
            embeddings = np.asarray(z["embeddings"], dtype=np.float32)
            if "ids" in z.files:
                ids = np.asarray(z["ids"], dtype=str)
                dts = np.asarray(z["description_types"], dtype=str)
                descs = np.asarray(z["descriptions"], dtype=str)
                tcs = np.asarray(z["token_counts"], dtype=np.int32)
            else:
                if index_path is None or not os.path.exists(index_path):
                    raise ValueError(f"{path} has no embedded index; pass index_path")
                import pandas as pd

                idx = pd.read_parquet(index_path)
                ids = idx["id"].to_numpy(dtype=str)
                dts = idx["description_type"].to_numpy(dtype=str)
                descs = idx["description"].to_numpy(dtype=str)
                tcs = idx["token_count"].to_numpy(dtype=np.int32)
        return cls(embeddings, ids, dts, descs, tcs)


class LabelEmbeddingView:
    """Contiguous per-vocabulary view of a cache.

    Rows are grouped by label (vocabulary order); within a label they follow
    the requested description-type order, then cache order.  ``embeddings``
    is the step-invariant matrix to commit to the device.
    """

    def __init__(
        self,
        embeddings: np.ndarray,
        token_counts: np.ndarray,
        cache_indices: np.ndarray,
        label_starts: np.ndarray,
        labels: List[str],
        description_types: Tuple[str, ...],
    ):
        self.embeddings = embeddings
        self.token_counts = token_counts
        # row -> original cache row (what indexes cache.descriptions, e.g.
        # for on-the-fly text-tower tokenization)
        self.cache_indices = cache_indices
        self.label_starts = label_starts  # (L+1,)
        self.labels = labels
        self.description_types = tuple(description_types)
        self.counts = np.diff(label_starts).astype(np.int64)

    @property
    def num_labels(self) -> int:
        return len(self.labels)

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1])

    @classmethod
    def build(
        cls,
        cache: LabelEmbeddingCache,
        vocabulary: Sequence[str],
        description_types: Sequence[str],
    ) -> "LabelEmbeddingView":
        vocabulary = list(vocabulary)
        lab = _indexer(vocabulary, np.asarray(cache.ids, dtype=str))
        prio = _indexer(list(description_types),
                        np.asarray(cache.description_types, dtype=str))
        valid = (lab >= 0) & (prio >= 0)
        rows = np.nonzero(valid)[0]
        order = np.lexsort((rows, prio[rows], lab[rows]))
        cache_rows = rows[order]
        lab_sorted = lab[cache_rows]
        counts = np.bincount(lab_sorted, minlength=len(vocabulary))
        if (counts == 0).any():
            missing = [vocabulary[i] for i in np.nonzero(counts == 0)[0][:5]]
            raise ValueError(
                f"{int((counts == 0).sum())} labels have no cached description "
                f"of types {tuple(description_types)} (e.g. {missing}); "
                f"regenerate the label-embedding cache"
            )
        starts = np.zeros(len(vocabulary) + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        return cls(
            embeddings=np.ascontiguousarray(cache.embeddings[cache_rows]),
            token_counts=cache.token_counts[cache_rows].astype(np.int32),
            cache_indices=cache_rows.astype(np.int64),
            label_starts=starts,
            labels=vocabulary,
            description_types=tuple(description_types),
        )

    # ---------------- row selection ----------------

    def first_k_rows(self, k: int, label_indices: Optional[np.ndarray] = None) -> np.ndarray:
        """View-row indices of the first k descriptions of each label
        (cycling when a label has fewer than k), shape (L·k,) —
        the deterministic inference layout for K-description ensembling
        (reference ProtNote.py:308-322)."""
        starts = self.label_starts[:-1]
        counts = self.counts
        if label_indices is not None:
            starts = starts[label_indices]
            counts = counts[label_indices]
        idx = starts[:, None] + (np.arange(k)[None, :] % counts[:, None])
        return idx.reshape(-1).astype(np.int32)

    def sample_rows(
        self, rng: np.random.Generator, label_indices: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """One random description row per label (the per-step label
        augmentation; reference _sample_label_embeddings, datasets.py:311-343)."""
        starts = self.label_starts[:-1]
        counts = self.counts
        if label_indices is not None:
            starts = starts[label_indices]
            counts = counts[label_indices]
        return (starts + rng.integers(0, counts)).astype(np.int32)

    def first_k_per_label(self, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialised ``first_k_rows``: (embeddings (L·k, D), token_counts
        (L·k,), cache row indices (L·k,))."""
        rows = self.first_k_rows(k)
        return self.embeddings[rows], self.token_counts[rows], self.cache_indices[rows]
