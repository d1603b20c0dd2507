"""BLOSUM62 residue-substitution augmentation.

Copy of ``protnote_tpu/data/blosum.py`` for the port.

The reference samples a substitute residue with probability proportional to
``max(0, blosum62_score)`` over the amino-acid vocabulary (conservative
mutations; protnote/utils/data.py:330-356, applied per residue at p=0.1 in
the dataset, datasets.py:217-267).  The matrix is embedded here (the
reference pulls it from the ``blosum`` package) and the sampler is
vectorised over integer residue ids so whole batches augment in one numpy
pass instead of a per-character Python loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from protnote_tpu_torch.data.vocab import COMMON_AMINOACIDS

# Standard BLOSUM62, row/column order ARNDCQEGHILKMFPSTWYV.
_ORDER = "ARNDCQEGHILKMFPSTWYV"
_TABLE = [
    #  A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [  4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0],  # A
    [ -1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3],  # R
    [ -2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3],  # N
    [ -2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3],  # D
    [  0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],  # C
    [ -1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2],  # Q
    [ -1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2],  # E
    [  0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3],  # G
    [ -2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3],  # H
    [ -1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3],  # I
    [ -1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1],  # L
    [ -1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2],  # K
    [ -1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1],  # M
    [ -2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1],  # F
    [ -1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2],  # P
    [  1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2],  # S
    [  0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0],  # T
    [ -3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3],  # W
    [ -2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -1],  # Y
    [  0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -1,  4],  # V
]

BLOSUM62: Dict[str, Dict[str, int]] = {
    a: {b: _TABLE[i][j] for j, b in enumerate(_ORDER)} for i, a in enumerate(_ORDER)
}


class Blosum62Mutations:
    """Conservative-substitution sampler over an amino-acid vocabulary.

    ``sample_aa`` matches the reference's per-character rule: probability
    proportional to ``max(0, score)``; all-negative rows keep the original
    residue.  ``augment_ids`` applies the same distribution to a whole int8
    id array at once (ids index ``self.amino_acid_vocabulary``).
    """

    def __init__(
        self,
        amino_acid_vocabulary: Optional[Sequence[str]] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        vocab = sorted(set(amino_acid_vocabulary or COMMON_AMINOACIDS))
        self.amino_acid_vocabulary: List[str] = vocab
        self.rng = rng if rng is not None else np.random.default_rng()
        n = len(vocab)
        weights = np.zeros((n, n), dtype=np.float64)
        for i, a in enumerate(vocab):
            row = BLOSUM62.get(a, {})
            for j, b in enumerate(vocab):
                weights[i, j] = max(0.0, float(row.get(b, -4)))
        totals = weights.sum(axis=1)
        # all-negative rows (possible for non-standard residues): identity
        degenerate = totals <= 0
        if degenerate.any():
            weights[degenerate] = 0.0
            weights[degenerate, np.where(degenerate)[0]] = 1.0
            totals = weights.sum(axis=1)
        self._probs = weights / totals[:, None]
        self._cdf = np.cumsum(self._probs, axis=1)
        self._aa_to_id = {a: i for i, a in enumerate(vocab)}

    def sample_aa(self, amino_acid: str, rng: Optional[np.random.Generator] = None) -> str:
        i = self._aa_to_id.get(amino_acid)
        if i is None:
            return amino_acid
        r = rng if rng is not None else self.rng
        j = int(np.searchsorted(self._cdf[i], r.random(), side="right"))
        return self.amino_acid_vocabulary[min(j, len(self.amino_acid_vocabulary) - 1)]

    def augment_ids(
        self,
        ids: np.ndarray,
        probability: float,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """Vectorised augmentation of a residue-id array: each position is
        substituted with ``probability``; substitutes follow the BLOSUM62
        conservative distribution (which frequently re-draws the original)."""
        if probability <= 0.0:
            return ids
        r = rng if rng is not None else self.rng
        flat = np.asarray(ids).reshape(-1)
        sel = r.random(flat.shape[0]) < probability
        # leave pad/unknown positions untouched
        sel &= (flat >= 0) & (flat < self._cdf.shape[0])
        if not sel.any():
            return ids
        src = flat[sel].astype(np.int64)
        u = r.random(src.shape[0])
        # inverse-CDF sampling per selected residue
        rows = self._cdf[src]
        subs = (u[:, None] < rows).argmax(axis=1)
        out = flat.copy()
        out[sel] = subs.astype(flat.dtype)
        return out.reshape(np.asarray(ids).shape)
