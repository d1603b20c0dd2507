"""FASTA-backed protein dataset.

Copy of ``protnote_tpu/data/dataset.py`` for the port, which imports
nothing of the JAX package.

Covers the responsibilities of the reference ProteinDataset
(protnote/data/datasets.py:19-507) with a TPU-first layout: sequences are
integer-encoded ONCE at construction (int8 residue ids; one-hot happens on
device), labels are integer id lists (multi-hot built per batch by the
native helper), and the label-embedding cache is exposed as a contiguous
per-vocabulary view (``label_view``) whose matrix lives on the device across
steps.

Reference behaviours reproduced: dedup by sequence (datasets.py:142-160),
train-only max-length filter (:161-168), subset fractions (:84-91),
sorted-set vocabularies (data.py:123-151), BLOSUM62 residue augmentation
(:217-267), per-label description ranges for augmentation sampling
(:269-343), represented-vocabulary mask (:189-191), label frequency /
label & sequence weights (:452-532).
"""

from __future__ import annotations

import logging
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from protnote_tpu_torch.data.blosum import Blosum62Mutations
from protnote_tpu_torch.data.fasta import read_fasta
from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache, LabelEmbeddingView
from protnote_tpu_torch.data.vocab import generate_vocabularies, get_vocab_mappings

logger = logging.getLogger(__name__)


def make_residue_lut(amino_acid_vocabulary: Sequence[str]) -> np.ndarray:
    """byte -> residue id lookup table (256,) int8; unknown bytes are -1
    (mapped to the zero-one-hot pad id downstream)."""
    lut = np.full(256, -1, dtype=np.int8)
    for i, aa in enumerate(amino_acid_vocabulary):
        lut[ord(aa)] = i
    return lut


@dataclass
class DatasetConfig:
    """Per-role dataset options (reference config keys in parentheses)."""

    dataset_type: str = "test"  # train | validation | test
    deduplicate: bool = True  # DEDUPLICATE
    max_sequence_length: Optional[int] = None  # MAX_SEQUENCE_LENGTH (train only)
    subset_fraction: float = 1.0  # {ROLE}_SUBSET_FRACTION
    augment_residue_probability: float = 0.0  # AUGMENT_RESIDUE_PROBABILITY
    # description types sampled during training (LABEL_AUGMENTATION_DESCRIPTIONS)
    label_augmentation_descriptions: Optional[Tuple[str, ...]] = None
    # description types ensembled at inference (INFERENCE_GO_DESCRIPTIONS)
    inference_go_descriptions: Tuple[str, ...] = ("name", "label")
    inference_descriptions_per_label: int = 1
    remove_unrepresented_labels: bool = False  # REMOVE_UNREPRESENTED_LABELS

    @property
    def is_train(self) -> bool:
        return self.dataset_type == "train"

    @classmethod
    def from_params(cls, params: Dict, role: str) -> "DatasetConfig":
        role_key = {"train": "TRAIN", "validation": "VALIDATION", "test": "TEST"}[role]
        is_train = role == "train"
        aug = params.get("LABEL_AUGMENTATION_DESCRIPTIONS", "name+label")
        inf = params.get("INFERENCE_GO_DESCRIPTIONS", "name+label")
        aug_t = tuple(aug.split("+")) if isinstance(aug, str) else tuple(aug or ())
        inf_t = tuple(inf.split("+")) if isinstance(inf, str) else tuple(inf or ())
        return cls(
            dataset_type=role,
            deduplicate=params.get("DEDUPLICATE", True),
            max_sequence_length=(
                params.get("MAX_SEQUENCE_LENGTH") if is_train else None
            ),
            subset_fraction=float(params.get(f"{role_key}_SUBSET_FRACTION", 1) or 1),
            augment_residue_probability=(
                float(params.get("AUGMENT_RESIDUE_PROBABILITY", 0.0) or 0.0)
                if is_train
                else 0.0
            ),
            label_augmentation_descriptions=aug_t if is_train else None,
            inference_go_descriptions=inf_t,
            inference_descriptions_per_label=len(inf_t),
            remove_unrepresented_labels=params.get("REMOVE_UNREPRESENTED_LABELS", False),
        )


class ProteinDataset:
    """In-memory dataset: pre-encoded sequences + label id lists + the
    label-embedding view used by the device-resident gather path."""

    def __init__(
        self,
        fasta_path: str,
        config: DatasetConfig,
        label_embedding_cache: Optional[LabelEmbeddingCache] = None,
        vocabularies: Optional[Dict[str, List[str]]] = None,
        seed: Optional[int] = None,
    ):
        self.path = fasta_path
        self.cfg = config
        self.seed = 42 if seed is None else int(seed)
        data = read_fasta(fasta_path)

        if config.subset_fraction < 1.0:
            rng = np.random.default_rng(self.seed)
            n_keep = max(int(round(len(data) * config.subset_fraction)), 1)
            keep = np.sort(rng.choice(len(data), size=n_keep, replace=False))
            data = [data[i] for i in keep]

        if config.deduplicate:
            seen = set()
            unique = []
            for rec in data:
                if rec[0] not in seen:
                    seen.add(rec[0])
                    unique.append(rec)
            if len(unique) < len(data):
                logger.info(
                    "%s: dropped %d duplicate sequences", fasta_path,
                    len(data) - len(unique),
                )
            data = unique

        if config.is_train and config.max_sequence_length:
            n0 = len(data)
            data = [r for r in data if len(r[0]) <= config.max_sequence_length]
            if len(data) < n0:
                logger.info(
                    "%s: dropped %d sequences > %d AA", fasta_path,
                    n0 - len(data), config.max_sequence_length,
                )
        self.data: List[Tuple[str, str, List[str]]] = data

        # ---------------- vocabularies ----------------
        if vocabularies is None:
            vocabularies = generate_vocabularies(data=data)
        self.amino_acid_vocabulary: List[str] = list(vocabularies["amino_acid_vocab"])
        self.label_vocabulary: List[str] = list(vocabularies["label_vocab"])
        self.sequence_id_vocab: List[str] = list(vocabularies.get("sequence_id_vocab", []))

        # labels present in THIS file (reference represented_vocabulary_mask,
        # datasets.py:189-191)
        self.label_frequency: Counter = Counter(
            l for _, _, labels in data for l in labels
        )
        if config.remove_unrepresented_labels:
            self.label_vocabulary = [
                l for l in self.label_vocabulary if l in self.label_frequency
            ]
        self.label2int, self.int2label = get_vocab_mappings(self.label_vocabulary)
        self.represented_vocabulary_mask = np.array(
            [l in self.label_frequency for l in self.label_vocabulary], dtype=bool
        )

        # ---------------- sequence encoding (once) ----------------
        self.lut = make_residue_lut(self.amino_acid_vocabulary)
        num_aa = len(self.amino_acid_vocabulary)
        self.pad_id = num_aa  # one-hot of pad/unknown is the zero vector
        encoded: List[np.ndarray] = []
        for seq, _, _ in data:
            ids = self.lut[np.frombuffer(seq.encode(), dtype=np.uint8)]
            encoded.append(np.where(ids < 0, num_aa, ids).astype(np.int8))
        self.encoded = encoded
        self.lengths = np.array([len(e) for e in encoded], dtype=np.int64)
        self.sequence_ids: List[str] = [sid for _, sid, _ in data]
        self.label_id_lists: List[np.ndarray] = [
            np.array(
                sorted(self.label2int[l] for l in labels if l in self.label2int),
                dtype=np.int32,
            )
            for _, _, labels in data
        ]

        # ---------------- label-embedding view ----------------
        self.label_embedding_cache = label_embedding_cache
        self.label_view: Optional[LabelEmbeddingView] = None
        if label_embedding_cache is not None:
            types = (
                config.label_augmentation_descriptions
                if (config.is_train and config.label_augmentation_descriptions)
                else config.inference_go_descriptions
            )
            self.label_view = LabelEmbeddingView.build(
                label_embedding_cache, self.label_vocabulary, types
            )

        self.mutations: Optional[Blosum62Mutations] = (
            Blosum62Mutations(self.amino_acid_vocabulary)
            if config.augment_residue_probability > 0
            else None
        )

    # ---------------- basic protocol ----------------

    def __len__(self) -> int:
        return len(self.encoded)

    @property
    def num_labels(self) -> int:
        return len(self.label_vocabulary)

    # ---------------- weighting (reference datasets.py:452-532) ----------------

    def calculate_label_counts(self) -> np.ndarray:
        """Raw per-label sample counts in vocabulary order (zeros for
        labels never seen here) — the CBLoss input (reference
        calculate_label_weights with inv_freq=False, normalize=False,
        bin/main.py:480-489)."""
        counts = np.zeros(self.num_labels, dtype=np.float32)
        for ids in self.label_id_lists:
            counts[ids] += 1
        return counts

    def calculate_label_weights(self, power: float = 0.5) -> np.ndarray:
        """Inverse-frequency label weights ((total/count)^power, mean-1
        normalised over represented labels; reference calculate_label_weights,
        datasets.py:466-507)."""
        counts = np.zeros(self.num_labels, dtype=np.float64)
        for ids in self.label_id_lists:
            counts[ids] += 1
        present = counts > 0
        weights = np.zeros(self.num_labels, dtype=np.float64)
        total = counts[present].sum()
        weights[present] = (total / counts[present]) ** power
        if present.any():
            weights[present] /= weights[present].mean()
        return weights

    def calculate_sequence_weights(
        self, label_weights: np.ndarray, agg: str = "sum"
    ) -> np.ndarray:
        """Per-sequence sampling weight aggregated from its labels' weights
        (SEQUENCE_WEIGHT_AGG sum|mean; reference calculate_sequence_weights,
        datasets.py:510-532)."""
        out = np.zeros(len(self), dtype=np.float64)
        for i, ids in enumerate(self.label_id_lists):
            if len(ids) == 0:
                continue
            w = label_weights[ids]
            out[i] = w.sum() if agg == "sum" else w.mean()
        if out.sum() <= 0:
            out[:] = 1.0
        return out

    # ---------------- augmentation ----------------

    def augment_residues(self, ids: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """BLOSUM62 residue substitution on an encoded id array (train only);
        pad/unknown ids are left untouched."""
        if self.mutations is None:
            return ids
        return self.mutations.augment_ids(
            ids, self.cfg.augment_residue_probability, rng
        )
