"""Copy of ``protnote_tpu/data/vocab.py`` for the port.

Vocabulary construction (reference generate_vocabularies /
get_vocab_mappings, protnote/utils/data.py:99-151): sorted-set vocabularies
for amino acids, labels, and sequence ids, plus bidirectional mappings."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# The 20 standard amino acids (reference COMMON_AMINOACIDS, data.py:24-45).
COMMON_AMINOACIDS = [
    "A", "C", "D", "E", "F", "G", "H", "I", "K", "L",
    "M", "N", "P", "Q", "R", "S", "T", "V", "W", "Y",
]


def generate_vocabularies(
    data: Optional[Sequence] = None, file_path: Optional[str] = None
) -> Dict[str, List[str]]:
    """Build sorted vocabularies from FASTA records or a FASTA file.

    Returns ``{"amino_acid_vocab", "label_vocab", "sequence_id_vocab"}`` —
    same keys/roles as the reference (data.py:123-151), sorted for
    deterministic id assignment.
    """
    if data is None:
        if file_path is None:
            raise ValueError("pass either data records or file_path")
        from protnote_tpu_torch.data.fasta import read_fasta

        data = read_fasta(file_path)
    amino_acids: set = set()
    labels: set = set()
    seq_ids: List[str] = []
    for seq, seq_id, seq_labels in data:
        amino_acids.update(seq)
        labels.update(seq_labels)
        seq_ids.append(seq_id)
    return {
        "amino_acid_vocab": sorted(amino_acids),
        "label_vocab": sorted(labels),
        "sequence_id_vocab": sorted(set(seq_ids)),
    }


def get_vocab_mappings(vocabulary: Iterable[str]) -> Tuple[Dict[str, int], Dict[int, str]]:
    """term->id and id->term mappings; raises on duplicate terms
    (reference's uniqueness assertion, data.py:117)."""
    vocabulary = list(vocabulary)
    if len(set(vocabulary)) != len(vocabulary):
        raise ValueError("vocabulary contains duplicate terms")
    term2int = {term: i for i, term in enumerate(vocabulary)}
    int2term = {i: term for term, i in term2int.items()}
    return term2int, int2term
