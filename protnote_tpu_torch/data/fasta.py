"""FASTA reading/writing.

Copy of ``protnote_tpu/data/fasta.py`` for the port, which imports nothing
of the JAX package.  The on-disk format matches the reference datasets
(header = sequence id followed by space-separated labels; reference
read_fasta/save_to_fasta, protnote/utils/data.py:81-96,159-181).  Records
are plain tuples ``(sequence, sequence_id, [labels])``.  The JAX package's
native C++ parser is left out: this is its pure-Python path, which computes
the same records (``tests/test_torch_host_copies.py``).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

Record = Tuple[str, str, List[str]]


def _parse_text(text: str, sep: str = " ") -> List[Record]:
    """Parse FASTA text into ``(sequence, id, labels)`` records.

    Multi-line sequences are concatenated; the header's first token is the
    sequence id, remaining tokens are labels.
    """
    records: List[Record] = []
    seq_parts: List[str] = []
    seq_id = ""
    labels: List[str] = []
    started = False
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if started:
                records.append(("".join(seq_parts), seq_id, labels))
            parts = line[1:].split(sep)
            seq_id = parts[0]
            labels = [p for p in parts[1:] if p]
            seq_parts = []
            started = True
        else:
            seq_parts.append(line)
    if started:
        records.append(("".join(seq_parts), seq_id, labels))
    return records


def read_fasta(path: str, sep: str = " ") -> List[Record]:
    """Read a FASTA file into ``(sequence, id, labels)`` records."""
    with open(path, "r") as fh:
        return _parse_text(fh.read(), sep=sep)


def save_to_fasta(records: Iterable[Sequence], path: str, sep: str = " ") -> str:
    """Write ``(sequence, id, labels)`` records as FASTA (one line per
    sequence — what the reference pipeline emits, data.py:159-181)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for seq, seq_id, labels in records:
            header = sep.join([seq_id, *labels]) if labels else seq_id
            fh.write(f">{header}\n{seq}\n")
    return path
