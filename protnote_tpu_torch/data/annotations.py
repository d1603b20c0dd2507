"""Label-description cleaning for the label-embedding generator.

Copy of ``remove_obsolete_from_string`` and its regex, and of
``ec_number_to_code`` (the EC slices of ``evaln/analysis.py``), from
``protnote_tpu/data/annotations.py`` (the port imports nothing of the JAX
package); the OBO and enzclass parsers there are not needed by the port.
"""

from __future__ import annotations

import re
from typing import Tuple

_OBSOLETE_PREFIX_RE = re.compile(r"^\s*obsolete\.?\s*", re.IGNORECASE)


def remove_obsolete_from_string(text: str) -> str:
    """Strip a leading 'OBSOLETE.' marker from a description (reference
    bin/generate_label_embeddings.py strips the token before embedding)."""
    return _OBSOLETE_PREFIX_RE.sub("", text).strip()


def ec_number_to_code(ec_number: str, depth: int = 3) -> Tuple[int, ...]:
    """'1.1.1.4' -> (1, 1, 1); missing levels ('1.-.-.-') are 0
    (reference data.py:359-361)."""
    parts = [int(x) for x in re.findall(r"\d+", ec_number.strip())[:depth]]
    return tuple(parts + [0] * (depth - len(parts)))
