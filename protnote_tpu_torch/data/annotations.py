"""Label-description cleaning for the label-embedding generator.

Copy of ``remove_obsolete_from_string`` and its regex from
``protnote_tpu/data/annotations.py`` (the port imports nothing of the JAX
package); the OBO and EC parsers there are not needed by the port.
"""

from __future__ import annotations

import re

_OBSOLETE_PREFIX_RE = re.compile(r"^\s*obsolete\.?\s*", re.IGNORECASE)


def remove_obsolete_from_string(text: str) -> str:
    """Strip a leading 'OBSOLETE.' marker from a description (reference
    bin/generate_label_embeddings.py strips the token before embedding)."""
    return _OBSOLETE_PREFIX_RE.sub("", text).strip()
