"""Offline label-embedding cache generator.

Port of ``protnote_tpu/cli/generate_label_embeddings.py`` (reference
bin/generate_label_embeddings.py:25-166): flatten each annotation's name /
label / exact synonyms into one row per description, strip 'obsolete',
optionally prefix the E5 instruction, embed with the frozen text encoder,
and save embeddings + index with ``LabelEmbeddingCache.save``.

``--backend native`` runs the port's own tower (the JAX CLI's ``jax``
backend), in float32 on every device as the JAX CLI computes it (on the
card through the float32 attention and LayerNorm kernels), ``torch`` HF
transformers' AutoModel; both read the HF checkpoint from local files.
``--encoder hash`` needs no checkpoint.

Usage:
  python -m protnote_tpu_torch.cli.generate_label_embeddings \\
      --annotations data/annotations/go_annotations_jul_2024.pkl \\
      --base-label-embedding-name GO_BASE_LABEL_EMBEDDING_PATH \\
      --backend native [--add-instruction] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Tuple

import numpy as np

from protnote_tpu_torch.core.config import (
    DEFAULT_CONFIG_PATH,
    generate_label_embedding_path,
    load_config,
    override_config,
    resolve_paths,
)
from protnote_tpu_torch.data.annotations import remove_obsolete_from_string
from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache
from protnote_tpu_torch.models.label_encoder import E5_INSTRUCTION, build_label_encoder

logger = logging.getLogger(__name__)

DESCRIPTION_TYPES = ("name", "label", "synonym_exact")


def flatten_annotations(df) -> Tuple[List[str], List[str], List[str]]:
    """annotation table -> (ids, description_types, descriptions); one row
    per individual description string (synonym lists are exploded)."""
    ids, dtypes, texts = [], [], []
    for go_id, row in df.iterrows():
        for dtype in DESCRIPTION_TYPES:
            if dtype not in row:
                continue
            value = row[dtype]
            values = value if isinstance(value, (list, tuple, np.ndarray)) else [value]
            for v in values:
                if v is None or (isinstance(v, float) and np.isnan(v)) or v == "":
                    continue
                ids.append(go_id)
                dtypes.append(dtype)
                texts.append(remove_obsolete_from_string(str(v)).strip())
    return ids, dtypes, texts


def load_annotations(path: str):
    import pandas as pd

    if path.endswith(".pkl"):
        return pd.read_pickle(path)
    if path.endswith(".parquet"):
        return pd.read_parquet(path)
    raise ValueError(f"unsupported annotations format: {path}")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=str(DEFAULT_CONFIG_PATH))
    ap.add_argument("--annotations", default=None,
                    help="annotations pickle/parquet; default from config")
    ap.add_argument("--annotations-path-name", default="GO_ANNOTATIONS_PATH")
    ap.add_argument("--base-label-embedding-name",
                    default="GO_BASE_LABEL_EMBEDDING_PATH")
    ap.add_argument("--add-instruction", action="store_true",
                    help="prefix the E5 retrieval instruction")
    ap.add_argument("--no-account-for-sos", action="store_true")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--encoder", default=None,
                    help="override LABEL_ENCODER_CHECKPOINT (e.g. 'hash')")
    ap.add_argument("--backend", choices=["torch", "native"], default="torch",
                    help="native = the port's text tower (attention and LayerNorm "
                         "kernels on the card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoder (default: cuda)")
    ap.add_argument("--override", nargs="*", default=None)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config)
    override_config(config, args.override)
    resolve_paths(config)
    params = config["params"]
    if args.encoder:
        params["LABEL_ENCODER_CHECKPOINT"] = args.encoder

    ann_path = args.annotations or config["paths_resolved"][args.annotations_path_name]
    df = load_annotations(ann_path)
    ids, dtypes, texts = flatten_annotations(df)
    logger.info("%d description rows from %d annotations", len(texts), len(df))

    encoder = build_label_encoder(
        params["LABEL_ENCODER_CHECKPOINT"],
        pooling_method=params["LABEL_EMBEDDING_POOLING_METHOD"],
        device=args.device,
        backend=args.backend,
    )
    if encoder.checkpoint != params["LABEL_ENCODER_CHECKPOINT"]:
        # fallback happened -- name the cache after the encoder actually used
        logger.warning(
            "cache will be named after fallback encoder %r", encoder.checkpoint
        )
        params["LABEL_ENCODER_CHECKPOINT"] = encoder.checkpoint
    embed_texts = (
        [E5_INSTRUCTION + t for t in texts] if args.add_instruction else texts
    )
    # counts describe the tokenization that PRODUCED the embeddings: with
    # --add-instruction that includes the instruction prefix
    token_counts = encoder.token_counts(embed_texts)
    embeddings = encoder.embed(
        embed_texts, batch_size=args.batch_size,
        account_for_sos=not args.no_account_for_sos,
    )

    base = config["paths_resolved"][args.base_label_embedding_name]
    out_path = generate_label_embedding_path(params, base)
    LabelEmbeddingCache.save(out_path, embeddings, ids, dtypes, texts, token_counts)
    logger.info("wrote %s (%s rows x %s dims)", out_path, *embeddings.shape)
    return out_path


if __name__ == "__main__":
    main()
