"""Batched inference with the PyTorch port: score every sequence of a
(possibly unlabeled) FASTA against the full label vocabulary and stream
float16 logits to parquet shards, so a whole-SwissProt output never lives in
memory at once.

    python -m protnote_tpu_torch.cli.predict --fasta seqs.fasta --model-file run.ckpt

The argument surface of ``protnote_tpu.cli.predict``, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions, for tests).
The label vocabulary is every id of the label-embedding cache; batches come
from the port's ``BucketBatcher`` -> ``PrefetchBatcher`` with the label
matrix resident on the device; int8 (``PAIR_BACKEND tiled_int8``)
calibrates its static scales on the first batch unless ``INT8_ACT_SCALES``
is given or ``INT8_CALIBRATE`` is False; the label latents are projected
once and every batch runs the eval step (K7's encoder, then K1 or K2).
Shards ``predict_logits_{run_name}_{NNNNN}.parquet`` hold at least
``--rows-per-shard`` rows (whole batches), indexed by sequence id, one
column a label, as the JAX CLI writes them; the last line of stdout is its
JSON summary.  ``--mesh-label`` above 1 and ``--distributed`` with its
coordinator flags raise: several cards come with the multi-GPU slice.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

MULTI_GPU = ("{} is not ported: several cards come with the multi-GPU slice "
             "(ROADMAP.md queue 1, item 9)")


def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's arguments, plus ``--device``."""
    ap = argparse.ArgumentParser(description="ProtNote batched inference (PyTorch port)")
    ap.add_argument("--fasta", required=True, help="input sequences (labels optional)")
    ap.add_argument("--model-file", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--name", default="predict")
    ap.add_argument("--override", nargs="*", default=None)
    ap.add_argument("--annotations-path-name", default="GO_ANNOTATIONS_PATH")
    ap.add_argument("--base-label-embedding-name", default="GO_BASE_LABEL_EMBEDDING_PATH")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--rows-per-shard", type=int, default=10000)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--mesh-label", type=int, default=None)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator-address", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and every batch (default: cuda)")
    return ap


def refuse_unported(args, params: dict) -> None:
    """Raise ``NotImplementedError`` for a label mesh or several processes."""
    if args.mesh_label not in (None, 1) or (params.get("MESH_LABEL") or 0) > 1:
        raise NotImplementedError(MULTI_GPU.format("a label mesh (--mesh-label)"))
    coordinator = (args.coordinator_address, args.num_processes, args.process_id)
    if args.distributed or any(v is not None for v in coordinator):
        raise NotImplementedError(MULTI_GPU.format("multi-process inference (--distributed)"))


@torch.inference_mode()
def score_batches(trainer, batcher, label_matrix) -> Iterator[Tuple[np.ndarray, List[str],
                                                                     np.ndarray]]:
    """Per batch: ``(logits, sequence_ids, columns)``, the float16 logits of
    the batch's real rows at its valid label columns, their sequence ids,
    and those columns' indices in the label vocabulary.  The caller
    calibrates int8 scales first (``trainer.ensure_int8_calibrated``, as
    ``main`` does before its timed window); the label latents are projected
    once (the layout of an inference batcher does not change)."""
    from protnote_tpu_torch.train.step import batch_to_device_dict

    latents, columns = None, None
    latents_ok = trainer._latents_eligible(batcher)
    for batch in batcher:
        arrays = trainer._place(batch_to_device_dict(batch, trainer.device), label_matrix,
                                batch)
        if latents_ok and "label_rows" in arrays:
            if latents is None:
                latents = trainer._label_latents(arrays)
            arrays = trainer._swap_in_latents(arrays, latents)
        logits = trainer._eval_step(trainer.ts, arrays)["logits"].float().cpu().numpy()
        keep = np.asarray(batch.example_mask, bool)
        if columns is None:
            valid = (np.asarray(batch.label_mask, bool) if batch.label_mask is not None
                     else np.ones(logits.shape[1], bool))
            columns = np.flatnonzero(valid)
        ids = [s for s, k in zip(batch.sequence_ids, keep) if k]
        yield logits[keep][:, columns].astype(np.float16), ids, columns


def write_shards(scored, vocab: Sequence[str], out_dir: str, run_name: str,
                 rows_per_shard: int) -> int:
    """Write the ``(logits, sequence_ids, columns)`` of ``scored`` as
    parquet shards of whole batches, a shard once it holds
    ``rows_per_shard`` rows or more; returns the rows written."""
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    rows: List[np.ndarray] = []
    ids: List[str] = []
    shard_no = written = 0
    columns = None

    def flush() -> None:
        nonlocal rows, ids, shard_no
        if not rows:
            return
        df = pd.DataFrame(np.concatenate(rows).astype(np.float32),
                          columns=[vocab[c] for c in columns], index=ids)
        path = os.path.join(out_dir, f"predict_logits_{run_name}_{shard_no:05d}.parquet")
        df.to_parquet(path)
        logger.info("wrote %s (%d rows x %d labels)", path, len(df), len(columns))
        rows, ids = [], []
        shard_no += 1

    for logits, seq_ids, columns in scored:
        rows.append(logits)
        ids.extend(seq_ids)
        written += len(seq_ids)
        if sum(len(r) for r in rows) >= rows_per_shard:
            flush()
    flush()
    return written


def build_predictor(args):
    """``(config, run_name, log, dataset, trainer, batcher, label_matrix,
    vocab)`` for ``args``: the config, the label cache's vocabulary, the
    dataset, the inference model and its batcher."""
    from protnote_tpu_torch.cli._model_setup import build_inference_model
    from protnote_tpu_torch.core.config import DEFAULT_CONFIG_PATH, get_setup
    from protnote_tpu_torch.data.batching import BucketBatcher, PrefetchBatcher
    from protnote_tpu_torch.data.dataset import DatasetConfig, ProteinDataset
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache

    config, run_name, log = get_setup(
        config_path=args.config or DEFAULT_CONFIG_PATH, run_name=args.name,
        overrides=args.override, annotations_path_name=args.annotations_path_name,
        base_label_embedding_name=args.base_label_embedding_name)
    params, paths = config["params"], config["paths_resolved"]
    refuse_unported(args, params)
    cache = LabelEmbeddingCache.load(config["LABEL_EMBEDDING_PATH"],
                                     config["LABEL_EMBEDDING_INDEX_PATH"])
    vocab = sorted(set(cache.ids))  # the full label vocabulary: every id in the cache
    ds = ProteinDataset(
        args.fasta, DatasetConfig.from_params(params, "test"), label_embedding_cache=cache,
        vocabularies={"amino_acid_vocab": sorted("ACDEFGHIKLMNPQRSTVWY"),
                      "label_vocab": vocab, "sequence_id_vocab": []})
    log.info("%d sequences x %d labels", len(ds), ds.num_labels)
    _, pn_cfg, trainer = build_inference_model(config, params, paths, cache, run_name,
                                               args.model_file, None, log, device=args.device)
    batcher = BucketBatcher(
        ds, args.batch_size or params.get("TEST_BATCH_SIZE", 32),
        buckets=tuple(params.get("SEQUENCE_BUCKETS", (256, 512, 1024, 2048, 4096))),
        tokens_per_batch=params.get("TOKENS_PER_BATCH"),
        descriptions_per_label=pn_cfg.inference_descriptions_per_label,
        return_label_multihots=False,
        device_label_gather=bool(params.get("DEVICE_RESIDENT_LABEL_EMBEDDINGS", True)))
    label_matrix = trainer._label_matrix_for(ds)
    prefetch_n = int(params.get("PREFETCH_BATCHES", 2) or 0)
    if prefetch_n > 0:
        batcher = PrefetchBatcher(batcher, prefetch=prefetch_n)
    return config, run_name, log, ds, trainer, batcher, label_matrix, vocab


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = build_argparser().parse_args(argv)
    config, run_name, log, ds, trainer, batcher, label_matrix, vocab = build_predictor(args)
    out_dir = args.output_dir or config["paths_resolved"].get("RESULTS_DIR", "outputs/results")
    trainer.ensure_int8_calibrated(batcher)
    t0 = time.perf_counter()
    written = write_shards(score_batches(trainer, batcher, label_matrix), vocab, out_dir,
                           run_name, args.rows_per_shard)
    dt = time.perf_counter() - t0
    log.info("scored %d sequences in %.1fs (%.1f seqs/s, %.3g pair-scores/s)",
             written, dt, written / dt, written * ds.num_labels / dt)
    summary = {"sequences": written, "labels": ds.num_labels, "seconds": round(dt, 1),
               "seqs_per_sec": round(written / dt, 2)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
