"""Serve a ProtNote model over HTTP from the PyTorch port, on one CUDA card.

``python -m protnote_tpu_torch.cli.serve --port 8000``

Loads the label-embedding cache once, builds the port's ``ServingEngine``
(label latents precomputed once), optionally warms every bucket up
(--warmup), then serves through the stdlib front end of
:mod:`protnote_tpu_torch.serving_http`:

    POST /v1/predict  {"sequences": ["MKVL..."], "top_k": 10}
    GET  /healthz

ProteInfer weights come from the reference TF pickle when the configured file
exists, else from a seeded random init, as in ``protnote_tpu.cli.serve``;
ProtNote weights are a seeded random init unless ``--model-file`` names a
``PNTPU1`` checkpoint of the JAX package (``.ckpt``) or a reference ``.pt``
file (:mod:`protnote_tpu_torch.cli._model_setup`).
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def build_engine(args):
    """Config + label cache -> the port's ServingEngine."""
    from protnote_tpu_torch.core.config import (
        DEFAULT_CONFIG_PATH,
        generate_label_embedding_path,
        label_embedding_index_path,
        load_config,
        override_config,
        resolve_paths,
    )
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache, LabelEmbeddingView
    from protnote_tpu_torch.cli._model_setup import build_models, load_model_file
    from protnote_tpu_torch.serving import ServingEngine

    config = resolve_paths(override_config(
        load_config(args.config or DEFAULT_CONFIG_PATH), args.override))
    params = config["params"]
    emb_path = generate_label_embedding_path(
        params, config["paths_resolved"][args.base_label_embedding_name])
    cache = LabelEmbeddingCache.load(emb_path, label_embedding_index_path(emb_path))
    vocab = sorted(set(cache.ids))
    descriptions = params.get("INFERENCE_GO_DESCRIPTIONS", "name+label").split("+")
    view = LabelEmbeddingView.build(cache, vocab, descriptions)
    label_matrix = view.embeddings[view.first_k_rows(len(descriptions))]

    pi_cfg, pn_cfg, ts = build_models(config, cache.dim)
    if args.model_file:
        ts, _ = load_model_file(ts, args.model_file, pi_cfg, pn_cfg)
    engine = ServingEngine(
        ts, pi_cfg, pn_cfg, label_matrix, vocab,
        buckets=tuple(params.get("SEQUENCE_BUCKETS", (256, 512, 1024, 2048, 4096))),
        max_batch=args.max_batch or params.get("TEST_BATCH_SIZE", 32),
        device=args.device,
    )
    if args.calibration_fasta:
        # int8 scales from real sequences (warmup refuses to calibrate on
        # its synthetic motif; see ServingEngine.calibrate_from)
        from protnote_tpu_torch.data.fasta import read_fasta

        seqs = [r[0] for r in read_fasta(args.calibration_fasta)]
        if not seqs:
            raise ValueError(f"{args.calibration_fasta}: no sequences")
        engine.calibrate_from(seqs)
    return engine


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-file", default=None,
                    help="checkpoint to load (.ckpt of the JAX package, .pt reference)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--override", nargs="*", default=None)
    ap.add_argument("--base-label-embedding-name",
                    default="GO_BASE_LABEL_EMBEDDING_PATH")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    ap.add_argument("--calibration-fasta", default=None,
                    help="real sequences for int8 activation-scale calibration at "
                         "startup (required for --warmup with PAIR_BACKEND=tiled_int8 "
                         "and no INT8_ACT_SCALES)")
    ap.add_argument("--warmup", action="store_true",
                    help="score every bucket shape once before accepting traffic")
    return ap


def main(argv=None):
    from protnote_tpu_torch.serving import make_http_server

    logging.basicConfig(level=logging.INFO)
    args = build_argparser().parse_args(argv)
    engine = build_engine(args)
    if args.warmup:
        engine.warmup()
    server, batcher = make_http_server(engine, port=args.port, host=args.host,
                                       max_wait_ms=args.max_wait_ms)
    logger.info("serving %d labels on http://%s:%d (backend=%s, device=%s)",
                len(engine.label_vocabulary), args.host, args.port,
                engine.pn_cfg.pair_backend, engine.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
