"""Serve a ProtNote model over HTTP from the PyTorch port, on one CUDA card.

``python -m protnote_tpu_torch.cli.serve --port 8000``

Loads the label-embedding cache once, builds the port's ``ServingEngine``
(label latents precomputed once), optionally warms every bucket up
(--warmup), then serves through the stdlib front end of
:mod:`protnote_tpu_torch.serving_http`:

    POST /v1/predict  {"sequences": ["MKVL..."], "top_k": 10}
    POST /v1/reload   {"model_file": "other.ckpt"}
    GET  /healthz

ProteInfer weights come from the reference TF pickle when the configured file
exists, else from a seeded random init, as in ``protnote_tpu.cli.serve``;
ProtNote weights are a seeded random init unless ``--model-file`` names a
``PNTPU1`` checkpoint (``.ckpt``) or a reference ``.pt`` file, loaded
through ``Trainer.load`` (:func:`protnote_tpu_torch.cli._model_setup.
build_inference_model`).  ``/v1/reload`` restores another checkpoint the
same way and swaps it into the engine; in-flight requests finish on the old
weights.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def build_engine(args):
    """Config + label cache + checkpoint -> ``(engine, trainer)``: the
    port's ServingEngine and the trainer whose ``load`` a reload goes
    through."""
    from protnote_tpu_torch.cli._model_setup import build_inference_model
    from protnote_tpu_torch.core.config import DEFAULT_CONFIG_PATH, get_setup
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache, LabelEmbeddingView
    from protnote_tpu_torch.serving import ServingEngine

    config, run_name, log = get_setup(
        config_path=args.config or DEFAULT_CONFIG_PATH, run_name=args.name,
        overrides=args.override, annotations_path_name=args.annotations_path_name,
        base_label_embedding_name=args.base_label_embedding_name)
    params = config["params"]
    cache = LabelEmbeddingCache.load(config["LABEL_EMBEDDING_PATH"],
                                     config["LABEL_EMBEDDING_INDEX_PATH"])
    vocab = sorted(set(cache.ids))
    descriptions = params.get("INFERENCE_GO_DESCRIPTIONS", "name+label").split("+")
    view = LabelEmbeddingView.build(cache, vocab, descriptions)
    label_matrix = view.embeddings[view.first_k_rows(len(descriptions))]

    pi_cfg, pn_cfg, trainer = build_inference_model(
        config, params, config["paths_resolved"], cache, run_name, args.model_file, None, log,
        device=args.device)
    engine = ServingEngine(
        trainer.ts, pi_cfg, pn_cfg, label_matrix, vocab,
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
    return engine, trainer


def make_reload_fn(engine, trainer):
    """``path -> None`` for ``POST /v1/reload``: a checksum-verified restore
    into the trainer's template (``Trainer.load``), then the engine's atomic
    ``(ts, latents)`` swap."""
    def reload_fn(path: str) -> None:
        trainer.load(path)
        engine.reload(trainer.ts)

    return reload_fn


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-file", default=None,
                    help="checkpoint to load (.ckpt of the JAX package, .pt reference)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--name", default="serve")
    ap.add_argument("--override", nargs="*", default=None)
    ap.add_argument("--annotations-path-name", default="GO_ANNOTATIONS_PATH")
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
    engine, trainer = build_engine(args)
    if args.warmup:
        engine.warmup()
    server, batcher = make_http_server(engine, port=args.port, host=args.host,
                                       max_wait_ms=args.max_wait_ms,
                                       reload_fn=make_reload_fn(engine, trainer))
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
