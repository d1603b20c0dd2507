"""Serve a ProtNote model over HTTP from the PyTorch port, on one CUDA card.

``python -m protnote_tpu_torch.cli.serve --port 8000``

Loads the label-embedding cache once, builds the port's ``ServingEngine``
(label latents precomputed once), optionally warms every bucket up
(--warmup), then serves through the JAX package's engine-agnostic stdlib
front end:

    POST /v1/predict  {"sequences": ["MKVL..."], "top_k": 10}
    GET  /healthz

ProteInfer weights come from the reference TF pickle when the configured file
exists, else from a seeded random init, as in ``protnote_tpu.cli.serve``;
ProtNote weights are a seeded random init until the port reads the JAX
package's checkpoints (``--model-file`` raises until then).
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)


def build_models(config: dict, label_dim: int, log=logger):
    """-> (pi_cfg, pn_cfg, ts): full-size configs from the resolved config
    sections and the parameter bundle on the CPU (the model half of the JAX
    ``cli/_model_setup.build_inference_model``, without the Trainer)."""
    import torch

    from protnote_tpu.cli._model_setup import resolve_label_tile
    from protnote_tpu_torch.models.convert import proteinfer_from_tf_pickle
    from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer

    params = config["params"]
    esp = config.get("embed_sequences_params", {})
    mixed = params.get("MIXED_PRECISION", True)
    pi_cfg = ProteInferConfig(
        input_channels=esp.get("INPUT_CHANNELS", 20),
        output_channels=esp.get("OUTPUT_CHANNELS", 1100),
        kernel_size=esp.get("KERNEL_SIZE", 9),
        dilation_base=esp.get("DILATION_BASE", 3),
        num_resnet_blocks=esp.get("NUM_RESNET_BLOCKS", 5),
        bottleneck_factor=esp.get("BOTTLENECK_FACTOR", 0.5),
        num_labels=esp.get("PROTEINFER_NUM_GO_LABELS", 32102),
        compute_dtype=torch.bfloat16 if mixed else None,
    )
    pn_cfg = ProtNoteConfig.from_params(
        params, protein_embedding_dim=pi_cfg.output_channels,
        label_embedding_dim=label_dim,
        inference_descriptions_per_label=len(
            params.get("INFERENCE_GO_DESCRIPTIONS", "name+label").split("+")),
        label_tile=resolve_label_tile(params),
        compute_dtype=torch.bfloat16 if mixed else torch.float32,
    )
    pi_weights = config.get("paths_resolved", {}).get("PROTEINFER_GO_WEIGHTS_PATH")
    if pi_weights and os.path.exists(pi_weights):
        pi_params, pi_state = proteinfer_from_tf_pickle(pi_weights, pi_cfg)
    else:
        log.warning("ProteInfer weights unavailable; random init")
        pi_params, pi_state = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    pn_params, pn_state = init_protnote(torch.Generator().manual_seed(1), pn_cfg)
    ts = {"trainable": {"protnote": pn_params}, "model_state": pn_state,
          "enc_params": pi_params, "enc_state": pi_state}
    return pi_cfg, pn_cfg, ts


def build_engine(args):
    """Config + label cache -> the port's ServingEngine."""
    from protnote_tpu.core.config import (
        DEFAULT_CONFIG_PATH,
        generate_label_embedding_path,
        label_embedding_index_path,
        load_config,
        override_config,
        resolve_paths,
    )
    from protnote_tpu.data.label_cache import LabelEmbeddingCache, LabelEmbeddingView
    from protnote_tpu_torch.serving import ServingEngine

    if args.model_file:
        raise NotImplementedError(
            "--model-file: the port does not read PNTPU1 checkpoints yet")
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
    return ServingEngine(
        ts, pi_cfg, pn_cfg, label_matrix, vocab,
        buckets=tuple(params.get("SEQUENCE_BUCKETS", (256, 512, 1024, 2048, 4096))),
        max_batch=args.max_batch or params.get("TEST_BATCH_SIZE", 32),
        device=args.device,
    )


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-file", default=None,
                    help="not supported yet: the port does not read PNTPU1 "
                         "checkpoints")
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
