"""Checkpoint conversion with the PyTorch port, without jax:

- a reference torch ``.pt`` (ProtNote DDP checkpoints) -> a ``PNTPU1``
  ``.ckpt`` in the JAX train-state layout, so published seed-replicate
  weights drop into either package;
- a reference TF1 ProteInfer pickle -> a ``PNTPU1`` encoder checkpoint
  (``{"params", "state"}``).

Usage (the argument surface of ``protnote_tpu.cli.convert_checkpoint``):

  python -m protnote_tpu_torch.cli.convert_checkpoint protnote \\
      --input seed_replicates_v9_12_sum_last_epoch.pt --output seed12.ckpt
  python -m protnote_tpu_torch.cli.convert_checkpoint proteinfer \\
      --input GO_model_weights13703706.pkl --output proteinfer_go.ckpt

The files read back through the JAX package's ``restore_checkpoint``; a
``.pt`` without an embedded ``sequence_encoder`` gets a seeded random
encoder (torch's generator: other numbers than the JAX CLI's init).
"""

from __future__ import annotations

import argparse
import logging

import torch

logger = logging.getLogger(__name__)


def build_argparser() -> argparse.ArgumentParser:
    from protnote_tpu_torch.core.config import DEFAULT_CONFIG_PATH

    ap = argparse.ArgumentParser(description="Checkpoint conversion (PyTorch port)")
    ap.add_argument("kind", choices=["protnote", "proteinfer"])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--config", default=str(DEFAULT_CONFIG_PATH))
    ap.add_argument("--override", nargs="*", default=None)
    ap.add_argument("--input-channels", type=int, default=None,
                    help="one-hot width of the runtime model; cli/main.py "
                         "uses max(INPUT_CHANNELS, len(amino-acid vocab)), "
                         "so pass the runtime value when the dataset carries "
                         "nonstandard residues (B/O/U/X/Z)")
    return ap


def main(argv=None) -> None:
    from protnote_tpu_torch.cli._model_setup import proteinfer_config
    from protnote_tpu_torch.core.checkpoint import save_checkpoint
    from protnote_tpu_torch.core.config import load_config, override_config
    from protnote_tpu_torch.models.convert import (
        _to_numpy,
        load_reference_checkpoint,
        proteinfer_from_tf_pickle,
        to_jax_tree,
    )
    from protnote_tpu_torch.models.fusion import ProtNoteConfig
    from protnote_tpu_torch.models.proteinfer import init_proteinfer
    from protnote_tpu_torch.train.optim import Optimizer
    from protnote_tpu_torch.train.step import init_train_state

    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = override_config(load_config(args.config), args.override)
    params_cfg, esp = cfg["params"], cfg["embed_sequences_params"]
    pi_cfg = proteinfer_config(esp, args.input_channels)

    if args.kind == "proteinfer":
        params, state = proteinfer_from_tf_pickle(args.input, pi_cfg)
        save_checkpoint(args.output, _to_numpy({"params": params, "state": state}), epoch=0,
                        extra={"source": args.input, "kind": "proteinfer"})
        logger.info("wrote %s", args.output)
        return

    pn_cfg = ProtNoteConfig.from_params(params_cfg, protein_embedding_dim=pi_cfg.output_channels)
    pn_params, pn_state, encoder, meta = load_reference_checkpoint(args.input, pn_cfg, pi_cfg)
    if encoder is not None:
        enc_params, enc_state = encoder
    else:
        logger.warning("checkpoint has no sequence_encoder; random encoder init")
        enc_params, enc_state = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    optimizer = Optimizer(params_cfg)
    ts = init_train_state(pn_params, pn_state, enc_params, enc_state, optimizer)
    save_checkpoint(args.output, to_jax_tree(ts, optimizer), epoch=meta.get("epoch") or 0,
                    best_val_metric=meta.get("best_val_metric"),
                    extra={"source": args.input, "kind": "protnote"})
    logger.info("wrote %s (epoch=%s best=%s)", args.output, meta.get("epoch"),
                meta.get("best_val_metric"))


if __name__ == "__main__":
    main()
