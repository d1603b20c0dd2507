"""Model construction shared by the port's CLIs (``cli/main.py``,
``cli/serve.py``).

Port of the model half of ``protnote_tpu/cli/_model_setup.py`` and of
``cli/main.py:160-198,316-335``: full-size configs from the resolved config
sections, ProteInfer weights from the reference TF pickle when present (a
seeded random init otherwise), ProtNote from a seeded random init, and
weights from a ``--model-file``: a ``PNTPU1`` checkpoint of the JAX package
(``.ckpt``) or a reference ``.pt`` file.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def resolve_label_tile(params: dict) -> int:
    """Label tile of the pair scorer (copy of
    ``protnote_tpu/cli/_model_setup.py:resolve_label_tile``).

    ``LABEL_TILE_SIZE`` is the knob.  The reference's inference lever is
    ``LABEL_BATCH_SIZE_LIMIT_NO_GRAD`` (the no-grad label chunk, a memory
    cap): when ``LABEL_TILE_SIZE`` is left at its default 512 and the
    legacy key is set, its value is honoured rounded down to a multiple of
    128, and values below 128 clamp up to 128."""
    tile = params.get("LABEL_TILE_SIZE", 512)
    legacy = params.get("LABEL_BATCH_SIZE_LIMIT_NO_GRAD")
    if legacy and tile == 512:
        tile = max(128, (int(legacy) // 128) * 128)
    return int(tile)


def build_models(config: dict, label_dim: int, num_aa: int = 0,
                 seed: Optional[int] = None, gate_pretrained: bool = False,
                 train_sequence_encoder: bool = False, log=logger):
    """-> (pi_cfg, pn_cfg, ts): configs and the parameter bundle on the CPU.

    ``num_aa``: the dataset's amino-acid vocabulary size (the encoder takes
    at least that many input channels, as in the JAX ``cli/main.py``).
    ``seed``: ProteInfer is initialised from ``seed`` and ProtNote from
    ``seed + 1`` (None: 0 and 1, as the JAX serve CLI).  ``gate_pretrained``:
    load the TF pickle only when ``PRETRAINED_SEQUENCE_ENCODER`` is set (the
    JAX ``cli/main.py``; the serve CLI loads it whenever it exists).
    ``train_sequence_encoder``: the encoder lives in ``trainable["encoder"]``
    (``enc_params`` None), the layout of a checkpoint trained with
    ``TRAIN_SEQUENCE_ENCODER``."""
    from protnote_tpu_torch.models.convert import proteinfer_from_tf_pickle
    from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer

    params = config["params"]
    esp = config.get("embed_sequences_params", {})
    mixed = params.get("MIXED_PRECISION", True)
    pi_cfg = ProteInferConfig(
        input_channels=max(esp.get("INPUT_CHANNELS", 20), num_aa),
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
    pi_seed, pn_seed = (0, 1) if seed is None else (seed, seed + 1)
    pi_weights = config.get("paths_resolved", {}).get("PROTEINFER_GO_WEIGHTS_PATH")
    wanted = params.get("PRETRAINED_SEQUENCE_ENCODER") or not gate_pretrained
    if wanted and pi_weights and os.path.exists(pi_weights):
        log.info("loading ProteInfer weights from %s", pi_weights)
        pi_params, pi_state = proteinfer_from_tf_pickle(pi_weights, pi_cfg)
    else:
        log.warning("ProteInfer weights unavailable; random init")
        pi_params, pi_state = init_proteinfer(torch.Generator().manual_seed(pi_seed), pi_cfg)
    pn_params, pn_state = init_protnote(torch.Generator().manual_seed(pn_seed), pn_cfg)
    trainable: Dict[str, Any] = {"protnote": pn_params}
    if train_sequence_encoder:
        trainable["encoder"] = pi_params
    ts = {"trainable": trainable, "model_state": pn_state,
          "enc_params": None if train_sequence_encoder else pi_params,
          "enc_state": pi_state}
    return pi_cfg, pn_cfg, ts


def load_model_file(ts: Dict[str, Any], path: str, pi_cfg, pn_cfg, optimizer=None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(ts, meta)``: the bundle ``ts`` with the weights of ``path``.

    ``*.pt``: a reference ProtNote checkpoint, mapped by module name; an
    embedded ``sequence_encoder`` replaces the encoder (in
    ``trainable["encoder"]`` when that slot exists, as the JAX CLI does).
    Anything else: a ``PNTPU1`` checkpoint restored into ``ts``'s structure
    (shapes checked, dtypes of ``ts`` kept); when ``ts`` holds ``step`` and
    ``opt_state``, the checkpoint's (optax's Adam moments and accumulation
    state) replace them, checked against ``optimizer``'s config."""
    from protnote_tpu_torch.core.checkpoint import merge_into_template, read_checkpoint
    from protnote_tpu_torch.models.convert import load_reference_checkpoint, opt_state_from_jax

    if not os.path.exists(path):
        raise FileNotFoundError(f"--model-file {path!r} does not exist")
    if not path.endswith(".pt"):
        stored, meta = read_checkpoint(path)
        weights = {k: v for k, v in ts.items() if k not in ("opt_state", "step")}
        out = dict(ts, **merge_into_template(weights, stored))
        if "step" in ts and "step" in stored:
            out["step"] = int(stored["step"])
        if "opt_state" in ts and "opt_state" in stored:
            out["opt_state"] = opt_state_from_jax(stored["opt_state"], out["trainable"])
            _check_opt_state(out["opt_state"], optimizer, path)
        return out, meta
    params, state, encoder, meta = load_reference_checkpoint(path, pn_cfg, pi_cfg)
    ts = dict(ts, trainable=dict(ts["trainable"], protnote=params), model_state=state)
    if encoder is not None:
        enc_p, enc_s = encoder
        if "encoder" in ts["trainable"]:
            ts["trainable"]["encoder"] = enc_p
        else:
            ts["enc_params"] = enc_p
        ts["enc_state"] = enc_s
    return ts, meta


def _check_opt_state(state: Dict[str, Any], optimizer, path: str) -> None:
    if optimizer is None:
        return
    if (state["mu"] is not None) != optimizer.adam or \
            ("mini_step" in state) != (optimizer.accum > 1):
        raise ValueError(f"{path}: the optimizer state does not fit OPTIMIZER="
                         f"{optimizer.name}, GRADIENT_ACCUMULATION_STEPS={optimizer.accum}")
