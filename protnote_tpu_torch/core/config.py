"""Configuration: the jax-free functions of ``protnote_tpu/core/config.py``.

Copy for the port, which imports nothing of the JAX package: one YAML with
three sections (``params``, ``embed_sequences_params``, ``paths``), CLI
``--override KEY VALUE ...`` pairs coerced with ``ast.literal_eval``, and
derived label-embedding cache paths keyed by encoder nickname + pooling
method.  ``get_setup`` is left out (it imports jax); the port's CLIs call
:func:`load_config`, :func:`override_config`, :func:`resolve_paths` and
:func:`setup_logging` themselves.  ``DEFAULT_CONFIG_PATH`` is the repo's
``configs/base.yaml``, the file the JAX package reads.
"""

from __future__ import annotations

import ast
import logging
import os
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional

DEFAULT_CONFIG_PATH = Path(__file__).resolve().parent.parent.parent / "configs" / "base.yaml"

# Nicknames used in derived label-embedding cache filenames; matches the
# naming convention of the reference (configs.py:74-107).
_ENCODER_NICKNAMES = {
    "microsoft/biogpt": "BioGPT",
    "intfloat/e5-large-v2": "E5",
    "intfloat/multilingual-e5-large-instruct": "E5multilingual",
    "hash": "HashStub",
}


class Config(dict):
    """Dict with attribute access; sections are plain dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def load_config(path: os.PathLike | str = DEFAULT_CONFIG_PATH) -> Config:
    import yaml

    with open(path, "r") as fh:
        raw = yaml.safe_load(fh)
    cfg = Config(raw)
    cfg.setdefault("params", {})
    cfg.setdefault("embed_sequences_params", {})
    cfg.setdefault("paths", {"data_paths": {}, "output_paths": {}})
    return cfg


def _coerce(value: str) -> Any:
    """Best-effort literal coercion, like the reference override parser,
    plus YAML-style null/true/false so config values round-trip."""
    lowered = value.strip().lower()
    if lowered in ("null", "none", "~"):
        return None
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def override_config(config: Config, overrides: Optional[Iterable[str]]) -> Config:
    """Apply ``KEY VALUE`` pairs to ``config['params']`` (or
    ``embed_sequences_params``); only keys already present may be
    overridden (the reference contract, configs.py:66-71)."""
    if not overrides:
        return config
    overrides = list(overrides)
    if len(overrides) % 2 != 0:
        raise ValueError("--override expects KEY VALUE pairs")
    for key, value in zip(overrides[::2], overrides[1::2]):
        if key in config["params"]:
            section = "params"
        elif key in config.get("embed_sequences_params", {}):
            section = "embed_sequences_params"
        else:
            raise KeyError(f"Unknown override key {key!r}: not in params")
        config[section][key] = _coerce(value) if isinstance(value, str) else value
    return config


def encoder_nickname(checkpoint: str) -> str:
    return _ENCODER_NICKNAMES.get(checkpoint, checkpoint.split("/")[-1].replace("-", ""))


def generate_label_embedding_path(params: Mapping[str, Any], base_label_embedding_path: str) -> str:
    """``<stem>_<ENCODER_NICK>_<POOLING>.npz`` beside the base path
    (analogous to the reference naming scheme, configs.py:74-107)."""
    base = Path(base_label_embedding_path)
    nick = encoder_nickname(params["LABEL_ENCODER_CHECKPOINT"])
    pooling = params["LABEL_EMBEDDING_POOLING_METHOD"]
    return str(base.with_name(f"{base.stem}_{nick}_{pooling}.npz"))


def label_embedding_index_path(embedding_path: str) -> str:
    p = Path(embedding_path)
    return str(p.with_name(p.stem + "_index.parquet"))


def resolve_paths(config: Config, data_root: Optional[str] = None,
                  output_root: Optional[str] = None) -> Config:
    """Join relative data/output paths onto their roots: ``$PROTNOTE_DATA_DIR``
    / ``$PROTNOTE_OUTPUT_DIR`` (or ``AMLT_DATA_DIR`` / ``AMLT_OUTPUT_DIR``,
    configs.py:122-133), else ``./data`` / ``./outputs``."""
    data_root = (
        data_root
        or os.environ.get("PROTNOTE_DATA_DIR")
        or os.environ.get("AMLT_DATA_DIR")
        or "data"
    )
    output_root = (
        output_root
        or os.environ.get("PROTNOTE_OUTPUT_DIR")
        or os.environ.get("AMLT_OUTPUT_DIR")
        or "outputs"
    )
    flat: Dict[str, str] = {}
    for key, rel in config["paths"].get("data_paths", {}).items():
        flat[key] = str(Path(data_root) / rel)
    for key, rel in config["paths"].get("output_paths", {}).items():
        flat[key] = str(Path(output_root) / rel)
    config["paths_resolved"] = flat
    config["DATA_ROOT"] = str(data_root)
    config["OUTPUT_ROOT"] = str(output_root)
    return config


def setup_logging(log_dir: Optional[str], run_name: str, is_master: bool = True) -> logging.Logger:
    logger = logging.getLogger(f"protnote_tpu_torch.{run_name}")
    logger.setLevel(logging.INFO if is_master else logging.CRITICAL + 1)
    logger.propagate = False
    if not logger.handlers and is_master:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, f"{run_name}.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
