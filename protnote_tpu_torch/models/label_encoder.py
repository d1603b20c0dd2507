"""Frozen text label encoders.

Port of ``protnote_tpu/models/label_encoder.py``.  The reference embeds
GO/EC free-text descriptions with a frozen HF model (E5-large-instruct or
BioGPT) and mean/last-token/all pooling (protnote/utils/models.py:115-285);
the zero-shot capability comes from running this encoder on *new* label
text.

Backends:

* ``NativeLabelEncoder`` -- the port's own tower
  (:mod:`protnote_tpu_torch.models.text_transformer`, with the attention and
  LayerNorm kernels K8a/K8b on the card), the counterpart of the JAX
  package's ``JaxLabelEncoder``: the same token buckets, row padding and
  pooling.
* ``TorchLabelEncoder`` -- HF transformers' AutoModel as it is.
* ``HashLabelEncoder`` -- a deterministic hashing stand-in (no weights, no
  network), copied as it is.

The HF backends read the tokenizer, config and weights with
``local_files_only`` by default; ``transformers`` is imported inside the
functions that load a checkpoint.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from protnote_tpu_torch.models.layers import tree_to
from protnote_tpu_torch.models.text_transformer import (
    TextEncoderConfig,
    cast_for_inference,
    config_from_hf,
    from_hf_state_dict,
    pool_hidden_states as pool_hidden_states_torch,
    text_encoder_forward,
)

# the EXACT task text + instruct format of the reference cache generator
# (bin/generate_label_embeddings.py:68-75) -- a different instruction would
# produce a systematically shifted embedding cache, silently incomparable
# with reference checkpoints
E5_INSTRUCTION = (
    "Instruct: Identify the main categories, themes, or topics described in "
    "the following Gene Ontology (GO) term, which is used to detail a "
    "protein's function\nQuery: "
)
MAX_LABEL_TOKENS = 510  # E5 learned positions cap (reference models.py:115-135)


def pool_hidden_states(
    last_hidden: np.ndarray,  # (N, T, D)
    attention_mask: np.ndarray,  # (N, T)
    method: str,
    account_for_sos: bool = True,
) -> np.ndarray:
    mask = attention_mask.astype(np.float32)
    raw_len = mask.sum(axis=1, keepdims=True)
    # degenerate rows (mask sum <= 1 with SOS accounting) yield zeros, not
    # 0/0 = nan -- kept in lockstep with pool_hidden_states_jnp
    length = np.maximum(raw_len - (1.0 if account_for_sos else 0.0), 1.0)
    if method == "mean":
        adj = mask.copy()
        if account_for_sos:
            adj[:, 0] = 0
        summed = (last_hidden * adj[..., None]).sum(axis=1)
        return summed / length
    if method == "last_token":
        idx = np.maximum(raw_len[:, 0] - 1, 0).astype(np.int64)
        return last_hidden[np.arange(last_hidden.shape[0]), idx]
    if method == "all":
        return last_hidden
    raise ValueError(f"unknown pooling method {method}")


class TorchLabelEncoder:
    """HF AutoModel wrapper, eval mode, batched no-grad embedding."""

    def __init__(self, checkpoint: str, device: str = "cuda",
                 pooling_method: str = "mean", local_files_only: bool = True):
        from transformers import AutoModel, AutoTokenizer

        self.checkpoint = checkpoint
        self.pooling_method = pooling_method
        self.device = device
        self.tokenizer = AutoTokenizer.from_pretrained(
            checkpoint, local_files_only=local_files_only
        )
        self.model = AutoModel.from_pretrained(
            checkpoint, local_files_only=local_files_only
        ).to(device)
        self.model.eval()
        self.dim = int(self.model.config.hidden_size)

    def tokenize(self, texts: Sequence[str]):
        return self.tokenizer(
            list(texts), padding="longest", truncation=True,
            max_length=MAX_LABEL_TOKENS, return_tensors="pt",
        )

    def token_counts(self, texts: Sequence[str]) -> List[int]:
        enc = self.tokenizer(
            list(texts), truncation=True, max_length=MAX_LABEL_TOKENS
        )
        return [len(x) for x in enc["input_ids"]]

    def embed(self, texts: Sequence[str], batch_size: int = 32,
              account_for_sos: bool = True) -> np.ndarray:
        # pooling 'all' keeps the token axis: every chunk must pad to ONE
        # global width or the final concatenate fails on mismatched T
        fixed_len = (
            max(self.token_counts(texts)) if self.pooling_method == "all"
            else None
        )
        out = []
        for s in range(0, len(texts), batch_size):
            chunk = list(texts[s : s + batch_size])
            if fixed_len is None:
                toks = self.tokenize(chunk)
            else:
                toks = self.tokenizer(
                    chunk, padding="max_length", truncation=True,
                    max_length=fixed_len, return_tensors="pt",
                )
            toks = {k: v.to(self.device) for k, v in toks.items()}
            with torch.no_grad():
                hidden = self.model(**toks).last_hidden_state
            pooled = pool_hidden_states(
                hidden.float().cpu().numpy(),
                toks["attention_mask"].cpu().numpy(),
                self.pooling_method,
                account_for_sos=account_for_sos,
            )
            out.append(pooled.astype(np.float32))
        return np.concatenate(out, axis=0)


class HashLabelEncoder:
    """Deterministic pseudo-embedder (no weights, no network).

    Feature-hashes word n-grams into a ``dim``-d unit vector; similar texts
    get similar vectors, so ranking-style tests behave sanely.
    """

    def __init__(self, dim: int = 1024, pooling_method: str = "mean"):
        self.dim = dim
        self.pooling_method = pooling_method
        self.checkpoint = "hash"

    def token_counts(self, texts: Sequence[str]) -> List[int]:
        return [min(len(t.split()) + 2, MAX_LABEL_TOKENS) for t in texts]

    def _word_vec(self, word: str) -> np.ndarray:
        h = hashlib.sha256(word.encode()).digest()
        seed = int.from_bytes(h[:8], "little")
        rng = np.random.default_rng(seed)
        return rng.standard_normal(self.dim).astype(np.float32)

    def embed(self, texts: Sequence[str], batch_size: int = 0,
              account_for_sos: bool = True) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            words = text.lower().split()
            if not words:
                words = ["<empty>"]
            vecs = [self._word_vec(w) for w in words]
            vecs += [self._word_vec(a + "_" + b) for a, b in zip(words, words[1:])]
            v = np.mean(vecs, axis=0)
            out[i] = v / (np.linalg.norm(v) + 1e-8)
        return out


class NativeLabelEncoder:
    """The port's text tower behind the ``token_counts``/``embed`` interface
    of ``JaxLabelEncoder``.

    ``params`` (a :func:`~protnote_tpu_torch.models.text_transformer.
    from_hf_state_dict` or ``init_text_encoder`` tree) are moved to
    ``device`` once, with the embedding and Linear weights cast to
    ``cfg.dtype`` (what the forward casts them to at use).  ``tokenizer`` is
    an HF tokenizer, needed by :meth:`token_counts` and :meth:`embed`;
    :meth:`embed_ids` takes token ids as they are.  The tower computes in
    ``cfg.dtype`` on every device: float32 (as ``JaxLabelEncoder``), or
    bfloat16 when a caller asks for it; on the card the attention and
    LayerNorm kernels run in either.
    """

    # bucketed token widths, as the JAX encoder pads them: a handful of
    # shapes, whatever the lengths of the texts
    _LEN_BUCKETS = (32, 64, 96, 128, 192, 256, 384, MAX_LABEL_TOKENS)

    def __init__(self, cfg: TextEncoderConfig, params, tokenizer: Any = None,
                 device="cuda", pooling_method: str = "mean", checkpoint: str = "native"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = tree_to(cast_for_inference(params, cfg.dtype), self.device)
        self.tokenizer = tokenizer
        self.pooling_method = pooling_method
        self.checkpoint = checkpoint
        self.dim = cfg.hidden_size

    @classmethod
    def from_pretrained(cls, checkpoint: str, pooling_method: str = "mean",
                        local_files_only: bool = True, dtype: Optional[torch.dtype] = None,
                        device="cuda") -> "NativeLabelEncoder":
        """Tokenizer, config and weights of an HF checkpoint (read through
        ``transformers``).  ``dtype`` None: float32 on every device, as the
        JAX ``JaxLabelEncoder`` computes (``torch.bfloat16`` still runs the
        bf16 tower)."""
        device = torch.device(device)
        if dtype is None:
            dtype = torch.float32
        cfg, params, tokenizer = load_pretrained_tower(checkpoint, dtype, local_files_only)
        return cls(cfg, params, tokenizer, device=device, pooling_method=pooling_method,
                   checkpoint=checkpoint)

    def token_counts(self, texts: Sequence[str]) -> List[int]:
        enc = self.tokenizer(list(texts), truncation=True, max_length=MAX_LABEL_TOKENS)
        return [len(x) for x in enc["input_ids"]]

    @torch.inference_mode()
    def embed_ids(self, ids, mask, account_for_sos: bool = True) -> torch.Tensor:
        """Forward and pool one chunk of token ids (B, T) and its attention
        mask: (B, H) float32 (or the token states for pooling ``all``) on
        the encoder's device."""
        ids = torch.as_tensor(ids).to(self.device)
        mask = torch.as_tensor(mask).to(self.device)
        hidden = text_encoder_forward(self.params, ids, mask, self.cfg)
        return pool_hidden_states_torch(hidden, mask, self.pooling_method,
                                        account_for_sos=account_for_sos)

    def embed(self, texts: Sequence[str], batch_size: int = 128,
              account_for_sos: bool = True) -> np.ndarray:
        fixed_len = (
            max(self.token_counts(texts)) if self.pooling_method == "all"
            else None
        )
        pad_id = self.tokenizer.pad_token_id or 0
        out = []
        for s in range(0, len(texts), batch_size):
            chunk = list(texts[s : s + batch_size])
            toks = self.tokenizer(
                chunk, padding="longest", truncation=True,
                max_length=MAX_LABEL_TOKENS, return_tensors="np",
            )
            ids = toks["input_ids"].astype(np.int32)
            mask = toks["attention_mask"].astype(np.int32)
            if fixed_len is not None:
                width = fixed_len  # pooling 'all': ONE global token width
            else:
                width = next(b for b in self._LEN_BUCKETS if b >= ids.shape[1])
            # pad tokens to the bucket and rows to the full batch; filler
            # rows get an all-zero mask and are sliced off below
            n = ids.shape[0]
            ids = np.pad(ids, ((0, batch_size - n), (0, width - ids.shape[1])),
                         constant_values=pad_id)
            mask = np.pad(mask, ((0, batch_size - n), (0, width - mask.shape[1])))
            pooled = self.embed_ids(ids, mask, account_for_sos)
            out.append(pooled.float().cpu().numpy()[:n])
        return np.concatenate(out, axis=0)


def load_pretrained_tower(checkpoint: str, dtype: torch.dtype = torch.float32,
                          local_files_only: bool = True):
    """``(cfg, params, tokenizer)`` of an HF checkpoint: the tower's config
    with compute dtype ``dtype``, its float32 parameter tree on the CPU (the
    master weights a training run keeps) and the HF tokenizer."""
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(checkpoint, local_files_only=local_files_only)
    hf_cfg = AutoConfig.from_pretrained(checkpoint, local_files_only=local_files_only)
    model = AutoModel.from_pretrained(checkpoint, local_files_only=local_files_only)
    cfg = config_from_hf(hf_cfg, dtype=dtype)
    params = from_hf_state_dict(model.state_dict(), cfg)
    del model
    return cfg, params, tokenizer


def tokenize_descriptions(tokenizer, descriptions: Sequence[str]):
    """``(ids, attention)`` int32 (M, Tk) of every description, padded to
    the longest and truncated at :data:`MAX_LABEL_TOKENS` (the JAX CLI's
    ``label_tokens``)."""
    toks = tokenizer(list(descriptions), padding="longest", truncation=True,
                     max_length=MAX_LABEL_TOKENS, return_tensors="np")
    return toks["input_ids"].astype(np.int32), toks["attention_mask"].astype(np.int32)


def build_label_encoder(checkpoint: str, pooling_method: str = "mean",
                        device="cuda", allow_fallback: bool = True,
                        backend: str = "torch"):
    """Factory: HF encoder when available locally, hash stub otherwise.

    ``backend='native'`` uses the port's own tower
    (:class:`NativeLabelEncoder`, the JAX factory's ``'jax'``); ``'torch'``
    uses HF directly.
    """
    if checkpoint == "hash":
        return HashLabelEncoder(pooling_method=pooling_method)
    try:
        if backend == "native":
            return NativeLabelEncoder.from_pretrained(checkpoint, pooling_method=pooling_method,
                                                      device=device)
        return TorchLabelEncoder(checkpoint, device=device,
                                 pooling_method=pooling_method)
    except Exception as e:
        if not allow_fallback:
            raise
        logging.getLogger(__name__).warning(
            "label encoder %s unavailable locally (%s); using HashLabelEncoder",
            checkpoint, e,
        )
        return HashLabelEncoder(pooling_method=pooling_method)
