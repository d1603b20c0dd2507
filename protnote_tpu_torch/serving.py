"""Serving: batched inference over a loaded ProtNote model on one device.

Port of ``ServingEngine`` from ``protnote_tpu/serving.py``.  The engine
loads once, projects the full label-embedding matrix through W_l once (the
label tower never runs again), and scores ad-hoc sequence lists in
length buckets at a fixed batch shape.  Logits are read back in float16 and
the sigmoid runs on the host in float32, as in the JAX engine.

Backends: the bf16 tiled scorer (K1) or, with ``PAIR_BACKEND=tiled_int8``,
the int8 scorer (K2).  Without supplied ``INT8_ACT_SCALES`` the int8 engine
calibrates static activation scales once, from the first batch it scores or
from :meth:`ServingEngine.calibrate_from` (margin 1.05, the semantics of
``Trainer.calibrate_int8``); :meth:`ServingEngine.warmup` refuses to set
them from its synthetic sequence, and :meth:`ServingEngine.reload` drops
auto-calibrated scales (they are a function of the weights) but keeps
supplied ones.

The request side (``ServingStats``, :func:`topk_from_probs`,
``MicroBatcher``, :func:`make_http_server`) lives in
:mod:`protnote_tpu_torch.serving_http`; ``make_http_server`` is
re-exported here.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from protnote_tpu_torch.data.dataset import make_residue_lut
from protnote_tpu_torch.data.vocab import COMMON_AMINOACIDS
from protnote_tpu_torch.models.fusion import calibrate_int8_maxes, compute_label_latents
from protnote_tpu_torch.models.layers import tree_to
from protnote_tpu_torch.models.proteinfer import embed_from_ids
from protnote_tpu_torch.serving_http import (  # noqa: F401  (make_http_server: re-exported)
    ServingStats,
    make_http_server,
    topk_from_probs,
)
from protnote_tpu_torch.train.step import make_eval_step

logger = logging.getLogger(__name__)


class ServingEngine:
    """Scores raw amino-acid sequences against the full label vocabulary.

    ``ts``: the port's parameter bundle (the JAX train-state layout, as
    :func:`protnote_tpu_torch.models.convert.from_jax_tree` returns it).
    ``label_matrix``: (num_labels * k, label_dim) embedding rows in label
    order (k = descriptions per label).  ``label_vocabulary``: num_labels GO
    ids in the same order.  ``device``: where the weights, latents and every
    batch live; there is no fallback to another device.
    """

    def __init__(
        self,
        ts: Dict[str, Any],
        pi_cfg,
        pn_cfg,
        label_matrix: np.ndarray,
        label_vocabulary: Sequence[str],
        amino_acid_vocabulary: Optional[Sequence[str]] = None,
        buckets: Sequence[int] = (256, 512, 1024, 2048, 4096),
        max_batch: int = 32,
        device: torch.device | str = "cuda",
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("label-sharded serving over several cards "
                                      "comes with the multi-GPU slice of the port")
        self.pi_cfg = pi_cfg
        self.pn_cfg = pn_cfg
        self.device = torch.device(device)
        self.label_vocabulary = list(label_vocabulary)
        L = len(self.label_vocabulary)
        if label_matrix.shape[0] % L:
            raise ValueError(
                f"label matrix rows ({label_matrix.shape[0]}) not a multiple "
                f"of the vocabulary size ({L})"
            )
        self.descriptions_per_label = label_matrix.shape[0] // L
        if self.descriptions_per_label != pn_cfg.inference_descriptions_per_label:
            raise ValueError(
                f"label matrix carries {self.descriptions_per_label} "
                f"descriptions/label but the config expects "
                f"{pn_cfg.inference_descriptions_per_label}"
            )
        aa_vocab = sorted(amino_acid_vocabulary or COMMON_AMINOACIDS)
        self._lut = make_residue_lut(aa_vocab)
        self._pad_id = len(aa_vocab)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_batch = int(max_batch)
        self._label_matrix = torch.as_tensor(np.asarray(label_matrix)).to(self.device)
        self.stats = ServingStats()
        self._calib_lock = threading.Lock()
        self._model_lock = threading.Lock()  # atomic (ts, latents) hot swap
        self._int8_scales_supplied = pn_cfg.int8_act_scales is not None
        self._score_step = make_eval_step(pi_cfg, pn_cfg)
        self.ts = self._to_device(ts)
        self.latents = self._compute_latents(self.ts)
        self._needs_calibration = (pn_cfg.pair_backend == "tiled_int8"
                                   and pn_cfg.int8_act_scales is None)
        if self._needs_calibration:
            logger.info("int8 backend without scales: will calibrate on the "
                        "first scored batch")

    # ---------------- model plumbing ----------------

    def _to_device(self, ts: Dict[str, Any]) -> Dict[str, Any]:
        # inference never reads the optimizer state
        return tree_to({k: v for k, v in ts.items() if k not in ("opt_state", "step")},
                       self.device)

    @torch.inference_mode()
    def _compute_latents(self, ts: Dict[str, Any]) -> torch.Tensor:
        """Project every label-embedding row through W_l once."""
        return compute_label_latents(ts["trainable"]["protnote"],
                                     ts["model_state"], self._label_matrix,
                                     self.pn_cfg)

    @torch.inference_mode()
    def _calibrate_int8(self, aa: np.ndarray, lengths: np.ndarray) -> None:
        """Static activation scales from one batch (max |GEMM input| of each
        hidden layer x 1.05 / 127), then the score step rebuilt with them."""
        ts = self.ts
        enc_params = ts["trainable"].get("encoder", ts["enc_params"])
        P_f = embed_from_ids(enc_params, ts["enc_state"],
                             torch.from_numpy(aa).to(self.device),
                             torch.from_numpy(lengths).to(self.device), self.pi_cfg)
        maxes = calibrate_int8_maxes(ts["trainable"]["protnote"], ts["model_state"], P_f,
                                     self.pn_cfg, label_latents=self.latents)
        scales = tuple(float(m) * 1.05 / 127.0 for m in maxes.cpu().tolist())
        self.pn_cfg = dataclasses.replace(self.pn_cfg, int8_act_scales=scales)
        self._score_step = make_eval_step(self.pi_cfg, self.pn_cfg)
        self._needs_calibration = False
        logger.info("serving int8 scales calibrated: %s", [round(s, 6) for s in scales])

    # ---------------- encoding ----------------

    def _encode(self, sequences: Sequence[str]) -> List[np.ndarray]:
        out = []
        for i, seq in enumerate(sequences):
            if not seq or not isinstance(seq, str):
                raise ValueError(f"sequence {i} is empty or not a string")
            ids = self._lut[np.frombuffer(seq.upper().encode(), dtype=np.uint8)]
            out.append(np.where(ids < 0, self._pad_id, ids).astype(np.int8))
        return out

    def _bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]  # overflow: truncate (batching.py policy)

    # ---------------- scoring ----------------

    def score(self, sequences: Sequence[str]) -> np.ndarray:
        """(n, num_labels) float32 sigmoid probabilities, input order."""
        encoded = self._encode(sequences)
        order: Dict[int, List[int]] = {}
        for i, e in enumerate(encoded):
            order.setdefault(self._bucket_of(len(e)), []).append(i)
        probs = np.empty((len(encoded), len(self.label_vocabulary)), np.float32)
        for bucket, idxs in sorted(order.items()):
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s : s + self.max_batch]
                probs[chunk] = self._score_bucket([encoded[i] for i in chunk], bucket)
        with self.stats.lock:
            self.stats.sequences += len(encoded)
        return probs

    def _assemble(self, encoded: List[np.ndarray], bucket: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad an encoded chunk into the (max_batch, bucket) static shape."""
        B = self.max_batch
        aa = np.full((B, bucket), self._pad_id, dtype=np.int8)
        lengths = np.ones(B, dtype=np.int32)
        for r, e in enumerate(encoded):
            e = e[:bucket]
            aa[r, : len(e)] = e
            lengths[r] = max(len(e), 1)
        return aa, lengths

    def _score_bucket(self, encoded: List[np.ndarray], bucket: int) -> np.ndarray:
        n = len(encoded)
        aa, lengths = self._assemble(encoded, bucket)
        if self._needs_calibration:
            with self._calib_lock:
                if self._needs_calibration:  # checked again under the lock
                    self._calibrate_int8(aa, lengths)
        with self._model_lock:  # (ts, latents) must be from ONE model
            ts, latents, step = self.ts, self.latents, self._score_step
        t0 = time.perf_counter()
        logits = step(ts, {
            "aa_ids": torch.from_numpy(aa).to(self.device),
            "lengths": torch.from_numpy(lengths).to(self.device),
            "label_latents": latents,
        })["logits"]
        # f16 readback (the repo's logits export dtype) halves the transfer;
        # the host sigmoid in f32 keeps the probability error <= ~5e-4
        logits = logits.to(torch.float16).cpu().numpy()[:n].astype(np.float32)
        dt = (time.perf_counter() - t0) * 1e3
        with self.stats.lock:
            self.stats.batches += 1
            self.stats.batched_rows += self.max_batch
            self.stats.total_device_ms += dt
        return 1.0 / (1.0 + np.exp(-logits))

    def top_k(self, sequences: Sequence[str], k: int = 10,
              threshold: Optional[float] = None) -> List[List[Tuple[str, float]]]:
        """Per sequence: the k highest-probability (go_id, prob) pairs,
        optionally filtered to probs >= threshold."""
        return topk_from_probs(self.label_vocabulary, self.score(sequences),
                               k, threshold)

    def reload(self, ts: Dict[str, Any]) -> None:
        """Hot-swap the model weights: latents for the new weights are
        computed first, then ``(ts, latents)`` swap atomically, so in-flight
        requests finish on the old model.  Auto-calibrated int8 scales are
        dropped (the next scored batch recalibrates); supplied
        ``INT8_ACT_SCALES`` survive."""
        ts = self._to_device(ts)
        latents = self._compute_latents(ts)
        with self._calib_lock, self._model_lock:
            if (self.pn_cfg.pair_backend == "tiled_int8" and not self._int8_scales_supplied
                    and self.pn_cfg.int8_act_scales is not None):
                self.pn_cfg = dataclasses.replace(self.pn_cfg, int8_act_scales=None)
                self._score_step = make_eval_step(self.pi_cfg, self.pn_cfg)
                self._needs_calibration = True
            self.ts, self.latents = ts, latents
        logger.info("model hot-reloaded")

    def calibrate_from(self, sequences: Sequence[str]) -> None:
        """Calibrate static int8 activation scales from real sequences (the
        first ``max_batch``).  Call before :meth:`warmup` when serving int8
        without supplied scales (``cli.serve --calibration-fasta``)."""
        encoded = self._encode(sequences[: self.max_batch])
        bucket = self._bucket_of(max(len(e) for e in encoded))
        aa, lengths = self._assemble(encoded, bucket)
        with self._calib_lock:
            if self._needs_calibration:
                self._calibrate_int8(aa, lengths)

    def warmup(self) -> None:
        """Score one synthetic sequence per bucket, so the first real request
        does not pay the first-call costs (the kernel build, allocator
        growth).  An int8 engine without scales skips it: the synthetic
        repeated motif must not set the activation scales (call
        :meth:`calibrate_from` with real sequences first)."""
        if self._needs_calibration:
            logger.warning("int8 scales not calibrated: skipping warmup (the synthetic "
                           "warmup batch must not set them); pass real sequences via "
                           "calibrate_from / --calibration-fasta to warm up int8")
            return
        aas = "ACDEFGHIKLMNPQRSTVWY"
        for bucket in self.buckets:
            self._score_bucket(self._encode([aas * (bucket // len(aas) + 1)]), bucket)
        logger.info("serving warmup complete (%d bucket shapes)", len(self.buckets))
