"""Static-shape bucketed batching.

Copy of ``protnote_tpu/data/batching.py`` for the port, which imports
nothing of the JAX package; the multi-hot rows are built by its numpy path
(the JAX package's native helper is left out).

Replaces the reference's dynamic-padding collator + torch DataLoader stack
(protnote/data/collators.py:5-155, datasets.py:572-661, samplers.py:15-268)
with XLA-friendly batches:

- sequences are padded to one of a fixed set of BUCKET lengths (bounded
  recompilation instead of a new shape per batch, SURVEY.md §5.7),
- batches always have ``batch_size`` rows; short final batches are padded
  and masked via ``example_mask``,
- the label axis can be padded to a mesh-divisible multiple
  (``label_pad_multiple`` + ``label_mask``),
- with ``device_label_gather`` the batch ships (L·k,) int32 ``label_rows``
  into the step-invariant device-resident view matrix instead of the
  gathered float matrix (the reference collator re-ships ~131 MB of label
  embeddings per step, collators.py:100-105),
- weighted multinomial example sampling, fixed/shuffled/in-batch label
  subsampling, per-batch description sampling (label augmentation), and the
  cartesian sequence×label-tile GridBatcher (reference GridBatchSampler,
  samplers.py:127-224),
- ``PrefetchBatcher`` overlaps host-side batch assembly with device compute
  on a background thread (the reference uses 3 DataLoader workers).
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from protnote_tpu_torch.data.dataset import ProteinDataset

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 12288)

# Tuned for the SwissProt length distribution (lognormal median ~350,
# heavy tail, capped at the reference's 10k train filter,
# datasets.py:161-168): finer steps where the mass is (128..1024 covers
# ~93% of sequences) and sparse doubling in the tail.  Combined with
# ``tokens_per_batch`` (see BucketBatcher), measured padding-position
# waste on that distribution drops from 37% (DEFAULT_BUCKETS, fixed
# 32-row batches) to ~19%, at 14 compiles instead of 7.
SWISSPROT_BUCKETS = (128, 192, 256, 320, 384, 512, 640, 768,
                     1024, 1536, 2048, 4096, 8192, 12288)


@dataclass
class Batch:
    """One step's host-side arrays (converted by
    train.step.batch_to_device_dict)."""

    aa_ids: np.ndarray  # (B, T) int8 residue ids, pad = ds.pad_id
    lengths: np.ndarray  # (B,) int32 true lengths (clamped to the bucket)
    example_mask: np.ndarray  # (B,) bool; False rows are padding
    sequence_ids: List[str]  # length B ("" for padding rows)
    label_embeddings: Optional[np.ndarray] = None  # (Lp*k, D) float32
    label_rows: Optional[np.ndarray] = None  # (Lp*k,) int32 view-row indices
    label_multihots: Optional[np.ndarray] = None  # (B, Lp) float32
    label_mask: Optional[np.ndarray] = None  # (Lp,) bool; None if no padding
    label_indices: Optional[np.ndarray] = None  # (Ls,) real vocab ids of slots
    label_token_counts: Optional[np.ndarray] = None  # (Lp*k,) int32
    label_description_indices: Optional[np.ndarray] = None  # (Lp*k,) cache rows
    # multi-process strided assembly (reference per-rank split,
    # samplers.py:15-63): row-wise arrays above cover only global batch rows
    # [row_offset, row_offset + local_rows); label-side arrays stay global
    row_offset: int = 0
    global_batch_size: Optional[int] = None  # None: arrays are global
    global_valid_count: Optional[int] = None  # valid rows in the GLOBAL batch


def _multihot(label_id_lists: List[np.ndarray], num_labels: int) -> np.ndarray:
    out = np.zeros((len(label_id_lists), num_labels), dtype=np.uint8)
    for i, ids in enumerate(label_id_lists):
        ids = np.asarray(ids, dtype=np.int64)
        out[i, ids[(ids >= 0) & (ids < num_labels)]] = 1
    return out


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class BucketBatcher:
    """Deterministic epoch-seeded batcher over a ProteinDataset.

    Two instances with the same (dataset, arguments, seed, epoch) yield
    byte-identical batches — the materialised-embedding and device-gather
    paths therefore select the same description rows (tested in
    tests/test_device_label_gather.py).
    """

    def __init__(
        self,
        ds: ProteinDataset,
        batch_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        label_sample_size: Optional[int] = None,
        shuffle_labels: bool = False,
        in_batch_sampling: bool = False,
        sequence_weights: Optional[np.ndarray] = None,
        label_pad_multiple: int = 1,
        descriptions_per_label: int = 1,
        device_label_gather: bool = False,
        return_label_multihots: bool = True,
        on_bucket_overflow: str = "warn",
        tokens_per_batch: Optional[int] = None,
    ):
        self.ds = ds
        self.batch_size = int(batch_size)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = int(seed)
        self.label_sample_size = label_sample_size
        self.shuffle_labels = shuffle_labels
        self.in_batch_sampling = in_batch_sampling
        self.sequence_weights = (
            None if sequence_weights is None else np.asarray(sequence_weights, np.float64)
        )
        self.label_pad_multiple = max(int(label_pad_multiple), 1)
        self.descriptions_per_label = max(int(descriptions_per_label), 1)
        self.device_label_gather = device_label_gather
        self.return_label_multihots = return_label_multihots
        # Token-budget batching (r5, VERDICT r4 #4): with a realistic
        # heavy-tail length distribution, fixed-row batches waste most of
        # their encoder FLOPs in the long-tail buckets (a 32-row 12288-wide
        # batch carrying 2 real sequences is 94% filler).  When set, rows
        # per batch become clip(round8(tokens_per_batch / width), 8,
        # batch_size).  ``batch_size`` is the row CAP; one compile per
        # bucket either way.  Measured guidance (TPU v5e, SwissProt length
        # dist + SWISSPROT_BUCKETS): for full-vocabulary scoring the pair
        # scorer dominates, so pick tokens ~ 4096*batch_size — rows shrink
        # ONLY in the extreme-tail buckets and throughput beats fixed rows
        # (137.0 vs 135.6 seqs/s) at ~18% waste; an aggressive budget
        # (~512*batch_size) minimizes encoder waste but shrinks mid-bucket
        # scorer batches and measured SLOWER (133.3).  Use aggressive
        # budgets only for encoder-dominated work (small label sets).
        self.tokens_per_batch = (
            None if tokens_per_batch is None else int(tokens_per_batch)
        )
        self._epoch = 0
        self._plans: Dict[int, List[Tuple[np.ndarray, int]]] = {}
        self._fixed_label_layout = None  # full-vocab eval rows, built once
        self.row_shard = None  # multi-process strided assembly (set_row_shard)

        if len(ds) and int(np.max(ds.lengths)) > self.buckets[-1]:
            n_over = int(np.sum(ds.lengths > self.buckets[-1]))
            msg = (
                f"{n_over} sequences exceed the largest bucket "
                f"({self.buckets[-1]}); they will be truncated"
            )
            if on_bucket_overflow == "error":
                raise ValueError(
                    f"{n_over} sequence(s) length exceeds the largest bucket "
                    f"({self.buckets[-1]}); raise SEQUENCE_BUCKETS or use "
                    f"on_bucket_overflow='truncate'"
                )
            if on_bucket_overflow == "warn":
                logger.warning(msg)

    # ---------------- epoch plumbing ----------------

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _bucket_rows(self, bucket: int) -> int:
        """Rows per batch for a bucket width (token-budget batching)."""
        if self.tokens_per_batch is None:
            return self.batch_size
        r = (self.tokens_per_batch // int(bucket)) // 8 * 8
        r = max(8, min(r, self.batch_size))
        shard = getattr(self, "row_shard", None)
        if shard is not None:
            total = shard[2]
            r = max(total, r // total * total)
        return r

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.ds)
        if self.sequence_weights is not None and self.shuffle:
            # weighted multinomial WITH replacement (reference
            # DistributedWeightedSampler, samplers.py:66-124)
            rng = np.random.default_rng([self.seed, epoch, 11])
            p = self.sequence_weights / self.sequence_weights.sum()
            return rng.choice(n, size=n, replace=True, p=p)
        if self.shuffle:
            rng = np.random.default_rng([self.seed, epoch, 11])
            return rng.permutation(n)
        return np.arange(n)

    def _plan(self, epoch: int) -> List[Tuple[np.ndarray, int]]:
        """Batches for one epoch: list of (example indices, bucket length)."""
        if epoch in self._plans:
            return self._plans[epoch]
        order = self._epoch_indices(epoch)
        lengths = np.minimum(self.ds.lengths[order], self.buckets[-1])
        bucket_idx = np.searchsorted(self.buckets, lengths, side="left")
        groups: Dict[int, List[int]] = {}
        plan: List[Tuple[np.ndarray, int]] = []
        for i, b in zip(order, bucket_idx):
            g = groups.setdefault(int(b), [])
            g.append(int(i))
            if len(g) == self._bucket_rows(self.buckets[int(b)]):
                plan.append((np.array(g, dtype=np.int64), self.buckets[int(b)]))
                g.clear()
        if not self.drop_last:
            for b in sorted(groups):
                if groups[b]:
                    plan.append((np.array(groups[b], dtype=np.int64), self.buckets[b]))
        self._plans = {epoch: plan}  # keep only the current epoch
        return plan

    def __len__(self) -> int:
        return len(self._plan(self._epoch))

    # ---------------- label-slot selection ----------------

    def _select_labels(
        self,
        batch_label_lists: List[np.ndarray],
        rng_lab: np.random.Generator,
    ) -> Tuple[Optional[np.ndarray], int]:
        """Real label slots for this batch: None means the full vocabulary.
        Returns (selected vocab ids or None, padded slot count Lp)."""
        L = self.ds.num_labels
        if self.in_batch_sampling:
            # positives present in the batch only (reference in-batch
            # sampling, collators.py:95-98); padded to a geometric series of
            # label_pad_multiple to bound recompilation
            sel = np.unique(np.concatenate(batch_label_lists + [np.zeros(0, np.int64)]))
            sel = sel.astype(np.int64)
            base = max(self.label_pad_multiple, 8)
            lp = base
            while lp < len(sel):
                lp *= 2
            return sel, min(_round_up(lp, self.label_pad_multiple), _round_up(L, self.label_pad_multiple))
        if self.label_sample_size is not None and self.label_sample_size < L:
            s = int(self.label_sample_size)
            if self.shuffle_labels:
                sel = np.sort(rng_lab.choice(L, size=s, replace=False)).astype(np.int64)
            else:
                sel = np.arange(s, dtype=np.int64)
            return sel, _round_up(s, self.label_pad_multiple)
        return None, _round_up(L, self.label_pad_multiple)

    # ---------------- iteration ----------------

    def __iter__(self):
        plan = self._plan(self._epoch)
        for bi, (idxs, bucket) in enumerate(plan):
            yield self._build_batch(idxs, bucket, bi)

    def set_row_shard(self, shard) -> None:
        """Restrict per-row assembly to this process's rows.

        ``shard``: (start, count, total) blocks along the batch row axis —
        rows [B*start/total, B*(start+count)/total) are assembled; label-side
        arrays stay global.  This is the multi-process strided split
        (reference per-rank DistributedSampler, samplers.py:15-63): host
        batch-prep work becomes O(B/process_count) while the deterministic
        global schedule is unchanged.  None restores full assembly."""
        if shard is not None:
            start, count, total = (int(x) for x in shard)
            if not (0 <= start and count > 0 and start + count <= total):
                raise ValueError(f"bad row shard {shard}")
            if self.batch_size % total:
                raise ValueError(
                    f"batch size {self.batch_size} not divisible by the dp "
                    f"axis ({total}) — required for strided assembly"
                )
            shard = (start, count, total)
        self.row_shard = shard
        if self.tokens_per_batch is not None:
            # per-bucket row counts depend on the shard divisor — replan
            self._plans = {}

    def _build_batch(
        self, idxs: np.ndarray, bucket: int, bi: int,
        label_cols: Optional[np.ndarray] = None,
        label_pad: Optional[int] = None,
    ) -> Batch:
        """Assemble one batch from its plan entry.

        All randomness (residue augmentation, per-epoch description sampling,
        label subsampling) is keyed by ``[seed, epoch, salt, bi]`` — residue
        augmentation additionally by the global row — so a batch can be
        rebuilt independently of iteration order (GridBatcher assembles
        (batch, tile) pairs lazily; ADVICE r2) and a row-sharded assembly
        (``set_row_shard``) produces exactly the rows the full assembly
        would.

        ``label_cols`` restricts the label axis to the given vocab ids
        (padded to ``label_pad`` slots): the GridBatcher's per-tile build,
        which never touches full-vocabulary-width arrays — a shuffled grid
        epoch would otherwise assemble the (B, L) multihot once per
        (batch, tile) pair."""
        ds = self.ds
        view = ds.label_view
        train_sampling = (
            view is not None
            and ds.cfg.is_train
            and ds.cfg.label_augmentation_descriptions is not None
        )
        k = 1 if train_sampling else self.descriptions_per_label
        L = ds.num_labels
        augment = ds.cfg.is_train and ds.cfg.augment_residue_probability > 0

        n = len(idxs)
        B = self._bucket_rows(bucket)
        shard = getattr(self, "row_shard", None)
        if shard is None:
            lo, hi = 0, B
        else:
            start, count, total = shard
            lo, hi = B * start // total, B * (start + count) // total
        Bl = hi - lo
        aa = np.full((Bl, bucket), ds.pad_id, dtype=np.int8)
        lengths = np.ones(Bl, dtype=np.int32)
        local_idxs = idxs[lo:hi]  # may be shorter than Bl near the tail
        for r, i in enumerate(local_idxs):
            e = ds.encoded[i][:bucket]
            aa[r, : len(e)] = e
            lengths[r] = len(e)
        if augment:
            for r in range(len(local_idxs)):
                rng_aug = np.random.default_rng(
                    [self.seed, self._epoch, 104729, bi, lo + r]
                )
                aa[r] = ds.augment_residues(aa[r], rng_aug)
        mask = np.zeros(Bl, dtype=bool)
        mask[: max(0, min(n, hi) - lo)] = True
        seq_ids = [ds.sequence_ids[i] for i in local_idxs] + [""] * (
            Bl - len(local_idxs)
        )
        # label selection depends on the FULL batch's positives (in-batch
        # sampling) — always computed globally so every process agrees
        batch_label_lists = [ds.label_id_lists[i] for i in idxs]

        if label_cols is not None:
            sel = np.asarray(label_cols, dtype=np.int64)
            lp = int(label_pad) if label_pad is not None else len(sel)
        else:
            rng_lab = np.random.default_rng([self.seed, self._epoch, 1299709, bi])
            sel, lp = self._select_labels(batch_label_lists, rng_lab)
        ls = L if sel is None else len(sel)
        label_indices = np.arange(L, dtype=np.int64) if sel is None else sel

        multihots = None
        if self.return_label_multihots:
            local_lists = [ds.label_id_lists[i] for i in local_idxs]
            if sel is not None and len(sel) <= L // 4:
                # column-restricted construction: O(B * positives) instead
                # of a (B, L) full-vocabulary alloc + slice
                pos = np.full(L, -1, dtype=np.int32)
                pos[sel] = np.arange(len(sel), dtype=np.int32)
                mh = np.zeros((len(local_lists), len(sel)), np.float32)
                for i, ids in enumerate(local_lists):
                    ids = np.asarray(ids, dtype=np.int64)
                    p = pos[ids[(ids >= 0) & (ids < L)]]
                    mh[i, p[p >= 0]] = 1.0
            else:
                mh = _multihot(local_lists, L).astype(np.float32)
                if sel is not None:
                    mh = mh[:, sel]
            if len(local_lists) < Bl:
                mh = np.concatenate(
                    [mh, np.zeros((Bl - len(local_lists), mh.shape[1]), np.float32)]
                )
            if lp > ls:
                mh = np.pad(mh, ((0, 0), (0, lp - ls)))
            multihots = mh

        label_mask = None
        if lp > ls:
            label_mask = np.zeros(lp, dtype=bool)
            label_mask[:ls] = True

        rows = emb = tok = desc_idx = None
        if view is not None:
            if train_sampling:
                rng_desc = np.random.default_rng([self.seed, self._epoch, 7919, bi])
                rows = view.sample_rows(rng_desc, sel)
            elif sel is None:
                if self._fixed_label_layout is None:
                    self._fixed_label_layout = view.first_k_rows(k)
                rows = self._fixed_label_layout
            else:
                rows = view.first_k_rows(k, sel)
            if lp > ls:
                rows = np.concatenate(
                    [rows, np.zeros((lp - ls) * k, dtype=np.int32)]
                )
            tok = view.token_counts[rows]
            desc_idx = view.cache_indices[rows]
            if not self.device_label_gather:
                emb = view.embeddings[rows]
        return Batch(
            aa_ids=aa,
            lengths=lengths,
            example_mask=mask,
            sequence_ids=seq_ids,
            label_embeddings=emb,
            label_rows=rows if (view is not None and self.device_label_gather) else None,
            label_multihots=multihots,
            label_mask=label_mask,
            label_indices=label_indices,
            label_token_counts=tok,
            label_description_indices=desc_idx,
            row_offset=lo,
            global_batch_size=None if shard is None else B,
            global_valid_count=n,
        )


class GridBatcher:
    """Cartesian (sequence batch × label tile) batches for training with a
    bounded label axis (reference GridBatchSampler, samplers.py:127-224).

    Wraps a full-vocabulary BucketBatcher; each inner batch is re-yielded
    once per label tile with the label axis sliced (and padded to the static
    ``labels_batch_size``).
    """

    def __init__(self, inner: BucketBatcher, labels_batch_size: int,
                 shuffle_grid: bool = False):
        if inner.label_sample_size is not None or inner.in_batch_sampling:
            raise ValueError("GridBatcher requires a full-vocabulary inner batcher")
        self.inner = inner
        self.labels_batch_size = int(labels_batch_size)
        self.shuffle_grid = shuffle_grid
        self._epoch = 0

    @property
    def ds(self) -> ProteinDataset:
        return self.inner.ds

    @property
    def device_label_gather(self) -> bool:
        return self.inner.device_label_gather

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self.inner.set_epoch(epoch)

    def set_row_shard(self, shard) -> None:
        self.inner.set_row_shard(shard)

    def num_tiles(self) -> int:
        return -(-self.ds.num_labels // self.labels_batch_size)

    def __len__(self) -> int:
        return len(self.inner) * self.num_tiles()

    def __iter__(self):
        L = self.ds.num_labels
        lbs = self.labels_batch_size
        rng = np.random.default_rng([self.inner.seed, self._epoch, 31337])
        label_order = rng.permutation(L) if self.shuffle_grid else np.arange(L)
        tiles = [label_order[i : i + lbs] for i in range(0, L, lbs)]
        plan = self.inner._plan(self.inner._epoch)
        pairs = [(b, t) for b in range(len(plan)) for t in range(len(tiles))]
        if self.shuffle_grid or self.inner.shuffle:
            rng.shuffle(pairs)
        # Assemble each (batch, tile) pair lazily — the epoch is never
        # materialised (a reference-scale epoch of full-vocab Batch objects
        # holds ~50-60 GB of (B, L) multihots; the reference's
        # GridBatchSampler also stores only index lists, samplers.py:127-224)
        # — and COLUMN-RESTRICTED: `label_cols` keeps every per-pair build
        # O(B*bucket + B*tile), never full-vocabulary width (a shuffled
        # epoch visits each batch once per tile, so a full-width build here
        # would multiply host assembly work by num_tiles).  The same
        # (batch, tile) pair rebuilds identically because _build_batch keys
        # its RNG streams by batch index.
        for bi, ti in pairs:
            idxs, bucket = plan[bi]
            yield self.inner._build_batch(
                idxs, bucket, bi,
                label_cols=np.asarray(tiles[ti], dtype=np.int64),
                label_pad=lbs,
            )


class PrefetchBatcher:
    """Background-thread prefetch wrapper: batch assembly (padding, multihot,
    BLOSUM augmentation) overlaps device compute.  Attribute access is
    delegated to the wrapped batcher, so it is a drop-in replacement."""

    def __init__(self, batcher, prefetch: int = 2):
        self.batcher = batcher
        self.prefetch = max(int(prefetch), 1)

    def __getattr__(self, name):
        return getattr(self.batcher, name)

    def __len__(self) -> int:
        return len(self.batcher)

    def set_epoch(self, epoch: int) -> None:
        self.batcher.set_epoch(epoch)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def produce():
            try:
                for item in self.batcher:
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surface in the consumer
                item = e
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return
                    except queue.Full:
                        continue
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
