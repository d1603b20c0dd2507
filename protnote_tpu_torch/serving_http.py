"""The request side of serving: engine-agnostic host code.

Copy of the request half of ``protnote_tpu/serving.py`` for the port, which
imports nothing of the JAX package: ``ServingStats``, :func:`topk_from_probs`,
:class:`MicroBatcher` (cross-request batching: concurrent requests coalesce
into one device dispatch, up to ``max_batch`` sequences or ``max_wait_ms``)
and :func:`make_http_server` (a stdlib HTTP front end: POST /v1/predict,
POST /v1/reload, GET /healthz, GET /metrics).  An engine needs ``score``,
``_encode``, ``max_batch``, ``label_vocabulary``, ``stats`` and
``pn_cfg.pair_backend``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class ServingStats:
    requests: int = 0
    sequences: int = 0
    batches: int = 0
    batched_rows: int = 0  # sequences dispatched incl. padding rows
    total_device_ms: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            d = {
                "requests": self.requests,
                "sequences": self.sequences,
                "batches": self.batches,
                "mean_batch_fill": (
                    self.sequences / self.batched_rows
                    if self.batched_rows else None
                ),
                "total_device_ms": round(self.total_device_ms, 1),
            }
        return d


def topk_from_probs(vocabulary: Sequence[str], probs: np.ndarray, k: int,
                    threshold: Optional[float] = None
                    ) -> List[List[Tuple[str, float]]]:
    """Shared top-k: sorted (label, prob) pairs per row, optional threshold
    filter (used by ServingEngine.top_k and the HTTP handler)."""
    k = max(1, min(int(k), probs.shape[1]))
    part = np.argpartition(-probs, k - 1, axis=1)[:, :k]
    results = []
    for row, cols in zip(probs, part):
        cols = cols[np.argsort(-row[cols])]
        results.append([
            (vocabulary[c], float(row[c]))
            for c in cols
            if threshold is None or row[c] >= threshold
        ])
    return results


class MicroBatcher:
    """Coalesces concurrent requests into shared device dispatches.

    Callers submit a sequence list and block until their scores are ready;
    ``pipeline_depth`` worker threads drain the queue, each packing up to
    ``max_batch`` sequences per dispatch and waiting at most ``max_wait_ms``
    for stragglers once the first request of a batch arrived.  Depth > 1
    keeps multiple device programs in flight, overlapping one batch's
    host readback with the next batch's compute — the same double-buffering
    the data pipeline's PrefetchBatcher applies on the input side."""

    def __init__(self, engine, max_wait_ms: float = 5.0,
                 max_batch: Optional[int] = None, pipeline_depth: int = 2):
        self.engine = engine
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_batch = int(max_batch or engine.max_batch)
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(max(1, int(pipeline_depth)))
        ]
        for w in self._workers:
            w.start()

    def submit(self, sequences: Sequence[str]) -> np.ndarray:
        """Blocking: returns (len(sequences), num_labels) probabilities.

        Malformed input raises HERE, in the caller's thread — a bad request
        must not poison the co-batched requests of other callers (the
        worker's defensive error broadcast would fail the whole coalesced
        batch)."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        sequences = list(sequences)
        self.engine._encode(sequences)  # validates; raises to this caller only
        done = threading.Event()
        slot: Dict[str, Any] = {}
        self._q.put((sequences, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["probs"]

    def close(self) -> None:
        self._stop.set()
        for _ in self._workers:
            self._q.put(None)  # wake every worker
        for w in self._workers:
            w.join(timeout=5)
        # a submit racing close() may have enqueued after the sentinels;
        # fail those callers instead of stranding them on done.wait()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[2]["error"] = RuntimeError("MicroBatcher closed")
                item[1].set()

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                continue
            batch = [item]
            count = len(item[0])
            deadline = time.monotonic() + self.max_wait_s
            while count < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
                count += len(nxt[0])
            seqs = [s for req, _, _ in batch for s in req]
            try:
                probs = self.engine.score(seqs)
                off = 0
                for req, done, slot in batch:
                    slot["probs"] = probs[off : off + len(req)]
                    off += len(req)
                    done.set()
            except Exception as e:  # deliver, don't kill the worker
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()
            with self.engine.stats.lock:
                self.engine.stats.requests += len(batch)


def make_http_server(engine, port: int = 8000,
                     host: str = "127.0.0.1",
                     max_wait_ms: float = 5.0,
                     reload_fn=None):
    """Stdlib HTTP front end.  Returns (server, batcher); call
    ``server.serve_forever()`` (blocking) or drive it from a thread.

    POST /v1/predict  {"sequences": ["MKV..."], "top_k": 10,
                       "threshold": 0.5?}
        -> {"predictions": [[["GO:0005524", 0.93], ...], ...]}
    POST /v1/reload   {"model_file": "path.ckpt"} (only when ``reload_fn``
        is provided — cli.serve wires Trainer.load + engine.reload)
    GET  /healthz     -> {"status": "ok", "labels": N, ...stats}
    GET  /metrics     -> Prometheus text exposition of the same counters
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = MicroBatcher(engine, max_wait_ms=max_wait_ms)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "labels": len(engine.label_vocabulary),
                    "backend": engine.pn_cfg.pair_backend,
                    **engine.stats.snapshot(),
                })
            elif self.path == "/metrics":
                s = engine.stats.snapshot()
                fill = s["mean_batch_fill"]
                lines = [
                    "# TYPE protnote_requests_total counter",
                    f"protnote_requests_total {s['requests']}",
                    "# TYPE protnote_sequences_total counter",
                    f"protnote_sequences_total {s['sequences']}",
                    "# TYPE protnote_batches_total counter",
                    f"protnote_batches_total {s['batches']}",
                    "# TYPE protnote_device_seconds_total counter",
                    f"protnote_device_seconds_total "
                    f"{s['total_device_ms'] / 1e3:.3f}",
                    "# TYPE protnote_batch_fill_mean gauge",
                    f"protnote_batch_fill_mean "
                    f"{0.0 if fill is None else fill:.4f}",
                    "# TYPE protnote_labels gauge",
                    f"protnote_labels {len(engine.label_vocabulary)}",
                    "",
                ]
                blob = "\n".join(lines).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path == "/v1/reload":
                if reload_fn is None:
                    self._send(404, {"error": "reload not wired on this "
                                              "server (no reload_fn)"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    path = req.get("model_file")
                    if not path or not isinstance(path, str):
                        raise ValueError('body needs a "model_file" path')
                    reload_fn(path)
                    self._send(200, {"status": "reloaded",
                                     "model_file": path})
                except (ValueError, FileNotFoundError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    logger.exception("reload failed")
                    self._send(500, {"error": str(e)})
                return
            if self.path != "/v1/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                seqs = req.get("sequences")
                if not isinstance(seqs, list) or not seqs:
                    raise ValueError('body needs a non-empty "sequences" list')
                k = int(req.get("top_k", 10))
                threshold = req.get("threshold")
                probs = batcher.submit(seqs)
                preds = [
                    [[g, p] for g, p in pairs]
                    for pairs in topk_from_probs(
                        engine.label_vocabulary, probs, k,
                        None if threshold is None else float(threshold),
                    )
                ]
                self._send(200, {"predictions": preds})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("predict failed")
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("http: " + fmt, *args)

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher  # for clean shutdown
    return server, batcher
