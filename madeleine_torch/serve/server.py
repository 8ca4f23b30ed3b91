"""Slide-embedding serving: a micro-batching core behind a stdlib HTTP front.

Port of `madeleine_tpu/serve/server.py`:

- requests enqueue bags; a dispatcher thread groups them by length bucket and
  flushes when `max_batch` accumulate or `max_wait_ms` elapse;
- each group is padded to a power-of-two batch of its bucket length, so the
  set of shapes stays small, and encoded in one call (kernel K1 at bf16,
  K2 at f32, on the GPU);
- responses return embeddings as JSON.

Endpoints:
  POST /encode        body: .npz bytes with a 'features' [n, d] array, or raw
                      f32 with headers X-Rows/X-Cols
  POST /encode_batch  body: .npz with 'features' [total, d] (row-concat of k
                      bags) + 'offsets' [k+1] prefix sums -> k embeddings
  GET  /healthz       liveness + model info
  GET  /stats         counters (requests, batches, slides, p50/p95 latency)
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from madeleine_torch.config import compute_dtype
from madeleine_torch.data.datasets import DEFAULT_BUCKETS, grow_bucket
from madeleine_torch.models.madeleine import MADELEINE, encode
from madeleine_torch.utils.device import resolve_device


class _Pending:
    __slots__ = ("feats", "event", "result", "error", "t_enqueue")

    def __init__(self, feats: np.ndarray):
        self.feats = feats
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.t_enqueue = time.perf_counter()


class EmbeddingService:
    """Micro-batching encode core (HTTP-free). The model moves to `device`
    (default CUDA); the compute dtype is the config's precision."""

    def __init__(self, model: MADELEINE, buckets=DEFAULT_BUCKETS, max_batch: int = 32,
                 max_wait_ms: float = 5.0, stain_idx: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.buckets = sorted(buckets)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.stain_idx = stain_idx
        self.dtype = compute_dtype(self.cfg.precision)
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        # bounded ring + lock: stats are touched by HTTP threads and the dispatcher
        self._latencies: "deque[float]" = deque(maxlen=1000)
        self._stats_lock = threading.Lock()
        self.counters = {"requests": 0, "batches": 0, "slides": 0, "bucket_growths": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _encode(self, feats: np.ndarray, mask: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(feats).to(self.device).to(self.dtype)
        m = torch.from_numpy(mask).to(self.device)
        emb = encode(self.model, x, stain_idx=self.stain_idx, mask=m)
        return emb.float().cpu().numpy()

    def warmup(self, batch_sizes=None, verbose: bool = True) -> None:
        """Run every (bucket, pow2 batch) shape the dispatcher can emit once,
        so first requests find the kernels built and the allocator warm."""
        if batch_sizes is None:
            batch_sizes, bs_ = [], 1
            while bs_ < self.max_batch:
                batch_sizes.append(bs_)
                bs_ <<= 1
            batch_sizes.append(bs_)
        d = self.cfg.patch_embedding_dim
        for bucket in self.buckets:
            for bs in batch_sizes:
                self._encode(np.zeros((bs, bucket, d), np.float32),
                             np.ones((bs, bucket), bool))
                if verbose:
                    print(f"* warmed bucket={bucket} bs={bs}")

    def _validated(self, feats: np.ndarray) -> _Pending:
        if feats.ndim != 2:
            raise ValueError(f"features must be [n, d], got {feats.shape}")
        if feats.shape[1] != self.cfg.patch_embedding_dim:
            raise ValueError(f"feature dim {feats.shape[1]} != model input dim "
                             f"{self.cfg.patch_embedding_dim}")
        return _Pending(np.asarray(feats, np.float32))

    def encode(self, feats: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        """Blocking single-bag encode (thread-safe)."""
        return self.encode_many([feats], timeout)[0]

    def encode_many(self, bags: List[np.ndarray], timeout: float = 120.0) -> List[np.ndarray]:
        """Blocking multi-bag encode. All bags enqueue at once (after all are
        validated), so the dispatcher batches them together."""
        pending = [self._validated(f) for f in bags]
        with self._stats_lock:
            self.counters["requests"] += len(pending)
        for p in pending:
            self._q.put(p)
        deadline = time.perf_counter() + timeout
        out = []
        for p in pending:
            if not p.event.wait(max(0.0, deadline - time.perf_counter())):
                raise TimeoutError("encode timed out")
            if p.error:
                raise RuntimeError(p.error)
            out.append(p.result)
        return out

    def _bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        # oversize bags run whole in a grown pow2 bucket, counted in /stats
        with self._stats_lock:
            self.counters["bucket_growths"] += 1
        return grow_bucket(n, self.buckets[-1])

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            groups: Dict[int, List[_Pending]] = {}
            for p in batch:
                groups.setdefault(self._bucket_of(p.feats.shape[0]), []).append(p)
            for bucket, items in groups.items():
                try:
                    d = items[0].feats.shape[1]
                    bs = 1 << (len(items) - 1).bit_length()  # pow2 batch shape
                    feats = np.zeros((bs, bucket, d), np.float32)
                    mask = np.zeros((bs, bucket), bool)
                    for i, p in enumerate(items):
                        feats[i, :len(p.feats)] = p.feats
                        mask[i, :len(p.feats)] = True
                    emb = self._encode(feats, mask)
                    now = time.perf_counter()
                    with self._stats_lock:
                        for p in items:
                            self._latencies.append(now - p.t_enqueue)
                        self.counters["batches"] += 1
                        self.counters["slides"] += len(items)
                    for i, p in enumerate(items):
                        p.result = emb[i]
                        p.event.set()
                except Exception as e:  # propagate to every waiter
                    for p in items:
                        p.error = f"{type(e).__name__}: {e}"
                        p.event.set()

    def stats(self) -> Dict:
        with self._stats_lock:
            lat = np.asarray(self._latencies or [0.0])
            counters = dict(self.counters)
        return {**counters,
                "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
                "latency_p95_ms": float(np.percentile(lat, 95) * 1e3),
                "embed_dim": self.cfg.embed_dim}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


def make_handler(service: EmbeddingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "model": service.cfg.EXP_CODE,
                                  "embed_dim": service.cfg.embed_dim,
                                  "device": str(service.device)})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.path == "/encode":
                    if self.headers.get("X-Rows"):
                        feats = np.frombuffer(raw, np.float32).reshape(
                            int(self.headers["X-Rows"]), int(self.headers["X-Cols"]))
                    else:
                        with np.load(io.BytesIO(raw)) as npz:
                            feats = npz["features"]
                    emb = service.encode(np.asarray(feats, np.float32))
                    self._reply(200, {"embedding": emb.tolist()})
                elif self.path == "/encode_batch":
                    with np.load(io.BytesIO(raw)) as npz:
                        feats = np.asarray(npz["features"], np.float32)
                        offs = np.asarray(npz["offsets"], np.int64)
                    if offs.ndim != 1 or len(offs) < 2 or offs[0] != 0 \
                            or offs[-1] != len(feats) or np.any(np.diff(offs) <= 0):
                        raise ValueError("offsets must be increasing prefix sums "
                                         "[0, ..., len(features)] with nonempty bags")
                    bags = [feats[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
                    embs = service.encode_many(bags)
                    self._reply(200, {"embeddings": [e.tolist() for e in embs]})
                else:
                    self._reply(404, {"error": "not found"})
            except (ValueError, KeyError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(model: MADELEINE, host: str = "0.0.0.0", port: int = 8000,
          warmup: bool = False, device=None, **service_kw) -> None:
    """Blocking serve loop on `device` (default CUDA)."""
    service = EmbeddingService(model, device=device, **service_kw)
    if warmup:
        service.warmup()
    server = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"* Serving MADELEINE embeddings on {host}:{port} "
          f"(embed_dim={service.cfg.embed_dim}, device={service.device})")
    try:
        server.serve_forever()
    finally:
        service.close()
