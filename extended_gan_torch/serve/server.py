"""Inference server over an exported artifact (port of ``serve/server.py``).

The same HTTP contract as the JAX package's server, on stdlib alone:

  GET  /healthz   -> JSON: the artifact's i/o contract, device and stats
  POST /predict   -> body: a serialized ``.npy`` batch (np.save bytes);
                     response: the prediction batch as ``.npy`` bytes.

``bucket_batches=True`` (default) pads every request batch up to the next
power of two and slices the padded rows off the reply, as the JAX server
does to bound its compiled executables: here it bounds the set of shapes
that cuDNN picks algorithms for. Predictions are per sample, so padding
cannot perturb the real rows: an MoE artifact routes each sample apart
(``serve/export.py``), so a padded row takes no expert capacity.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..core.device import resolve_device
from .export import load_exported


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ModelServer:
    """Owns the loaded artifact and a lock-serialised predict path: one
    process drives one card, and concurrent HTTP handlers take turns."""

    def __init__(self, artifact_path: str, *, device=None,
                 bucket_batches: bool = True):
        self.device = resolve_device(device)
        self.artifact = load_exported(artifact_path, device=self.device)
        self._bucket = bucket_batches
        self._lock = threading.Lock()
        self._requests = 0
        self.artifact_path = artifact_path

    def contract(self) -> dict:
        return {
            "artifact": self.artifact_path,
            "platforms": [self.device.type],
            "device": str(self.device),
            "inputs": [self.artifact.inputs],
            "outputs": [self.artifact.outputs],
            "bucket_batches": self._bucket,
            "requests_served": self._requests,
        }

    def predict(self, x: np.ndarray) -> np.ndarray:
        window = self.artifact.window_shape
        if x.ndim != 1 + len(window) or tuple(x.shape[1:]) != window:
            raise ValueError(f"expected a batch of shape (b, "
                             f"{', '.join(map(str, window))}), got {x.shape}")
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if self._bucket:
            padded = _next_pow2(max(n, 1))
            if padded != n:
                x = np.concatenate([x, np.zeros((padded - n, *window),
                                                np.float32)])
        with self._lock, torch.inference_mode():
            y = self.artifact.fn(torch.from_numpy(x).to(self.device))
            y = y.cpu().numpy()
            self._requests += 1
        return y[:n]


class _Handler(BaseHTTPRequestHandler):
    server_version = "egt-torch-serve/1"
    model: ModelServer  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            body = json.dumps(self.model.contract()).encode()
            self._reply(200, body, "application/json")
        else:
            self._reply(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, b"not found", "text/plain")
            return
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length)
        try:
            x = np.load(io.BytesIO(raw), allow_pickle=False)
            y = self.model.predict(np.ascontiguousarray(x))
            buf = io.BytesIO()
            np.save(buf, y)
            self._reply(200, buf.getvalue(), "application/octet-stream")
        except Exception as e:  # malformed input must not kill the server
            body = json.dumps({"error": str(e)}).encode()
            self._reply(400, body, "application/json")


def make_server(artifact_path: str, *, host: str = "127.0.0.1", port: int = 0,
                device=None, bucket_batches: bool = True) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` picks a free
    port (read it back from ``server.server_address``)."""
    model = ModelServer(artifact_path, device=device,
                        bucket_batches=bucket_batches)
    handler = type("Handler", (_Handler,), {"model": model})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(artifact_path: str, *, host="127.0.0.1", port=8000,
                  device=None, bucket_batches=True):
    server = make_server(artifact_path, host=host, port=port, device=device,
                         bucket_batches=bucket_batches)
    print(f"[serve] {artifact_path} on http://{host}:{server.server_address[1]}")
    print(json.dumps(server.RequestHandlerClass.model.contract(), indent=2))
    try:
        server.serve_forever()
    finally:
        server.server_close()
