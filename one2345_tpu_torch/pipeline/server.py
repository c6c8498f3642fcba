"""Self-contained HTTP serving of the pipeline (stdlib only).

Counterpart of ``one2345_tpu/pipeline/server.py``: the reference demo's
endpoint contract (README.md:170-215) as a plain JSON / binary HTTP API:

    POST /preprocess          {"image_b64": <png>} -> {"image_b64": <png 256^2>}
    POST /estimate_elevation  {"seed": 0}          -> {"elevation": <deg>}
    POST /generate_mesh       {"mesh_resolution": 256, "format": ".glb"}
                              -> binary mesh body (model/gltf-binary or PLY)
    GET  /healthz             -> {"ok": true}

Images travel as base64 PNG through the port's codec (``utils.png``).  One
model instance serves the requests one at a time (the card is the
bottleneck; queuing happens in the socket backlog).  Run:

    python -m one2345_tpu_torch.pipeline.server --port 8080
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from one2345_tpu_torch.utils.png import decode_png, encode_png, to_rgba

# Largest accepted request body (a base64 PNG of a few-megapixel image fits
# comfortably; anything bigger is rejected with 413 instead of being read
# into memory on trust of Content-Length).
MAX_BODY_BYTES = 32 * 1024 * 1024
# Largest accepted image: preprocessing thumbnails to 512 px, and a PNG photo
# of more pixels would not fit in the body limit; a highly compressible file
# of up to PIL's 179M pixels would (about 0.7 GB of RGBA to inflate).
MAX_IMAGE_PIXELS = 4096 * 4096


def _decode_image(b64: str) -> np.ndarray:
    """base64 PNG -> [H, W, 4] uint8; raises over MAX_IMAGE_PIXELS."""
    return to_rgba(decode_png(base64.b64decode(b64), max_pixels=MAX_IMAGE_PIXELS))


def _encode_image(arr: np.ndarray) -> str:
    """[H, W, 3] float in [0, 1] -> base64 RGB PNG (truncated to uint8)."""
    return base64.b64encode(encode_png((np.clip(arr, 0, 1) * 255).astype(np.uint8))).decode()


def make_handler(service, lock: threading.Lock):
    class Handler(BaseHTTPRequestHandler):
        timeout = 60  # a stalled client cannot hold the worker forever

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json({"ok": True})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    # answer 413, then drain a bounded amount of the body so
                    # the client reads the answer instead of a TCP reset
                    self.close_connection = True
                    self._json({"error": "request body too large"}, 413)
                    remaining = min(n, 2 * MAX_BODY_BYTES)
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/preprocess":  # decoded outside the card's lock
                    image = _decode_image(req["image_b64"])
                with lock:
                    if self.path == "/preprocess":
                        out = service.preprocess(image)
                        self._json({"image_b64": _encode_image(out)})
                    elif self.path == "/estimate_elevation":
                        elev = service.estimate_elevation(seed=req.get("seed", 0))
                        self._json({"elevation": float(elev)})
                    elif self.path == "/generate_mesh":
                        fmt = req.get("format", ".ply")
                        with tempfile.TemporaryDirectory() as td:
                            mesh = service.generate_mesh(
                                out_dir=td, mesh_resolution=req.get("mesh_resolution", 256),
                                seed=req.get("seed", 0),
                            )
                            if fmt == ".glb":
                                from one2345_tpu_torch.recon.gltf import save_glb

                                path = os.path.join(td, "mesh.glb")
                                save_glb(path, mesh["vertices"], mesh["faces"], mesh["colors"])
                                ctype = "model/gltf-binary"
                            else:
                                path = os.path.join(td, "mesh.ply")
                                ctype = "application/octet-stream"
                            with open(path, "rb") as f:
                                self._bytes(f.read(), ctype)
                    else:
                        self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001: the client gets the error
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return Handler


def serve(service=None, port: int = 8080, host: str = "127.0.0.1", warmup: bool = False):
    """Serve the pipeline over HTTP.

    Binds to loopback by default: a request can start seconds of card work
    and there is no auth or rate limiting here, so a fronting layer
    (reverse proxy, API gateway) must own both before the server listens on
    a routable interface (pass --host 0.0.0.0 explicitly).  ``warmup`` runs
    the pipeline once before accepting traffic."""
    from one2345_tpu_torch.pipeline.api import One2345Service

    service = service or One2345Service()
    if warmup:
        print("warming up (one run of every stage)...", flush=True)
        print(f"warm: {service.pipeline.warmup()}", flush=True)
    server = ThreadingHTTPServer((host, port), make_handler(service, threading.Lock()))
    print(f"serving on {host}:{port}", flush=True)
    server.serve_forever()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; 0.0.0.0 only behind an authenticating proxy")
    p.add_argument("--warmup", action="store_true",
                   help="run every stage once before accepting traffic")
    args = p.parse_args(argv)
    serve(port=args.port, host=args.host, warmup=args.warmup)


if __name__ == "__main__":
    main()
