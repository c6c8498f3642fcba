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

Under ``torchrun`` every rank builds the service on ``cuda:LOCAL_RANK``
and its runner shards the view batches over the ranks (when their count
divides 8), as the JAX server's runner shards them over the local devices
of its one process.  Rank 0 binds HTTP; each request's service call goes
through a ``Dispatcher``, which posts it to the other ranks through the
group's store so that every rank makes the same call in the same order
(their sampler's all-gathers meet); the other ranks follow, idle for as
long as rank 0 has no request, until rank 0 stops:

    torchrun --nproc_per_node 4 -m one2345_tpu_torch.pipeline.server --port 8080
"""

from __future__ import annotations

import base64
import contextlib
import datetime
import json
import os
import pickle
import sys
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from one2345_tpu_torch.core import meshes
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


class RankError(RuntimeError):
    """A service call raised on some rank of the process group."""


# What the session-reading calls take from earlier calls of the session:
# rank 0 checks it before a call goes out, so a call out of order fails
# before any rank starts it (the sessions of all ranks are equal).
SESSION_NEEDS = {
    "estimate_elevation": ("input_256",),  # unless the call passes an image
    "regenerate_view": ("stage1_all", "input_256"),
    "regenerate_views": ("stage1_all", "input_256"),
    "generate_mesh": ("stage1_all", "stage2_v0", "polar"),
    "regenerate_mesh": ("stage1_all", "stage2_v0", "polar"),
}
INT_ARGS = ("seed", "mesh_resolution")
# How long a follower's wait on the store lasts before it looks again: the
# store's wait has a deadline, the followers' idle time has none.
FOLLOW_POLL = datetime.timedelta(seconds=60)


def check_call(service, method: str, kwargs: dict) -> None:
    """Raise, before a call goes out to the ranks, what it would raise on
    every rank: ``KeyError`` for a missing session entry, ``TypeError``
    for a seed or resolution that is no integer, ``ValueError`` for a
    resolution below 1."""
    for name in INT_ARGS:
        value = kwargs.get(name)
        if value is not None and (isinstance(value, bool) or not isinstance(value, int)):
            raise TypeError(f"{name} must be an integer, not {value!r}")
    resolution = kwargs.get("mesh_resolution")
    if resolution is not None and resolution < 1:
        raise ValueError(f"mesh_resolution must be positive, not {resolution}")
    if method == "estimate_elevation" and kwargs.get("image") is not None:
        return
    for key in SESSION_NEEDS.get(method, ()):
        if key not in service._session:
            raise KeyError(key)


class Dispatcher:
    """Makes each service call on every rank of the process group, in the
    order rank 0 receives them.

    Rank 0 calls ``dispatcher(method, **kwargs)`` (``method`` names an
    attribute path of the service, e.g. 'preprocess' or 'pipeline.warmup').
    It checks the call first (``check_call``), then posts it and its
    arguments (an ``out_dir`` as None: rank 0 writes) to the group's
    rendezvous store under the call's number; every rank makes it, and the
    ranks all-gather whether it raised.  If it raised on any rank, every
    rank clears the service's session (their sessions may differ now) and
    rank 0 raises ``RankError``: the request fails and the next one starts
    from one state on every rank.  Ranks > 0 run ``follow``, waiting on the
    store for the next call until rank 0 calls ``stop``: the store's wait,
    unlike a collective, is renewed for as long as the server is idle, so
    an idle server outlives the group's timeout.

    A call that raises on one rank between two of its collectives (an
    out-of-memory error during sampling) leaves the other ranks waiting in
    the collective: that ends at the backend's timeout (NCCL's watchdog
    ends the processes; gloo raises), never as a quiet success, and the
    server has to be restarted.  In a world of one the call is made
    directly and its own exception propagates.

    :param device: the rank's device; calls run with it as the current
        card (the HTTP handler's threads start on card 0)
    :param group: the process group the ranks settle each call in
        (default: the whole world)
    """

    def __init__(self, service, device=None, group=None):
        self.service = service
        self.device = torch.device(device) if device is not None else None
        self.group = group
        self._seq = 0  # the number of the last call posted or received

    def _current(self):
        if self.device is not None and self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _key(self) -> str:
        return f"one2345_tpu_torch.server/{self._seq}"

    def _call(self, method: str, kwargs: dict):
        fn = self.service
        for name in method.split("."):
            fn = getattr(fn, name)
        return fn(**kwargs)

    def _make(self, method: str, kwargs: dict):
        """The call on this rank: (result, None) or (None, the error)."""
        try:
            return self._call(method, kwargs), None
        except Exception as e:  # noqa: BLE001: the ranks settle it together
            traceback.print_exc(file=sys.stderr)
            return None, f"{type(e).__name__}: {e}"

    def _post(self, msg) -> None:
        """Rank 0: the next message (a call, or None to stop)."""
        self._seq += 1
        _store().set(self._key(), pickle.dumps(msg))

    def _receive(self):
        """Ranks > 0: wait for the next message, with no deadline."""
        self._seq += 1
        store, key = _store(), self._key()
        while True:
            try:
                store.wait([key], FOLLOW_POLL)
                break
            except RuntimeError:  # the deadline passed, or the store is
                if store.check([key]):  # lost, and then this raises
                    break
        return pickle.loads(store.get(key))

    def _settle(self, error: str | None) -> None:
        errors = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(errors, error, group=self.group)
        if meshes.rank() == 0:  # every rank has read the message
            _store().delete_key(self._key())
        failed = {r: e for r, e in enumerate(errors) if e is not None}
        if failed:
            self.service.reset_session()
            raise RankError("; ".join(f"rank {r}: {e}" for r, e in failed.items()))

    def __call__(self, method: str, **kwargs):
        with self._current():
            if meshes.world_size() == 1:
                return self._call(method, kwargs)
            check_call(self.service, method, kwargs)
            self._post((method, {k: (None if k == "out_dir" else v) for k, v in kwargs.items()}))
            result, error = self._make(method, kwargs)
            self._settle(error)
            return result

    def follow(self) -> None:
        """Ranks > 0: make every call rank 0 posts, until ``stop``."""
        with self._current():
            while True:
                msg = self._receive()
                _, error = (None, None) if msg is None else self._make(*msg)
                try:
                    self._settle(error)
                except RankError:
                    pass  # rank 0 fails the request; every session is reset
                if msg is None:
                    return

    def stop(self) -> None:
        """Rank 0: release the followers (nothing in a world of one)."""
        if meshes.world_size() > 1:
            with self._current():
                self._post(None)
                self._settle(None)


def _store():
    """The process group's rendezvous store (torch has no public getter)."""
    return dist.distributed_c10d._get_default_store()


def make_handler(service, lock: threading.Lock, dispatcher: Dispatcher | None = None):
    """The request handler over ``service``; its calls go through
    ``dispatcher`` (default: ``Dispatcher(service)``)."""
    call = dispatcher or Dispatcher(service)

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
                        out = call("preprocess", image=image)
                        self._json({"image_b64": _encode_image(out)})
                    elif self.path == "/estimate_elevation":
                        elev = call("estimate_elevation", seed=req.get("seed", 0))
                        self._json({"elevation": float(elev)})
                    elif self.path == "/generate_mesh":
                        fmt = req.get("format", ".ply")
                        with tempfile.TemporaryDirectory() as td:
                            mesh = call(
                                "generate_mesh",
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


def serve(service=None, port: int = 8080, host: str = "127.0.0.1", warmup: bool = False,
          device=None):
    """Serve the pipeline over HTTP.

    Binds to loopback by default: a request can start seconds of card work
    and there is no auth or rate limiting here, so a fronting layer
    (reverse proxy, API gateway) must own both before the server listens on
    a routable interface (pass --host 0.0.0.0 explicitly).  ``warmup`` runs
    the pipeline once before accepting traffic.  Under ``torchrun`` (or in
    a process group the caller started) rank 0 serves and the other ranks
    follow its calls (``Dispatcher``) until it stops.

    :param device: None -> the card ('cuda:LOCAL_RANK' under torchrun)
    """
    with meshes.process_group(device) as dev:
        if service is None:
            from one2345_tpu_torch.pipeline.api import One2345Service
            from one2345_tpu_torch.pipeline.runner import One2345Pipeline

            service = One2345Service(One2345Pipeline(device=device or dev))
        dispatcher = Dispatcher(service, device or dev)
        if meshes.rank() != 0:
            dispatcher.follow()
            return
        try:
            if warmup:
                print("warming up (one run of every stage)...", flush=True)
                print(f"warm: {dispatcher('pipeline.warmup')}", flush=True)
            server = ThreadingHTTPServer((host, port),
                                         make_handler(service, threading.Lock(), dispatcher))
            print(f"serving on {host}:{port}", flush=True)
            try:
                server.serve_forever()
            finally:
                server.server_close()
        finally:
            dispatcher.stop()


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
