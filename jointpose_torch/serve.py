"""Minimal HTTP inference server, stdlib only (counterpart of
``jointpose/serve.py``, one device).

Loads a checkpoint once, warms the detector+MRF forward at every batch
bucket and input type, then serves joint coordinates over HTTP.  Requests
batch up to ``--batch-size`` images; a smaller batch is padded to the
smallest bucket that holds it, so the card only ever sees the warmed
shapes.

Concurrent small requests are coalesced: one dispatcher thread drains a
queue of pending requests and packs same-dtype chunks into one device
batch (waiting up to ``--batch-wait-ms`` for stragglers), so N concurrent
1-image requests cost about one padded dispatch instead of N.  The
dispatcher copies each batch to the card and launches it; a completion
thread waits on a CUDA event recorded after the coordinates' copy into
pinned host memory, so batch N+1 is launched while batch N still runs.

API:
  GET  /healthz            -> {"status": "ok", "step": N, "batcher": {...}}
  POST /predict            -> {"predictions": [{"joints": {...}}, ...]}
       body: {"images": [[...HxWx3 floats in [0,1]...], ...]}
       or    npy bytes (Content-Type: application/x-npy) of shape
             (B, H, W, 3), float32 in [0,1] or uint8 RGB (uint8 goes to
             the card as it is and is normalized there)

With ``--quantize N`` or ``--quantize-artifact NPZ`` the int8 detector of
``ops/quant.py`` replaces the float one, in front of the same MRF tail.

With ``--mesh-data D --mesh-model M`` each batch is served over a D x M
device mesh (``parallel/mesh.DeviceMesh``, ``predict.build_predictor``):
split over 'data', the trunk's image rows over 'model'.

CLI:  python -m jointpose_torch.serve --config joint \\
          --checkpoint runs/joint/checkpoints --port 8471 \\
          [--quantize-artifact int8.npz] [--mesh-data 2 --mesh-model 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from jointpose_torch import skeleton
from jointpose_torch.cli import add_device_flag, apply_device
from jointpose_torch.configs import Config, get_config


class ServiceOverloaded(RuntimeError):
    """Raised by predict() when admitting the request would grow the
    queue past max_queue_images: the HTTP layer maps it to 503 so that
    clients back off instead of watching latency grow without bound."""


class _Pending:
    """One enqueued chunk (at most batch_size images) awaiting results."""

    __slots__ = ("images", "event", "coords", "error")

    def __init__(self, images: np.ndarray):
        self.images = images
        self.event = threading.Event()
        self.coords: np.ndarray | None = None
        self.error: Exception | None = None


class PoseService:
    """Holds the predictor and the serving batch buckets.

    All requests flow through one dispatcher thread that coalesces queued
    same-dtype chunks into a single padded device batch (bounded by
    ``batch_wait_ms``), so the card only sees warmed shapes and concurrent
    callers share dispatches.  ``device`` is the CUDA device unless the
    caller asks for the CPU.  ``quantize_calib`` (training images to
    calibrate on) or ``quantize_artifact`` (a ``quantize`` npz) puts the
    int8 detector of ``ops/quant.py`` in place of the float one.  ``mesh``
    (a ``parallel.mesh.DeviceMesh``, exclusive with the int8 detector)
    serves each batch over its devices, the trunk's rows split over its
    'model' axis; every bucket must divide its 'data' axis, and the batches
    go to its first device.
    """

    def __init__(self, config: Config, checkpoint_dir: str, batch_size: int,
                 step: int | None = None, best: bool = True, mesh=None,
                 batch_wait_ms: float = 2.0, quantize_calib: int = 0,
                 quantize_artifact: str | None = None,
                 batch_buckets: list[int] | None = None,
                 max_queue_images: int = 0, max_inflight: int = 2,
                 device: str | torch.device | None = None):
        from jointpose_torch.predict import (
            build_predictor, predictor_for, resolve_device, restore_params,
        )

        quantized = quantize_calib > 0 or bool(quantize_artifact)
        if mesh is not None and quantized:
            raise ValueError("quantized serving is exclusive with mesh serving")
        self.config = config
        self.batch_size = batch_size
        self.device = resolve_device(device if mesh is None else mesh.devices[0])
        # Batch-size buckets: a lone 1-image request pads to the smallest
        # bucket that fits instead of the full serving batch.  Each bucket
        # costs one warm-up per input type at startup; the largest bucket
        # is always batch_size.
        buckets = sorted(set(batch_buckets or []))
        if any(b < 1 or b > batch_size for b in buckets):
            raise ValueError(
                f"batch_buckets {buckets} must lie in [1, batch_size={batch_size}]"
            )
        self._buckets = buckets + [batch_size]
        if mesh is not None:
            bad = [b for b in self._buckets if b % mesh.shape["data"]]
            if bad:
                raise ValueError(f"batch buckets {bad} do not divide the mesh data axis "
                                 f"({mesh.shape['data']})")
        params, self.step = restore_params(config, checkpoint_dir, step, best=best)
        if quantized:
            from jointpose_torch.ops.quant import quantized_model_for

            model, _ = quantized_model_for(config, params, quantize_calib, quantize_artifact,
                                           device=self.device)
            self._predict = predictor_for(config, model, self.device)
        else:
            self._predict = build_predictor(config, params, device=self.device, mesh=mesh,
                                            spatial=mesh is not None)
        # Warm both accepted input types at every bucket, so that the first
        # request of each shape finds the DFT tables, the kernels built and
        # cuDNN's algorithms chosen.
        h, w = config.data.image_hw
        for b in self._buckets:
            for dtype in (torch.float32, torch.uint8):
                self._predict(torch.zeros((b, h, w, 3), dtype=dtype))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

        # Micro-batcher: one dispatcher thread owns the device, so the model
        # is never entered concurrently and concurrent small requests pack
        # into one padded batch.
        self._wait_s = max(batch_wait_ms, 0.0) / 1e3
        self._queue: collections.deque[_Pending] = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        # Load shedding, counted in images since requests vary in size: a
        # request is rejected up front (503) when admitting all its chunks
        # would push the queue past the cap, except against an empty queue,
        # which always admits one request of any size.  Default cap: 32
        # full batches of queueing delay.
        self.max_queue_images = int(max_queue_images) or 32 * batch_size
        self._queued_images = 0
        self.stats = {"requests": 0, "images": 0, "dispatches": 0,
                      "coalesced_batches": 0, "shed_requests": 0}
        # Per-request host latency (enqueue -> all results) and per-dispatch
        # batch fill over the last 1024 events; request threads, the
        # dispatcher and /healthz share them under this lock.
        self._stats_lock = threading.Lock()
        self._latencies: collections.deque[float] = collections.deque(maxlen=1024)
        self._fills: collections.deque[float] = collections.deque(maxlen=1024)
        # Pipelined completion: a launch returns before the card is done, and
        # only a host thread waiting on the result needs it finished.  The
        # dispatcher hands (result, event, waiters) to a completion thread
        # through a bounded queue (backpressure caps the batches in flight at
        # max_inflight), so batch N+1 is launched while batch N still runs.
        self._inflight: queue.Queue = queue.Queue(maxsize=max(int(max_inflight), 1))
        self._completer = threading.Thread(
            target=self._completion_loop, name="pose-complete", daemon=True
        )
        self._completer.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="pose-dispatch", daemon=True
        )
        self._dispatcher.start()

    # -- dispatcher ----------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                first = self._queue.popleft()
                self._queued_images -= first.images.shape[0]
            batch = [first]
            n = first.images.shape[0]
            dtype = first.images.dtype
            # Wait up to batch_wait_ms for more same-dtype chunks, but never
            # split a chunk: a head that would overflow the batch (or has
            # the other dtype) stays queued for the next dispatch.
            deadline = time.monotonic() + self._wait_s
            while n < self.batch_size:
                with self._cond:
                    if not self._queue:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or self._closed:
                            break
                        self._cond.wait(timeout=remaining)
                        if not self._queue:
                            continue  # check the deadline again
                    head = self._queue[0]
                    if head.images.dtype != dtype or n + head.images.shape[0] > self.batch_size:
                        break
                    batch.append(self._queue.popleft())
                    self._queued_images -= batch[-1].images.shape[0]
                    n += batch[-1].images.shape[0]
            self._run(batch, n)

    def _run(self, batch: list[_Pending], n: int) -> None:
        """Launch one coalesced batch and hand its coordinates, on their
        way to the host, to the completion thread."""
        coords = ready = None
        err: Exception | None = None
        try:
            chunk = (batch[0].images if len(batch) == 1
                     else np.concatenate([p.images for p in batch]))
            # Smallest bucket that fits: the dispatcher never collects more
            # than batch_size, the largest bucket.
            bucket = next(b for b in self._buckets if b >= n)
            pad = bucket - n
            if pad:
                h, w = self.config.data.image_hw
                chunk = np.concatenate([chunk, np.zeros((pad, h, w, 3), chunk.dtype)])
            # uint8 stays uint8 to the card (the model normalizes it there:
            # 4x fewer bytes to copy); anything else is float in [0, 1].
            images = torch.from_numpy(chunk if chunk.dtype == np.uint8
                                      else chunk.astype(np.float32, copy=False))
            if self.device.type == "cuda":
                images = images.pin_memory().to(self.device, non_blocking=True)
                out, _ = self._predict(images)
                coords = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                coords.copy_(out, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                coords, _ = self._predict(images)
        except Exception as e:  # surface to every waiter, keep dispatching
            err = e
        self.stats["dispatches"] += 1
        if len(batch) > 1:
            self.stats["coalesced_batches"] += 1
        with self._stats_lock:
            # Fill is relative to the bucket actually dispatched.
            self._fills.append(n / next(b for b in self._buckets if b >= n))
        # Bounded put: blocks while max_inflight batches are unfinished.
        self._inflight.put((coords, ready, err, batch))

    def _completion_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:  # close() sentinel
                return
            coords, ready, err, batch = item
            try:
                if err is None:
                    if ready is not None:
                        ready.synchronize()  # the card has written the coordinates
                    coords_np = coords.numpy()
                    offset = 0
                    for p in batch:
                        p.coords = coords_np[offset : offset + p.images.shape[0]]
                        offset += p.images.shape[0]
                else:
                    for p in batch:
                        p.error = err
            except Exception as e:  # a fault on the card surfaces here
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()

    def metrics(self) -> dict:
        """Counters and latency/fill summaries for /healthz (last 1024
        requests and dispatches)."""
        out = dict(self.stats)
        with self._cond:
            out["queue_depth_images"] = self._queued_images
        out["max_queue_images"] = self.max_queue_images
        with self._stats_lock:
            lat = list(self._latencies)
            fills = list(self._fills)
        if lat:
            q = np.percentile(lat, [50, 95])
            out["request_latency_ms"] = {
                "p50": round(float(q[0]) * 1e3, 2),
                "p95": round(float(q[1]) * 1e3, 2),
                "max": round(max(lat) * 1e3, 2),
            }
        if fills:
            out["mean_batch_fill"] = round(float(np.mean(fills)), 3)
        return out

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._dispatcher.join(timeout=10)
        # The dispatcher has drained the queue; let the completion thread
        # finish every batch in flight, then stop it.
        self._inflight.put(None)
        self._completer.join(timeout=10)

    # -- request path --------------------------------------------------

    def predict(self, images: np.ndarray) -> list[dict]:
        h, w = self.config.data.image_hw
        if images.ndim != 4 or images.shape[1:] != (h, w, 3):
            raise ValueError(f"expected images of shape (B, {h}, {w}, 3), got {images.shape}")
        bs = self.batch_size
        # Enqueue every chunk of at most bs images up front (a large request
        # pipelines its own chunks through the dispatcher), then wait.
        pendings = [
            _Pending(np.ascontiguousarray(images[start : start + bs]))
            for start in range(0, images.shape[0], bs)
        ]
        n_imgs = int(images.shape[0])
        with self._cond:
            if self._closed:
                raise RuntimeError("service is shut down")
            if self._queued_images and self._queued_images + n_imgs > self.max_queue_images:
                self.stats["shed_requests"] += 1
                raise ServiceOverloaded(
                    f"queue holds {self._queued_images} images; admitting {n_imgs} more "
                    f"would exceed max_queue_images={self.max_queue_images}; retry later"
                )
            self.stats["requests"] += 1
            self.stats["images"] += n_imgs
            self._queue.extend(pendings)
            self._queued_images += n_imgs
            self._cond.notify_all()
        t0 = time.monotonic()
        out: list[dict] = []
        for p in pendings:
            p.event.wait()
            if p.error is not None:
                raise p.error
        with self._stats_lock:
            self._latencies.append(time.monotonic() - t0)
        for p in pendings:
            for row in p.coords:
                out.append({"joints": {
                    name: [float(row[j, 0]), float(row[j, 1])]
                    for j, name in enumerate(skeleton.JOINTS)
                }})
        return out


def make_handler(service: PoseService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict, headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "step": service.step,
                                 "config": service.config.name,
                                 "batcher": service.metrics()})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "application/json")
                if ctype == "application/x-npy":
                    # float32 in [0,1] or uint8 RGB; uint8 rides through to
                    # the card as it is (see PoseService._run).
                    images = np.load(io.BytesIO(raw), allow_pickle=False)
                    if images.dtype != np.uint8:
                        images = images.astype(np.float32)
                else:
                    images = np.asarray(json.loads(raw)["images"], np.float32)
                preds = service.predict(images)
                self._send(200, {"predictions": preds, "step": service.step})
            except ServiceOverloaded as e:
                # Overload is the client's signal to back off.
                self._send(503, {"error": str(e)}, {"Retry-After": "1"})
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})

    return Handler


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="jointpose_torch inference server")
    parser.add_argument("--config", default="flagship")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--port", type=int, default=8471)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--pool-mode", choices=["max", "stride"], default=None,
                        help="override the trunk downsampling mode (normally adopted from "
                             "the checkpoint's metadata)")
    parser.add_argument("--mrf-precision", choices=["high", "default"], default="default",
                        help="MRF message-pass matmul precision; serving defaults to "
                             "'default' (on the card one TF32 pass in the Fourier paths)")
    parser.add_argument("--quantize", type=int, default=0, metavar="N_CALIB",
                        help="serve the int8-quantized detector (ops/quant.py), calibrating on "
                             "N_CALIB training images")
    parser.add_argument("--quantize-artifact", default=None, metavar="NPZ",
                        help="load a prebuilt int8 artifact (python -m jointpose_torch.quantize) "
                             "instead of calibrating")
    parser.add_argument("--batch-buckets", default=None, metavar="N,N,...",
                        help="extra batch sizes below --batch-size (e.g. '1,8'): a small "
                             "request pads only to the smallest bucket that fits")
    parser.add_argument("--max-queue-images", type=int, default=0,
                        help="load-shedding cap: reject (HTTP 503) any request that would "
                             "grow the pending queue past this many images (0 = 32x "
                             "batch-size; an empty queue always admits one request)")
    parser.add_argument("--batch-wait-ms", type=float, default=2.0,
                        help="how long the dispatcher waits to coalesce concurrent requests "
                             "into one device batch (0 = dispatch whatever is queued)")
    parser.add_argument("--max-inflight", type=int, default=2,
                        help="device batches launched but not yet finished (1 = synchronous)")
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="data-parallel devices: split each serving batch over this many "
                             "devices (0/1 = off; must divide --batch-size)")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="spatial-parallel devices: split the detector trunk's image rows "
                             "over this many devices")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import with_mrf_precision

    device = apply_device(args.device)
    mesh = None
    if args.mesh_data > 1 or args.mesh_model > 1:
        from jointpose_torch.parallel.mesh import make_device_mesh

        if args.batch_size % max(args.mesh_data, 1):
            parser.error(f"--mesh-data {args.mesh_data} must divide --batch-size {args.batch_size}")
        mesh = make_device_mesh(max(args.mesh_data, 1), args.mesh_model, device)

    config = reconcile_config(get_config(args.config), args.checkpoint, args.pool_mode)
    config = with_mrf_precision(config, args.mrf_precision)
    buckets = ([int(b) for b in args.batch_buckets.split(",") if b.strip()]
               if args.batch_buckets else None)
    service = PoseService(
        config, args.checkpoint, args.batch_size, step=args.step, mesh=mesh,
        batch_wait_ms=args.batch_wait_ms, quantize_calib=args.quantize,
        quantize_artifact=args.quantize_artifact, batch_buckets=buckets,
        max_queue_images=args.max_queue_images, max_inflight=args.max_inflight,
        device=device,
    )
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(service))
    print(f"serving {args.config} (step {service.step}) on 127.0.0.1:{args.port}", flush=True)

    # Graceful shutdown: SIGTERM/SIGINT stop accepting connections, let the
    # requests in flight finish, dispatch whatever is queued and join the
    # dispatcher, so a drain never drops an accepted request.
    # server.shutdown() blocks until serve_forever returns, so it runs off
    # the signal handler's thread.
    def _graceful(signum, frame):
        print(f"[serve] signal {signum}: draining", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        server.serve_forever()
    finally:
        service.close()
        server.server_close()
        print("[serve] shut down cleanly", flush=True)


if __name__ == "__main__":
    main()
