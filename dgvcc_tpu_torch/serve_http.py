"""HTTP serving front end for ``VideoCounter``, counterpart of
dgvcc_tpu/serve_http.py (stdlib only).

Routes:
    GET  /healthz  -> {"status": "ok", "model": ..., "quantized": false}
    GET  /stats    -> {"frames": N, "requests": N, "batches": N,
                       "device_s": s, "fps": ..., "dispatch_fp": N,
                       "dispatch_int8": N}
    GET  /metrics  -> the same counters in the Prometheus text format
    POST /count    -> {"count": float}   (body: JPEG / PNG image bytes)

Request threads only decode the image and encode the answer; one
dispatcher thread owns the card. Same-shape frames that arrive within
``batch_window`` seconds go to the card as one batch of up to
``max_batch`` (``_take_batch``); frames of other shapes stay queued for a
batch of their own. On shutdown the queued requests fail at once.

On a serving mesh (``parallel/serving.py``) rank 0 runs the server over a
``Leader``: the dispatcher thread, the only thread that issues collectives,
sends each batch to the other ranks before counting it with them, and its
last act is the counter's ``close``, which stops them; ``shutdown`` waits
for it. ``/stats`` and ``dispatches`` are rank 0's.
"""

from __future__ import annotations

import io
import json
import signal
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# (name, /stats key) of each Prometheus counter, in exposition order
METRICS = (("dgvcc_frames_total", "frames"), ("dgvcc_requests_total", "requests"),
           ("dgvcc_batches_total", "batches"), ("dgvcc_device_seconds_total", "device_s"),
           ("dgvcc_dispatch_fp_total", "dispatch_fp"),
           ("dgvcc_dispatch_int8_total", "dispatch_int8"))


class Server(ThreadingHTTPServer):
    """The stdlib's threading server with a listen backlog of 128, not 5: a
    burst of more concurrent connections than the backlog loses SYNs, and
    each lost one is retried after a second."""

    request_queue_size = 128
    daemon_threads = True


class _Pending:
    __slots__ = ("frame", "event", "result", "error")

    def __init__(self, frame):
        self.frame = frame
        self.event = threading.Event()
        self.result = None
        self.error = None


class CountingServer:
    """Serves one counter (a ``VideoCounter``, or anything with
    ``count_frames``) over HTTP; ``start`` serves on a thread,
    ``serve_forever`` blocks."""

    def __init__(self, counter, host: str = "127.0.0.1", port: int = 8000,
                 model_name: str = "?", max_batch: int = 8,
                 batch_window: float = 0.005):
        self.counter = counter
        self.model_name = model_name
        self.max_batch = max(1, int(max_batch))
        self.batch_window = batch_window
        self._stats = {"frames": 0, "requests": 0, "batches": 0, "device_s": 0.0}
        self._stats_lock = threading.Lock()
        self._work: deque = deque()
        self._cv = threading.Condition()
        self._stopping = False
        self._serving = False
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._dispatcher.start()
        self.httpd = Server((host, port), self._handler_class())

    @property
    def port(self) -> int:
        """The bound port (an ephemeral one when asked for port 0)."""
        return self.httpd.server_address[1]

    # ---- the card's side -------------------------------------------------

    def _submit(self, frame: np.ndarray, timeout: float = 300.0) -> float:
        """Queue one (H, W, 3) uint8 frame; block until its count."""
        p = _Pending(frame)
        with self._cv:
            if self._stopping:
                raise RuntimeError("server shutting down")
            self._work.append(p)
            self._cv.notify()
        if not p.event.wait(timeout):
            raise TimeoutError("inference queue timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _take_batch(self):
        """The oldest request and the same-shape requests queued behind it
        or arriving within ``batch_window``, up to ``max_batch`` (one
        consumer: the dispatcher)."""
        with self._cv:
            while not self._work:
                if self._stopping:
                    return []
                self._cv.wait(timeout=0.1)
            batch = [self._work.popleft()]
        deadline = time.monotonic() + self.batch_window
        shape = batch[0].frame.shape
        while len(batch) < self.max_batch:
            with self._cv:
                i = next((j for j, p in enumerate(self._work) if p.frame.shape == shape),
                         None)
                if i is not None:
                    batch.append(self._work[i])
                    del self._work[i]
                    continue
            rem = deadline - time.monotonic()
            if rem <= 0:
                break
            time.sleep(min(rem, 0.001))
        return batch

    def _dispatch_loop(self):
        try:
            self._dispatch_until_stopped()
        finally:
            close = getattr(self.counter, "close", None)
            if close is not None:  # a mesh's leader: stop the other ranks
                close()

    def _dispatch_until_stopped(self):
        while not self._stopping:
            batch = self._take_batch()
            if not batch:
                continue
            try:
                frames = np.stack([p.frame for p in batch])
                t0 = time.perf_counter()
                counts = self.counter.count_frames(frames)
                dt = time.perf_counter() - t0
                with self._stats_lock:
                    self._stats["device_s"] += dt
                    self._stats["frames"] += len(batch)
                    self._stats["batches"] += 1
                for p, c in zip(batch, counts):
                    p.result = float(c)
            except Exception as e:  # every waiting request gets the error
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()
        # shutdown: what is still queued fails now, not at its timeout
        with self._cv:
            stranded, self._work = list(self._work), deque()
        for p in stranded:
            p.error = RuntimeError("server shutting down")
            p.event.set()

    def _count_image(self, body: bytes) -> float:
        from PIL import Image

        img = Image.open(io.BytesIO(body)).convert("RGB")
        return self._submit(np.asarray(img, np.uint8))

    def stats(self) -> dict:
        """The counters of /stats."""
        with self._stats_lock:
            s = dict(self._stats)
        s["fps"] = s["frames"] / s["device_s"] if s["device_s"] > 0 else 0.0
        d = getattr(self.counter, "dispatches", {"fp": 0, "int8": 0})
        s["dispatch_fp"], s["dispatch_int8"] = d["fp"], d["int8"]
        return s

    def metrics_text(self) -> str:
        """/metrics: the counters in the Prometheus text format."""
        s = self.stats()
        lines = []
        for name, key in METRICS:
            lines += [f"# TYPE {name} counter", f"{name} {s[key]}"]
        return "\n".join(lines) + "\n"

    # ---- the HTTP side -------------------------------------------------------

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: the counters are at /stats
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, payload: dict):
                self._send(code, json.dumps(payload).encode(), "application/json")

            def _count_request(self):
                with server._stats_lock:
                    server._stats["requests"] += 1

            def do_GET(self):
                self._count_request()
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", "model": server.model_name,
                                     "quantized": server.counter.quantized is not None})
                elif self.path == "/stats":
                    self._json(200, server.stats())
                elif self.path == "/metrics":
                    self._send(200, server.metrics_text().encode(),
                               "text/plain; version=0.0.4")
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                self._count_request()
                if self.path != "/count":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    self._json(400, {"error": "empty body"})
                    return
                body = self.rfile.read(n)
                try:
                    count = server._count_image(body)
                except Exception as e:  # undecodable image, a shutdown, ...
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {"count": count})

        return Handler

    def start(self) -> threading.Thread:
        """Serve on a daemon thread (tests, embedding); returns it."""
        self._serving = True
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def serve_forever(self):
        """Serve until SIGTERM or SIGINT (in-flight batches finish, queued
        requests fail at once)."""
        print(f"[serve] http on :{self.port} (POST /count, GET /healthz, /stats, "
              "/metrics)", flush=True)
        self._serving = True
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, lambda *_: threading.Thread(
                    target=self.shutdown, daemon=True).start())
            except ValueError:  # not the main thread: no handler possible
                pass
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)

    def shutdown(self):
        """Stop serving; a counter with ``close`` (a mesh's leader) is
        closed by the dispatcher, which this waits for (at most as long as
        a request waits for its count)."""
        self._stopping = True
        with self._cv:
            self._cv.notify_all()
        if (getattr(self.counter, "close", None) is not None
                and threading.current_thread() is not self._dispatcher):
            self._dispatcher.join(300.0)
        if self._serving:
            # BaseServer.shutdown waits for a serve_forever loop: without
            # one it would wait forever
            self._serving = False
            self.httpd.shutdown()
        self.httpd.server_close()
