"""Streaming scan server, relay and client (counterpart of
``lidar_slam_tpu.io.server``; the port keeps its own copy of the
framework-free parts, byte for byte the same protocol).

The reference's edge data plane is three processes: ``Lidar_server.py``
(CSV rows as JSON, magic ``param=9000`` for the map PNG), ``ESP32_Server.c``
(HTTP relay) and ``esp32_edge.c`` (the client). ``GET /?param=N`` returns
scan row N as a JSON float array rounded to 2 decimals; ``param=9000``
returns the rendered map PNG; ``pose_x``/``pose_y`` query keys are accepted
and kept, as the firmware logs them.

``run_streaming_slam`` is the client end on the port: a prefetch thread
fetches and parses scans (it makes no CUDA call), and the calling thread
copies each into pinned host memory, then to the card without blocking, and
runs the fidelity step, whose one host sync (the keyframe test) also brings
the pose back. Only the client's stream imports torch (for its spans and
the step): a process that only serves stays light.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Queue
from urllib.parse import parse_qs, urlparse

import numpy as np

MAP_PARAM = 9000  # magic row id returning the rendered map (Lidar_server.py:34)


class ScanServer:
    """Serves dataset rows over HTTP. Runs in a background thread."""

    def __init__(self, ranges: np.ndarray, host: str = "127.0.0.1",
                 port: int = 0, map_png: str | None = None):
        ranges = np.asarray(ranges, np.float32)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                q = parse_qs(urlparse(self.path).query)
                try:
                    param = int(q.get("param", ["-1"])[0])
                except ValueError:
                    param = -1
                outer.last_pose = (q.get("pose_x", [None])[0],
                                   q.get("pose_y", [None])[0])
                if param == MAP_PARAM and map_png:
                    with open(map_png, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if 0 <= param < len(ranges):
                    body = json.dumps(
                        [round(float(v), 2) for v in ranges[param]]).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self.last_pose: tuple = (None, None)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "ScanServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class RelayServer:
    """HTTP relay: forwards each request to an upstream ``ScanServer`` and
    streams the body back — the ESP32's role in the reference's chain
    (``ESP32_Server.c:35-96``: parse ``param``/``pose_x``/``pose_y``, log
    the pose, proxy the query upstream, relay the JSON/PNG body; an
    upstream failure is relayed as 404). Runs in a background thread."""

    def __init__(self, upstream_url: str, host: str = "127.0.0.1",
                 port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                q = parse_qs(urlparse(self.path).query)
                outer.last_pose = (q.get("pose_x", [None])[0],
                                   q.get("pose_y", [None])[0])
                with outer._lock:
                    outer.n_relayed += 1
                try:
                    with urllib.request.urlopen(
                            upstream_url + "/?" + urlparse(self.path).query,
                            timeout=10.0) as resp:
                        body = resp.read()
                        ctype = resp.headers.get("Content-Type",
                                                 "application/json")
                except OSError:
                    # upstream connect failure or an HTTP error (both are
                    # OSErrors) -> 404 relay (ESP32_Server.c:68-71)
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self.last_pose: tuple = (None, None)
        self.n_relayed = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "RelayServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def fetch_scan(url: str, param: int, pose=None, timeout: float = 5.0
               ) -> np.ndarray:
    """Client side of the protocol (the esp32_edge.c:52-99 role)."""
    q = f"{url}/?param={param}"
    if pose is not None:
        q += f"&pose_x={pose[0]:.3f}&pose_y={pose[1]:.3f}"
    with urllib.request.urlopen(q, timeout=timeout) as resp:
        return np.asarray(json.loads(resp.read()), np.float32)


def _stream(url: str, n_scans: int, prefetch: int):
    """(scan, host clock when its bytes had arrived and parsed) pairs, from
    a prefetching thread. A fetch error ends the stream by raising it in
    the consumer. The consumer's wait for row N is an ``io.wait_row``
    span (``req`` N) while a profiler runs."""
    from lidar_slam_tpu_torch.utils.profiling import span

    q: Queue = Queue(maxsize=prefetch)

    def worker():
        try:
            for t in range(n_scans):
                scan = fetch_scan(url, t)
                q.put((scan, time.perf_counter()))
            q.put(None)
        except Exception as e:  # noqa: BLE001 - handed to the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    row = 0
    while True:
        with span("io.wait_row", req=row, host=True):
            item = q.get()
        row += 1
        if item is None:
            return
        if isinstance(item, Exception):
            raise item
        yield item


PREFETCH = 8   # scans fetched ahead of the step


def scan_stream(url: str, n_scans: int, prefetch: int = PREFETCH):
    """Prefetching iterator over served scans (host input pipeline)."""
    for scan, _ in _stream(url, n_scans, prefetch):
        yield scan


def run_streaming_slam(url: str, n_scans: int, cfg,
                       device: "str | torch.device" = "cuda",
                       latencies: list | None = None
                       ) -> tuple[np.ndarray, "object"]:
    """End-to-end streaming run: scans over HTTP -> fidelity steps on
    ``device``. Scan t is fetched while scan t-1 computes (the reference's
    edge loop, esp32_edge.c). Returns (path (T, 3) numpy, final state).

    Each scan goes from pinned host memory straight into the captured
    step's static input (``scan_matcher.make_step_fn``) without a host
    sync; the step's keyframe test, its one sync, brings the pose back with
    it. ``latencies``, if given, receives one (arrived, dequeued, pose on
    host) host-clock triple a scan after the first. The call is one
    ``session`` span."""
    import torch

    from lidar_slam_tpu_torch.device import resolve_device
    from lidar_slam_tpu_torch.models import scan_matcher
    from lidar_slam_tpu_torch.utils import graphs
    from lidar_slam_tpu_torch.utils.profiling import session

    dev = resolve_device(device)

    def host(scan: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(scan)
        # the caching host allocator keeps a pinned block until the copy
        # that reads it is done
        return t.pin_memory() if dev.type == "cuda" else t

    with session("run_streaming_slam", dev):
        step = scan_matcher.make_step_fn(cfg, dev)
        stream = _stream(url, n_scans, PREFETCH)
        first, _ = next(stream)
        state = scan_matcher.init_state(
            host(first).to(dev, non_blocking=True), cfg)
        poses = [np.zeros(3, np.float32)]
        for scan, arrived in stream:
            taken = time.perf_counter()
            state, pose = step(state, host(scan))
            poses.append(pose)
            if latencies is not None:
                latencies.append((arrived, taken, time.perf_counter()))
        return np.stack(poses), graphs.clone_tree(step.finish(state))
