"""The benchmark's frozen scan server: the reference's edge data plane, a
copy of ``lidar_slam_tpu_torch.io.server``'s ``ScanServer`` and
``RelayServer`` with the pacing of ``chip_smoke.py``'s phase 15.

The reference serves a recorded log over HTTP (``Submodule_2/
Lidar_server.py``) through a relay (``ESP32_Server.c``) to the edge client
(``esp32_edge.c``): ``GET /?param=N`` returns row N as a JSON float array
rounded to 2 decimals. ``serve_chain`` runs both servers in a process of its
own (in one process with the client, their threads' interpreter lock time
would land on the client's latency) and paces them as a sensor does: row N is
held until row 0's release time + N x ``pace`` seconds. It records when
each row was due and when it was released, so a run can say how late the
server ran. NumPy and the standard library only; it imports nothing of the
program.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

DECIMALS = 2   # the reference protocol's rounding


def encode_row(row: np.ndarray, decimals: int = DECIMALS) -> bytes:
    """One row as the protocol serves it."""
    return json.dumps([round(float(v), decimals) for v in row]).encode()


def served_rows(ranges: np.ndarray, decimals: int = DECIMALS) -> np.ndarray:
    """The rows as a client parses them: f32 of each value rounded to
    ``decimals`` in decimal, as ``encode_row`` rounds it."""
    return np.asarray([[round(float(v), decimals) for v in row]
                       for row in np.asarray(ranges, np.float32)],
                      np.float32)


class _Server:
    def __init__(self, handler_cls):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(10)


class PacedScanServer(_Server):
    """Serves ``ranges`` rows; with ``pace`` > 0 row N waits until row 0's
    release time + N x pace. ``released[N]`` and ``due[N]`` are host clocks
    (``time.perf_counter``, one clock for every process on the host) of the
    last time row N was served."""

    def __init__(self, ranges: np.ndarray, decimals: int = DECIMALS):
        ranges = np.asarray(ranges, np.float32)
        outer = self
        self.pace = 0.0
        self.t0 = 0.0
        self.due: dict[int, float] = {}
        self.released: dict[int, float] = {}

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                q = parse_qs(urlparse(self.path).query)
                try:
                    n = int(q.get("param", ["-1"])[0])
                except ValueError:
                    n = -1
                if not 0 <= n < len(ranges):
                    self.send_error(404)
                    return
                now = time.perf_counter()
                if n == 0:
                    outer.t0 = now
                due = outer.t0 + n * outer.pace
                time.sleep(max(0.0, due - now))
                outer.due[n] = due
                outer.released[n] = time.perf_counter()
                body = encode_row(ranges[n], decimals)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        super().__init__(Handler)


class RelayServer(_Server):
    """Forwards each request upstream and relays the body (the ESP32's
    role, ``ESP32_Server.c:35-96``; an upstream failure is relayed as 404).
    """

    def __init__(self, upstream_url: str):
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                try:
                    with urllib.request.urlopen(
                            upstream_url + "/?" + urlparse(self.path).query,
                            timeout=10.0) as resp:
                        body = resp.read()
                except OSError:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        super().__init__(Handler)


def serve_chain(ranges: np.ndarray, conn, decimals: int = DECIMALS) -> None:
    """The data plane in a process of its own: a ``PacedScanServer`` on
    ``ranges`` and a ``RelayServer`` in front of it. Sends the relay's URL
    on ``conn``, then answers messages: ``("pace", seconds)`` sets the pace
    (0 serves at once), ``("clock",)`` returns (t0, {row: due}, {row:
    released}) and forgets them, ``("stop",)`` stops both servers and
    returns."""
    srv = PacedScanServer(ranges, decimals).start()
    relay = RelayServer(srv.url).start()
    try:
        conn.send(relay.url)
        while True:
            msg = conn.recv()
            if msg[0] == "pace":
                srv.pace = float(msg[1])
                conn.send(True)
            elif msg[0] == "clock":
                conn.send((srv.t0, dict(srv.due), dict(srv.released)))
                srv.due.clear()
                srv.released.clear()
            else:
                conn.send(True)
                return
    finally:
        relay.stop()
        srv.stop()
