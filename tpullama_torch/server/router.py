"""Multi-model router server (tools/server/server-models.cpp analog).

Started without a model (`python -m tpullama_torch.server.router`), it manages
child single-model servers as subprocesses — each spawned on a free port
on demand — and proxies API requests to the instance selected by the
request's "model" field (server.cpp:118-151 router mode):

  GET  /models, /v1/models     list instances + load state
  POST /models/load            {"model": <path or name>} spawn instance
  POST /models/unload          {"model": <name>}
  POST /models/status          per-instance status
  POST /v1/completions, /v1/chat/completions, ... proxied by "model"
  GET  /health                 router liveness

Instance lifecycle mirrors the reference: a free port per child, wait
for the child's /health, optional LRU eviction via --max-instances.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Instance:
    def __init__(self, name: str, path: str, extra_args: list[str]):
        self.name = name
        self.path = path
        self.port = _free_port()
        self.t_last_used = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpullama_torch.server.http",
             "-m", path, "--port", str(self.port), "--host", "127.0.0.1",
             *extra_args],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env={**os.environ, "LLAMA_SERVER_ROUTER": "1"},
        )

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def wait_ready(self, timeout: float = 300.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self.proc.poll() is not None:
                return False
            try:
                urllib.request.urlopen(self.base + "/health", timeout=2)
                return True
            except Exception:
                time.sleep(0.25)
        return False

    @property
    def status(self) -> str:
        if self.proc.poll() is not None:
            return "exited"
        try:
            urllib.request.urlopen(self.base + "/health", timeout=2)
            return "loaded"
        except Exception:
            return "loading"

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()


class Router:
    def __init__(self, extra_args: list[str] | None = None,
                 max_instances: int = 0):
        self.instances: dict[str, Instance] = {}
        self.extra_args = extra_args or []
        self.max_instances = max_instances
        self.lock = threading.Lock()

    def load(self, model: str) -> Instance:
        name = os.path.basename(model)
        with self.lock:
            inst = self.instances.get(name)
            if inst is not None and inst.status != "exited":
                return inst
            if self.max_instances and len(self.instances) >= self.max_instances:
                # evict the least recently used (server-models.cpp LRU)
                lru = min(self.instances.values(), key=lambda i: i.t_last_used)
                lru.stop()
                del self.instances[lru.name]
            inst = Instance(name, model, self.extra_args)
            self.instances[name] = inst
        return inst

    def unload(self, name: str) -> bool:
        with self.lock:
            inst = self.instances.pop(name, None)
        if inst is None:
            return False
        inst.stop()
        return True

    def get(self, name: str | None) -> Instance | None:
        with self.lock:
            if name and name in self.instances:
                inst = self.instances[name]
            elif len(self.instances) == 1:
                inst = next(iter(self.instances.values()))
            else:
                return None
        inst.t_last_used = time.time()
        return inst

    def stop_all(self):
        for inst in list(self.instances.values()):
            inst.stop()


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, msg, code=400):
            self._json({"error": {"message": msg, "code": code}}, code)

        def _models_payload(self):
            return {
                "object": "list",
                "data": [
                    {"id": i.name, "object": "model", "owned_by": "tpullama",
                     "path": i.path, "port": i.port, "status": i.status}
                    for i in router.instances.values()
                ],
            }

        def _proxy(self, method: str, body: bytes | None):
            name = None
            if body:
                try:
                    name = json.loads(body).get("model")
                except json.JSONDecodeError:
                    pass
            inst = router.get(name)
            if inst is None:
                return self._error(
                    f"no loaded instance for model {name!r}; POST "
                    "/models/load first", 404)
            req = urllib.request.Request(
                inst.base + self.path, data=body, method=method,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    self.send_response(r.status)
                    ctype = r.headers.get("Content-Type", "application/json")
                    self.send_header("Content-Type", ctype)
                    if ctype.startswith("text/event-stream"):
                        # SSE pass-through, chunked
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        while True:
                            chunk = r.read(4096)
                            if not chunk:
                                break
                            self.wfile.write(
                                f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        self.wfile.write(b"0\r\n\r\n")
                    else:
                        data = r.read()
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
            except urllib.error.HTTPError as e:
                data = e.read()
                self.send_response(e.code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:  # child died / timeout
                self._error(f"proxy error: {type(e).__name__}: {e}", 502)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/health", "/v1/health"):
                self._json({"status": "ok", "role": "router"})
            elif path in ("/models", "/v1/models", "/api/tags"):
                self._json(self._models_payload())
            elif path == "/props":
                self._json({"role": "router",
                            "total_instances": len(router.instances)})
            else:
                self._proxy("GET", None)

        def do_POST(self):
            path = self.path.split("?")[0]
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else None
            if path == "/models/load":
                try:
                    model = json.loads(body or b"{}").get("model")
                except json.JSONDecodeError:
                    return self._error("invalid JSON body")
                if not model:
                    return self._error('"model" is required')
                inst = router.load(model)
                if not inst.wait_ready():
                    router.unload(inst.name)
                    return self._error(f"instance {inst.name!r} failed to "
                                       "start", 500)
                self._json({"success": True, "name": inst.name,
                            "port": inst.port})
            elif path == "/models/unload":
                try:
                    name = json.loads(body or b"{}").get("model")
                except json.JSONDecodeError:
                    return self._error("invalid JSON body")
                if not router.unload(os.path.basename(name or "")):
                    return self._error(f"model {name!r} not loaded", 404)
                self._json({"success": True})
            elif path == "/models/status":
                self._json(self._models_payload())
            else:
                self._proxy("POST", body)

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8080, block: bool = True,
          extra_args: list[str] | None = None, max_instances: int = 0,
          preload: list[str] | None = None):
    router = Router(extra_args=extra_args, max_instances=max_instances)
    for m in preload or []:
        router.load(m).wait_ready()
    httpd = ThreadingHTTPServer((host, port), make_handler(router))
    httpd.router = router
    if block:
        try:
            httpd.serve_forever()
        finally:
            router.stop_all()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="tpullama-router",
        description="multi-model router server (spawns per-model "
                    "instances, proxies by the request's \"model\" field)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--models", nargs="*", default=[],
                    help="GGUF paths to preload")
    ap.add_argument("--max-instances", type=int, default=0,
                    help="LRU-evict beyond this many children (0 = no cap)")
    ap.add_argument("--child-args", default="",
                    help="extra args passed to child servers")
    a = ap.parse_args(argv)
    print(f"router on http://{a.host}:{a.port}")
    serve(a.host, a.port, extra_args=a.child_args.split() or None,
          max_instances=a.max_instances, preload=a.models)
    return 0


if __name__ == "__main__":
    sys.exit(main())
