"""A loopback stand-in for the DeepMIMO scenario database.

Serves the requests the database clients make (``api.upload``,
``upload_images``, ``upload_rt_source``, ``download``, ``search``) on
127.0.0.1 and records them, so tests and ``chip_smoke.py`` can drive the
clients end to end without a network::

    with MockDatabase() as db:
        config.set("api_endpoint", db.url)
        ...
        db.received["submission"], db.requests
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MockDatabase:
    """Presign -> PUT storage -> submission; download token -> GET storage;
    search; image upload. ``received`` holds the last stored archive
    (``zip``), the submission, the search query and the image paths;
    ``requests`` every (method, path, headers of interest) in order."""

    HEADERS = ("Authorization", "Content-Type", "X-Content-Sha256")

    def __init__(self):
        self.received = {}
        self.requests = []
        db = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _record(self):
                db.requests.append((self.command, self.path, {
                    k: self.headers[k] for k in db.HEADERS
                    if self.headers.get(k) is not None}))

            def _body(self):
                return self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))

            def _send(self, body, code=200, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(json.dumps(obj).encode(), code)

            def do_GET(self):
                self._record()
                if self.path.startswith("/api/presign"):
                    self._json({"url": f"{db.url}/storage/put"})
                elif self.path.startswith("/api/download"):
                    self._json({"url": f"{db.url}/storage/get"})
                elif self.path.startswith("/storage/get"):
                    self._send(db.received.get("zip", b""),
                               ctype="application/zip")
                else:
                    self._json({"error": "not found"}, 404)

            def do_PUT(self):
                self._record()
                db.received["zip"] = self._body()
                self._json({"ok": True})

            def do_POST(self):
                self._record()
                body = self._body()
                if self.path.startswith("/api/submissions"):
                    db.received["submission"] = json.loads(body)
                    self._json({"id": 42, "status": "created"})
                elif self.path.startswith("/api/search"):
                    db.received["query"] = json.loads(body)
                    self._json({"scenarios": ["city_a", "city_b"]})
                elif self.path.startswith("/api/images"):
                    db.received.setdefault("images", []).append(
                        (self.path, len(body)))
                    self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
