"""Live progressive-render preview over HTTP.

The reference's L9 layer is an OpenGL window fed by a shared byte buffer
(Program.cs:110-135, SURVEY.md); a GPU render host is headless, so the
equivalent is a tiny zero-dependency HTTP server that serves the latest
tonemapped frame with auto-refresh — open http://localhost:<port> while a
render runs. Thread-based; `ViewerServer.update(image01)` swaps in each new
frame (the Program.Bitmap analogue).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ptsharp import film

_PAGE = b"""<!doctype html><html><head><title>ptsharp</title>
<style>body{background:#111;margin:0;display:flex;align-items:center;
justify-content:center;height:100vh}img{image-rendering:pixelated;
max-width:95vw;max-height:95vh}</style></head>
<body><img id=f src=/frame.png>
<script>setInterval(()=>{document.getElementById('f').src=
'/frame.png?'+Date.now()},1000)</script></body></html>"""


class ViewerServer:
    def __init__(self, port: int = 8765):
        self.port = port
        self._png: bytes = b""
        self._lock = threading.Lock()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        data = viewer._png
                    if not data:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self) -> "ViewerServer":
        self._thread.start()
        return self

    def update(self, image01) -> None:
        """Swap in a new (H, W, 3) [0,1] frame."""
        png = film.png_bytes(film.to_rgb8(image01))
        with self._lock:
            self._png = png

    def stop(self) -> None:
        self._server.shutdown()
