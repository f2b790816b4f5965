"""Serving on the CUDA card: FastAPI + Socket.IO when available, the stdlib
ASGI stack (``miniasgi``, ``miniosio``) otherwise.

Counterpart of ``animal_vision_tpu/server/app.py``, with the same names and
routes:

- ``GET /``            -> health string
- ``GET /ui``          -> the PWA shell (``ui/index.html``) with the species
                          list filled in; ``/manifest.webmanifest``,
                          ``/sw.js``, ``/ui/app.js``, ``/ui/app.css``
- ``POST /getpic``     -> {"image": <PNG data URI>} half/half split of a
                          data-URL frame (``service.processsplitimage``)
- ``POST /getframe``   -> {"image": <JPEG data URI>} the transformed frame
- ``POST /getgallery`` -> {"image": <PNG data URI>} a category's labeled grid
- ``POST /gettip``     -> Gemini fact tip ("" without ``GEMINI_API_KEY``)
- WebSocket ``/ws``    -> JSON {image, animal} in, {image} out, per message
- Socket.IO ``sendimage(image, animal)`` -> ``getimage`` {"image": uri}, from
  per-client bounded queues (``StreamHub``).

Every service call runs on ``device``: None means the CUDA card, and
without one ``build_asgi_app`` and ``run`` raise (``species.resolve_device``);
pass ``device="cpu"`` for the plain PyTorch path.

The handlers call ``visualize`` inside ``async def``, so a request holds the
event loop for as long as its frame takes. The Socket.IO drain loop takes
at most one frame per connected client per pass and processes each frame
alone and synchronously: frames of concurrent clients take turns, they are
not batched. The per-client queue is created on ``connect`` (and lazily on
``sendimage``).
"""

from __future__ import annotations

import asyncio
import base64
import collections
import functools
import json
import os

from animal_vision_tpu_torch.service import (
    processframe,
    processgallery,
    processimage,
    processsplitimage,
    species_categories,
)
from animal_vision_tpu_torch.species import animal_names, resolve_device

#: web-app manifest of the PWA: with the service worker (``ui/sw.js``, app
#: shell cache-first) it makes /ui installable and lets it open offline.
MANIFEST_JSON = json.dumps(
    {
        "name": "animal-vision-tpu",
        "short_name": "animal-vision",
        "start_url": "/ui",
        "display": "standalone",
        "background_color": "#ffffff",
        "theme_color": "#2266aa",
        "icons": [
            {
                "src": (
                    "data:image/svg+xml,<svg xmlns='http://www.w3.org/2000/svg' "
                    "viewBox='0 0 100 100'><text y='.9em' font-size='90'>"
                    "%F0%9F%90%BE</text></svg>"
                ),
                "sizes": "any",
                "type": "image/svg+xml",
                "purpose": "any",
            }
        ],
    }
)

_UI_DIR = os.path.join(os.path.dirname(__file__), "ui")


def _ui_asset(name: str) -> str:
    """A static /ui asset from ``server/ui/``."""
    with open(os.path.join(_UI_DIR, name), encoding="utf-8") as f:
        return f.read()


def ui_page() -> str:
    """The app shell with the species names and categories as its data."""
    data = {"animals": animal_names(), "categories": species_categories()}
    return _ui_asset("index.html").replace("__DATA__", json.dumps(data))


def gettip(animal: str) -> str:
    """Gemini fact tip: "" unless ``GEMINI_API_KEY`` is set and the
    google.generativeai package imports."""
    key = os.environ.get("GEMINI_API_KEY")
    if not key:
        return ""
    try:  # pragma: no cover - external service
        import google.generativeai as genai

        genai.configure(api_key=key)
        model = genai.GenerativeModel("gemini-2.5-flash")
        out = model.generate_content(
            f"One short fun fact about how a {animal} sees the world."
        )
        return out.text
    except Exception:
        return ""


class StreamHub:
    """Transport-agnostic core of the Socket.IO streaming path: per-client
    bounded queues drained by one loop that processes frames and emits
    results. ``process(image_bytes, animal)`` defaults to ``processimage``
    on ``device``; tests pass their own with a fake emit."""

    def __init__(self, maxlen: int = 100, process=None, device=None):
        self.conns: dict[str, collections.deque] = {}
        self.maxlen = maxlen
        self.process = process or functools.partial(processimage, device=device)

    def connect(self, sid: str) -> None:
        self.conns[sid] = collections.deque(maxlen=self.maxlen)

    def disconnect(self, sid: str) -> None:
        self.conns.pop(sid, None)

    def enqueue(self, sid: str, image, animal: str) -> None:
        # created lazily too, so that an enqueue racing a reconnect never
        # raises a KeyError
        self.conns.setdefault(sid, collections.deque(maxlen=self.maxlen)).append(
            (image, animal)
        )

    async def drain_once(self, emit) -> bool:
        """Process at most one frame per connected client; returns whether
        any work was done. ``emit(event, payload, sid)`` is awaited."""
        busy = False
        for sid, q in list(self.conns.items()):
            if q:
                image, animal = q.popleft()
                busy = True
                try:
                    uri = self.process(image, animal)
                    await emit("getimage", {"image": uri}, sid)
                except Exception as e:  # the loop survives a bad frame
                    await emit("error", {"error": str(e)}, sid)
        return busy

    async def drain_loop(self, emit, idle_sleep: float = 0.005) -> None:
        while True:
            if not await self.drain_once(emit):
                await asyncio.sleep(idle_sleep)


def _web_stack():
    """(FastAPI, WebSocketDisconnect, HTMLResponse, Response, socketio): the
    real packages when they import, else the stdlib ones (``miniasgi``,
    ``miniosio``), which speak the same ASGI and Socket.IO contracts, so the
    same handler code runs either way."""
    try:
        import socketio
        from fastapi import FastAPI, WebSocketDisconnect
        from fastapi.responses import HTMLResponse, Response

        return FastAPI, WebSocketDisconnect, HTMLResponse, Response, socketio
    except ImportError:
        from animal_vision_tpu_torch.server import miniasgi, miniosio

        return (
            miniasgi.FastAPI,
            miniasgi.WebSocketDisconnect,
            miniasgi.HTMLResponse,
            miniasgi.Response,
            miniosio,
        )


def build_asgi_app(device=None):
    """The ASGI app (REST, ``/ws`` and Socket.IO) serving on ``device``."""
    dev = resolve_device(device)
    FastAPI, WebSocketDisconnect, HTMLResponse, Response, socketio = _web_stack()

    api = FastAPI()
    sio = socketio.AsyncServer(async_mode="asgi", cors_allowed_origins="*")
    app = socketio.ASGIApp(sio, api)

    hub = StreamHub(device=dev)
    drain_task = None

    @api.get("/")
    async def root():
        return "animal-vision-tpu server"

    @api.get("/ui")
    async def ui():
        return HTMLResponse(ui_page())

    @api.get("/manifest.webmanifest")
    async def manifest():
        return Response(MANIFEST_JSON, media_type="application/manifest+json")

    @api.get("/sw.js")
    async def sw():
        return Response(_ui_asset("sw.js"), media_type="text/javascript")

    @api.get("/ui/app.js")
    async def ui_js():
        return Response(_ui_asset("app.js"), media_type="text/javascript")

    @api.get("/ui/app.css")
    async def ui_css():
        return Response(_ui_asset("app.css"), media_type="text/css")

    @api.post("/getpic")
    async def getpic(request):
        data = await request.json()
        return {"image": processsplitimage(data["image"], data["animal"], device=dev)}

    @api.post("/getframe")
    async def getframe(request):
        data = await request.json()
        return {"image": processframe(data["image"], data["animal"], device=dev)}

    @api.post("/getgallery")
    async def getgallery(request):
        """Labeled category grid of one frame (the CLI gallery's web
        analogue, ``service.processgallery``)."""
        data = await request.json()
        uri = processgallery(
            data["image"], data.get("category", "nonuv"), data.get("animals"), device=dev
        )
        return {"image": uri}

    @api.post("/gettip")
    async def tip(request):
        data = await request.json()
        return {"tip": gettip(data.get("animal", ""))}

    @api.websocket("/ws")
    async def ws_stream(websocket):
        """Live-video stream: JSON {image: dataURI, animal} in, {image} out.
        The built-in UI prefers this; Socket.IO ``sendimage`` stays for the
        reference PWA's clients."""
        await websocket.accept()
        try:
            while True:
                data = await websocket.receive_json()
                try:
                    uri = processframe(data["image"], data["animal"], device=dev)
                    await websocket.send_json({"image": uri})
                except Exception as e:
                    await websocket.send_json({"error": str(e)})
        except WebSocketDisconnect:
            pass

    async def _emit(event, payload, sid):
        await sio.emit(event, payload, to=sid)

    @sio.event
    async def connect(sid, environ):
        nonlocal drain_task
        hub.connect(sid)
        if drain_task is None:
            drain_task = sio.start_background_task(hub.drain_loop, _emit)

    @sio.event
    async def disconnect(sid):
        hub.disconnect(sid)

    @sio.event
    async def sendimage(sid, image, animal):
        # binary clients send raw image bytes; JSON-only transports send a
        # data URI or bare base64 string: both reach processimage as bytes
        if isinstance(image, str):
            payload = image.split(",", 1)[1] if "," in image else image
            image = base64.b64decode(payload)
        hub.enqueue(sid, image, animal)

    return app


class _StdlibHandler:
    """Framework-free REST core (path, body) -> (status, payload) with no
    event loop, for embedders and tests; ``run`` serves the full ASGI app."""

    @staticmethod
    def handle(path: str, body: bytes, device=None) -> tuple[int, dict]:
        data = json.loads(body or b"{}")
        if path == "/getpic":
            return 200, {"image": processsplitimage(data["image"], data["animal"], device=device)}
        if path == "/getframe":
            return 200, {"image": processframe(data["image"], data["animal"], device=device)}
        if path == "/getgallery":
            return 200, {
                "image": processgallery(
                    data["image"], data.get("category", "nonuv"), data.get("animals"), device=device
                )
            }
        if path == "/gettip":
            return 200, {"tip": gettip(data.get("animal", ""))}
        return 404, {"error": "not found"}


def run(host: str = "0.0.0.0", port: int = 8000, device=None) -> None:
    """Serve the app on ``device``: with uvicorn, FastAPI and socketio
    installed that stack serves it; otherwise the stdlib ASGI server
    (``miniasgi``) serves the same app, REST, ``/ws`` and Socket.IO."""
    app = build_asgi_app(device)
    try:
        import socketio  # noqa: F401
        import uvicorn
        from fastapi import FastAPI  # noqa: F401
    except ImportError:
        from animal_vision_tpu_torch.server import miniasgi

        print(f"stdlib ASGI server on {host}:{port} (REST + WebSocket + Socket.IO)")
        miniasgi.serve(app, host=host, port=port)
        return
    uvicorn.run(app, host=host, port=port)


if __name__ == "__main__":
    run()
