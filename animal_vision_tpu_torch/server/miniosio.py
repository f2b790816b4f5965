"""Minimal Socket.IO v5 / Engine.IO v4 server over ASGI WebSocket, of
``animal_vision_tpu_torch``.

The port's own copy of ``animal_vision_tpu/server/miniosio.py`` (the port
imports nothing of the JAX package); only this docstring differs. For
machines without python-socketio it implements the documented wire
protocol subset the app needs — WebSocket transport only, default
namespace, JSON text events — with the same ``AsyncServer`` / ``ASGIApp``
API that ``app.py`` binds to, so the same handler code (connect / sendimage
/ disconnect + emit) runs against real protocol traffic whether the real
package or this one is underneath.

Wire format (engine.io packet type digit, then socket.io payload):
  server -> '0{"sid":...,"upgrades":[],"pingInterval":...,...}'  open
  client -> '40'                    socket.io CONNECT (default namespace)
  server -> '40{"sid":"..."}'       CONNECT ack
  client -> '42["event",arg,...]'   EVENT
  server -> '42["event",arg,...]'   EVENT
  server -> '2' ping, client -> '3' pong    (EIO v4 heartbeat)
  client -> '41' namespace disconnect, '1' engine close
"""

from __future__ import annotations

import asyncio
import inspect
import json
import secrets


class _Session:
    def __init__(self, sid: str, send):
        self.sid = sid
        self._send = send  # async (text) -> None
        self.connected = False  # socket.io namespace handshake done

    async def send_text(self, text: str) -> None:
        await self._send(text)


class AsyncServer:
    """python-socketio AsyncServer API subset (asgi mode, "/" namespace)."""

    def __init__(
        self,
        async_mode: str = "asgi",
        cors_allowed_origins="*",
        ping_interval: float = 25.0,
        ping_timeout: float = 20.0,
        **_,
    ):
        self.handlers: dict[str, callable] = {}
        self._sessions: dict[str, _Session] = {}
        self.ping_interval = ping_interval
        self.ping_timeout = ping_timeout

    # -- registration (decorator or .on) ------------------------------------
    def event(self, fn):
        self.handlers[fn.__name__] = fn
        return fn

    def on(self, name: str):
        def deco(fn):
            self.handlers[name] = fn
            return fn

        return deco

    def start_background_task(self, target, *args):
        return asyncio.create_task(target(*args))

    async def emit(self, event: str, data=None, to: str | None = None, **_):
        payload = json.dumps([event, data] if data is not None else [event])
        targets = [self._sessions[to]] if to in self._sessions else (
            [] if to else list(self._sessions.values())
        )
        for sess in targets:
            if sess.connected:
                await sess.send_text("42" + payload)

    async def _trigger(self, name: str, *args):
        fn = self.handlers.get(name)
        if fn is None:
            return
        out = fn(*args)
        if inspect.isawaitable(out):
            await out

    # -- ASGI endpoint (websocket transport) --------------------------------
    async def handle_asgi(self, scope, receive, send) -> None:
        if scope["type"] != "websocket":
            # engine.io polling transport is not implemented; real browsers
            # are pointed at transports=["websocket"] by the served UI
            await _plain_http(send, 400, b"websocket transport only")
            return
        msg = await receive()
        if msg["type"] != "websocket.connect":
            return
        await send({"type": "websocket.accept"})

        sid = secrets.token_urlsafe(16)

        async def send_text(text: str):
            await send({"type": "websocket.send", "text": text})

        sess = _Session(sid, send_text)
        self._sessions[sid] = sess
        await send_text(
            "0"
            + json.dumps(
                {
                    "sid": sid,
                    "upgrades": [],
                    "pingInterval": int(self.ping_interval * 1000),
                    "pingTimeout": int(self.ping_timeout * 1000),
                    "maxPayload": 10_000_000,
                }
            )
        )

        async def heartbeat():
            while True:
                await asyncio.sleep(self.ping_interval)
                try:
                    await send_text("2")
                except Exception:
                    return

        hb = asyncio.create_task(heartbeat())
        try:
            while True:
                msg = await receive()
                if msg["type"] == "websocket.disconnect":
                    break
                text = msg.get("text")
                if text is None:
                    continue  # binary attachments unused by this app
                if not await self._packet(sess, text, scope):
                    break
        finally:
            hb.cancel()
            self._sessions.pop(sid, None)
            if sess.connected:
                await self._trigger("disconnect", sid)

    async def _packet(self, sess: _Session, text: str, scope) -> bool:
        """Dispatch one engine.io packet; False ends the session."""
        etype, rest = text[0], text[1:]
        if etype == "1":  # engine close
            return False
        if etype == "2":  # client ping (EIO v3 compat) -> pong
            await sess.send_text("3" + rest)
            return True
        if etype == "3":  # pong for our ping
            return True
        if etype != "4":  # non-message packet we don't handle
            return True
        stype, payload = rest[0], rest[1:]
        if stype == "0":  # CONNECT
            sess.connected = True
            await self._trigger("connect", sess.sid, {"asgi.scope": scope})
            await sess.send_text("40" + json.dumps({"sid": sess.sid}))
            return True
        if stype == "1":  # namespace DISCONNECT
            return False
        if stype == "2":  # EVENT
            # Clients that pass a callback prefix the JSON array with an
            # integer ack id ('42<id>["event",...]'); strip it and reply
            # with an empty ACK ('43<id>[]') so such clients don't stall.
            i = 0
            while i < len(payload) and payload[i].isdigit():
                i += 1
            ack_id, payload = payload[:i], payload[i:]
            data = json.loads(payload)
            await self._trigger(data[0], sess.sid, *data[1:])
            if ack_id:
                await sess.send_text("43" + ack_id + "[]")
            return True
        return True  # ACK/BINARY packets unused


async def _plain_http(send, status: int, body: bytes) -> None:
    await send(
        {
            "type": "http.response.start",
            "status": status,
            "headers": [(b"content-type", b"text/plain")],
        }
    )
    await send({"type": "http.response.body", "body": body})


class ASGIApp:
    """Routes /socket.io/* to the engine, everything else to the wrapped
    ASGI app (python-socketio's ASGIApp contract)."""

    def __init__(self, socketio_server: AsyncServer, other_asgi_app=None):
        self.sio = socketio_server
        self.other = other_asgi_app

    async def __call__(self, scope, receive, send):
        if scope["type"] in ("http", "websocket") and scope["path"].startswith(
            "/socket.io"
        ):
            await self.sio.handle_asgi(scope, receive, send)
            return
        if self.other is not None:
            await self.other(scope, receive, send)
            return
        if scope["type"] == "http":
            await _plain_http(send, 404, b"not found")
