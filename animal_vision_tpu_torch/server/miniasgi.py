"""Minimal ASGI web toolkit of ``animal_vision_tpu_torch``: the FastAPI
surface ``server/app.py`` uses, plus a stdlib-only asyncio HTTP/1.1 +
WebSocket (RFC 6455) server to run it.

The port's own copy of ``animal_vision_tpu/server/miniasgi.py`` (the port
imports nothing of the JAX package); only this docstring differs. It
supplies FastAPI + uvicorn's contract from the standard library for
machines that have neither: route decorators, JSON request/response
objects, websocket endpoints, and a ``serve()`` loop that speaks enough
HTTP/1.1 (Content-Length bodies) and WebSocket (masked client frames,
text/close/ping) for browsers and the stdlib Socket.IO engine
(``miniosio.py``). ``app.py`` prefers the real packages when they import and
falls back to this, so the same handler code runs either way.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import inspect
import json
import struct
from urllib.parse import parse_qs, unquote


class Response:
    media_type = "text/plain"

    def __init__(self, content="", media_type: str | None = None, status_code: int = 200):
        self.content = content
        self.status_code = status_code
        if media_type is not None:
            self.media_type = media_type

    def body(self) -> bytes:
        c = self.content
        return c if isinstance(c, bytes) else str(c).encode()


class HTMLResponse(Response):
    media_type = "text/html; charset=utf-8"


class JSONResponse(Response):
    media_type = "application/json"

    def body(self) -> bytes:
        return json.dumps(self.content).encode()


class Request:
    def __init__(self, scope: dict, body: bytes):
        self.scope = scope
        self._body = body

    async def json(self):
        return json.loads(self._body or b"{}")


class WebSocketDisconnect(Exception):
    pass


class WebSocket:
    """ASGI websocket wrapper with the starlette method surface."""

    def __init__(self, scope: dict, receive, send):
        self.scope = scope
        self._receive = receive
        self._send = send

    async def accept(self, subprotocol: str | None = None) -> None:
        msg = await self._receive()  # websocket.connect
        if msg["type"] != "websocket.connect":
            raise WebSocketDisconnect()
        await self._send({"type": "websocket.accept", "subprotocol": subprotocol})

    async def receive_text(self) -> str:
        msg = await self._receive()
        if msg["type"] == "websocket.disconnect":
            raise WebSocketDisconnect()
        if msg.get("text") is None:
            raise WebSocketDisconnect()  # binary frames unused by this app
        return msg["text"]

    async def receive_json(self):
        return json.loads(await self.receive_text())

    async def send_text(self, text: str) -> None:
        await self._send({"type": "websocket.send", "text": text})

    async def send_json(self, data) -> None:
        await self.send_text(json.dumps(data))

    async def close(self, code: int = 1000) -> None:
        await self._send({"type": "websocket.close", "code": code})


class App:
    """FastAPI-subset ASGI application: get/post/websocket decorators,
    handlers may take no argument, a Request, or a WebSocket."""

    def __init__(self):
        self._http: dict[tuple[str, str], callable] = {}
        self._ws: dict[str, callable] = {}

    def get(self, path: str):
        return self._register("GET", path)

    def post(self, path: str):
        return self._register("POST", path)

    def _register(self, method: str, path: str):
        def deco(fn):
            self._http[(method, path)] = fn
            return fn

        return deco

    def websocket(self, path: str):
        def deco(fn):
            self._ws[path] = fn
            return fn

        return deco

    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] == "websocket":
            handler = self._ws.get(scope["path"])
            if handler is None:
                await send({"type": "websocket.close", "code": 1008})
                return
            ws = WebSocket(scope, receive, send)
            try:
                await handler(ws)
            except WebSocketDisconnect:
                pass
            return
        # http
        body = b""
        while True:
            msg = await receive()
            body += msg.get("body", b"")
            if not msg.get("more_body"):
                break
        handler = self._http.get((scope["method"], scope["path"].rstrip("/") or "/"))
        if handler is None:
            await _send_http(send, 404, b'{"error": "not found"}', "application/json")
            return
        try:
            kwargs = {}
            params = inspect.signature(handler).parameters
            if params:
                kwargs[next(iter(params))] = Request(scope, body)
            result = handler(**kwargs)
            if inspect.isawaitable(result):
                result = await result
        except Exception as e:  # handler error -> 500, never a dropped socket
            await _send_http(
                send, 500, json.dumps({"error": str(e)}).encode(), "application/json"
            )
            return
        if isinstance(result, Response):
            await _send_http(send, result.status_code, result.body(), result.media_type)
        else:  # FastAPI semantics: plain values are JSON-encoded
            await _send_http(send, 200, json.dumps(result).encode(), "application/json")


async def _send_http(send, status: int, body: bytes, media_type: str) -> None:
    await send(
        {
            "type": "http.response.start",
            "status": status,
            "headers": [
                (b"content-type", media_type.encode()),
                (b"content-length", str(len(body)).encode()),
                (b"access-control-allow-origin", b"*"),
            ],
        }
    )
    await send({"type": "http.response.body", "body": body})


# Aliases so app.py can `from miniasgi import FastAPI, ...`
FastAPI = App

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + _WS_MAGIC).encode()).digest()).decode()


def _ws_frame(opcode: int, payload: bytes) -> bytes:
    """Server->client frame (unmasked)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


async def _ws_read_frame(reader) -> tuple[bool, int, bytes]:
    """One (possibly masked) client frame -> (fin, opcode, payload)."""
    b1, b2 = await reader.readexactly(2)
    fin = bool(b1 & 0x80)
    opcode = b1 & 0x0F
    masked = b2 & 0x80
    n = b2 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    mask = await reader.readexactly(4) if masked else b"\x00" * 4
    data = await reader.readexactly(n)
    if masked:
        data = bytes(c ^ mask[i % 4] for i, c in enumerate(data))
    return fin, opcode, data


async def _serve_connection(app, reader, writer):
    try:
        while True:
            request_line = await reader.readline()
            if not request_line:
                return
            try:
                method, target, _ = request_line.decode().split(" ", 2)
            except ValueError:
                return
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            path, _, qs = target.partition("?")
            path = unquote(path)

            if headers.get("upgrade", "").lower() == "websocket":
                key = headers.get("sec-websocket-key", "")
                writer.write(
                    b"HTTP/1.1 101 Switching Protocols\r\n"
                    b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    b"Sec-WebSocket-Accept: " + _ws_accept_key(key).encode() + b"\r\n\r\n"
                )
                await writer.drain()
                await _bridge_websocket(app, path, qs, reader, writer)
                return

            body = b""
            n = int(headers.get("content-length", 0))
            if n:
                body = await reader.readexactly(n)
            scope = {
                "type": "http",
                "method": method,
                "path": path,
                "query_string": qs.encode(),
                "headers": [(k.encode(), v.encode()) for k, v in headers.items()],
            }
            sent_body = [body]

            async def receive():
                b, sent_body[0] = sent_body[0], b""
                return {"type": "http.request", "body": b, "more_body": False}

            async def send(msg):
                if msg["type"] == "http.response.start":
                    writer.write(f"HTTP/1.1 {msg['status']} X\r\n".encode())
                    for hk, hv in msg["headers"]:
                        writer.write(hk + b": " + hv + b"\r\n")
                    writer.write(b"Connection: keep-alive\r\n\r\n")
                elif msg["type"] == "http.response.body":
                    writer.write(msg.get("body", b""))
                    await writer.drain()

            await app(scope, receive, send)
    except (asyncio.IncompleteReadError, ConnectionError):
        pass
    finally:
        writer.close()


async def _bridge_websocket(app, path: str, qs: str, reader, writer):
    """Run the ASGI websocket protocol over a raw upgraded socket."""
    inbox: asyncio.Queue = asyncio.Queue()
    await inbox.put({"type": "websocket.connect"})
    closed = asyncio.Event()

    async def pump():  # socket frames -> ASGI messages
        # Browsers fragment large messages (Chrome at ~128 KiB), so a 1080p
        # data-URI frame arrives as an 0x1 frame with FIN=0 followed by 0x0
        # continuations; buffer until FIN before delivering (RFC 6455 §5.4).
        frag_op = 0
        frag_buf = bytearray()
        try:
            while not closed.is_set():
                fin, opcode, data = await _ws_read_frame(reader)
                if opcode == 0x8:  # close
                    await inbox.put({"type": "websocket.disconnect", "code": 1000})
                    return
                if opcode == 0x9:  # ping -> pong (control frames interleave)
                    writer.write(_ws_frame(0xA, data))
                    await writer.drain()
                    continue
                if opcode == 0xA:  # pong
                    continue
                if opcode in (0x1, 0x2):
                    frag_op = opcode
                    frag_buf = bytearray(data)
                elif opcode == 0x0:  # continuation of the message-initial opcode
                    frag_buf.extend(data)
                else:
                    continue
                if not fin:
                    continue
                payload = bytes(frag_buf)
                frag_buf = bytearray()
                if frag_op == 0x1:
                    await inbox.put({"type": "websocket.receive", "text": payload.decode()})
                else:
                    await inbox.put({"type": "websocket.receive", "bytes": payload})
        except (asyncio.IncompleteReadError, ConnectionError):
            await inbox.put({"type": "websocket.disconnect", "code": 1006})

    pump_task = asyncio.create_task(pump())

    async def receive():
        return await inbox.get()

    async def send(msg):
        if msg["type"] == "websocket.accept":
            return  # 101 already sent during the upgrade
        if msg["type"] == "websocket.send":
            if msg.get("text") is not None:
                writer.write(_ws_frame(0x1, msg["text"].encode()))
            else:
                writer.write(_ws_frame(0x2, msg["bytes"]))
            await writer.drain()
        elif msg["type"] == "websocket.close":
            writer.write(_ws_frame(0x8, struct.pack(">H", msg.get("code", 1000))))
            await writer.drain()
            closed.set()

    scope = {"type": "websocket", "path": path, "query_string": qs.encode()}
    try:
        await app(scope, receive, send)
    finally:
        closed.set()
        pump_task.cancel()
        writer.close()


async def serve_async(app, host: str = "0.0.0.0", port: int = 8000):
    server = await asyncio.start_server(
        lambda r, w: _serve_connection(app, r, w), host, port
    )
    return server


def serve(app, host: str = "0.0.0.0", port: int = 8000) -> None:
    """Blocking stdlib server loop (the uvicorn.run analogue)."""

    async def main():
        server = await serve_async(app, host, port)
        async with server:
            await server.serve_forever()

    asyncio.run(main())


def parse_query(qs: bytes | str) -> dict:
    s = qs.decode() if isinstance(qs, bytes) else qs
    return {k: v[0] for k, v in parse_qs(s).items()}
