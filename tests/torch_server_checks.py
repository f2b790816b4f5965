"""Clients shared by the port's server test files: an in-process ASGI client
for HTTP and WebSocket scopes, a hand-rolled HTTP/1.1 and RFC 6455 client
for the stdlib server over TCP (its frames from ``chip_smoke.py``), and
frame data URIs made from a seed."""

import asyncio
import base64
import contextlib
import json
import secrets

import cv2
import numpy as np

from chip_smoke import masked_frame as mask_frame  # noqa: F401
from chip_smoke import read_ws_frame as read_server_frame  # noqa: F401


def frame(shape=(40, 56), seed=0) -> np.ndarray:
    """A random uint8 frame, fed to the service as its BGR frame."""
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


def data_url(img: np.ndarray, fmt: str = ".png") -> str:
    ok, buf = cv2.imencode(fmt, img)
    assert ok
    mime = "image/png" if fmt == ".png" else "image/jpeg"
    return f"data:{mime};base64," + base64.b64encode(buf.tobytes()).decode()


def uri_bytes(uri: str, mime: str) -> bytes:
    head, payload = uri.split(",", 1)
    assert head == f"data:{mime};base64"
    return base64.b64decode(payload)


def decode_uri(uri: str, mime: str) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(uri_bytes(uri, mime), np.uint8), cv2.IMREAD_COLOR)
    assert img is not None
    return img


def jpeg_of(img: np.ndarray) -> bytes:
    """The bytes the service's JPEG encode gives for a BGR frame."""
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


async def http(app, method: str, path: str, body: bytes = b"") -> tuple[int, dict, bytes]:
    """One HTTP request through the ASGI app in process: (status, headers, body)."""
    sent = []

    async def receive():
        return {"type": "http.request", "body": body, "more_body": False}

    async def send(msg):
        sent.append(msg)

    scope = {"type": "http", "method": method, "path": path, "query_string": b"", "headers": []}
    await app(scope, receive, send)
    start = sent[0]
    assert start["type"] == "http.response.start"
    headers = {k.decode(): v.decode() for k, v in start["headers"]}
    return start["status"], headers, b"".join(m.get("body", b"") for m in sent[1:])


def post_json(app, path: str, payload: dict) -> tuple[int, dict]:
    status, _, body = asyncio.run(http(app, "POST", path, json.dumps(payload).encode()))
    return status, json.loads(body)


class AsgiWsClient:
    """In-process ASGI websocket client."""

    def __init__(self, app, path="/socket.io/", query=b"EIO=4&transport=websocket"):
        self.to_app = asyncio.Queue()
        self.from_app = asyncio.Queue()
        scope = {"type": "websocket", "path": path, "query_string": query}
        self.task = asyncio.ensure_future(app(scope, self.to_app.get, self.from_app.put))

    async def start(self):
        await self.to_app.put({"type": "websocket.connect"})
        accept = await asyncio.wait_for(self.from_app.get(), 5)
        assert accept["type"] == "websocket.accept"

    async def send(self, text: str):
        await self.to_app.put({"type": "websocket.receive", "text": text})

    async def recv(self, timeout=30) -> str:
        msg = await asyncio.wait_for(self.from_app.get(), timeout)
        assert msg["type"] == "websocket.send", msg
        return msg["text"]

    async def sio_connect(self) -> str:
        """Engine.IO open and Socket.IO CONNECT; returns the sid."""
        await self.start()
        opened = await self.recv()
        assert opened.startswith("0")
        meta = json.loads(opened[1:])
        assert meta["sid"] and meta["pingInterval"] > 0
        await self.send("40")
        ack = await self.recv()
        assert ack.startswith("40")
        return json.loads(ack[2:])["sid"]

    async def close(self):
        await self.to_app.put({"type": "websocket.disconnect", "code": 1000})
        try:
            await asyncio.wait_for(self.task, 5)
        except (asyncio.CancelledError, asyncio.TimeoutError):
            self.task.cancel()


# -- TCP: the stdlib server through real sockets ------------------------------


@contextlib.asynccontextmanager
async def ws_session(port: int, path: str):
    """A new TCP connection upgraded to a WebSocket on ``path``, closed on
    exit whatever happened, so that the server's handler ends and
    ``wait_closed`` returns."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        key = base64.b64encode(secrets.token_bytes(16)).decode()
        writer.write(
            (
                f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        assert b"101" in await reader.readline()
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        yield reader, writer
    finally:
        writer.close()


async def tcp_request(port: int, method: str, path: str, body: bytes = b"") -> tuple[int, dict, bytes]:
    """One HTTP/1.1 request on a new connection: (status, headers, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        status = int((await reader.readline()).split()[1])
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        return status, headers, await reader.readexactly(int(headers["content-length"]))
    finally:
        writer.close()
