"""The port's serving layer (``animal_vision_tpu_torch/server``) on the CPU
with ``device="cpu"``: every route of the ASGI app, in process and over TCP
through the stdlib server (``miniasgi.serve_async`` on port 0), the ``/ws``
WebSocket, the Socket.IO ``sendimage`` -> ``getimage`` contract (ack ids, a
bad frame, disconnect, several clients), fragmented WebSocket frames,
``_StdlibHandler`` on each path, the UI assets, and an error without a card
unless a device is given.

Frame routes return the port's own ``visualize`` output: JPEG bytes equal to
``cv2.imencode(".jpg", ...)`` of it, PNG outputs equal to its composition,
from PNG inputs (lossless)."""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from animal_vision_tpu_torch.io.gallery import build_labeled_grid
from animal_vision_tpu_torch.io.renderer import compose_split
from animal_vision_tpu_torch.server import app as appmod
from animal_vision_tpu_torch.server import miniasgi
from animal_vision_tpu_torch.server.app import MANIFEST_JSON, StreamHub, _StdlibHandler, build_asgi_app, ui_page
from animal_vision_tpu_torch.species import animal_names, display_name, get_animal
from torch_server_checks import (
    AsgiWsClient,
    data_url,
    decode_uri,
    frame,
    http,
    jpeg_of,
    mask_frame,
    post_json,
    read_server_frame,
    tcp_request,
    uri_bytes,
    ws_session,
)

REPO = Path(__file__).resolve().parents[1]
UI_DIR = REPO / "animal_vision_tpu_torch" / "server" / "ui"
#: one species per non-UV kernel, the cat, and a UV species
SPECIES = ["dog", "deer", "rat", "cat", "kestrel"]
GET_ROUTES = {
    "/": ("application/json", None),
    "/ui": ("text/html; charset=utf-8", None),
    "/manifest.webmanifest": ("application/manifest+json", None),
    "/sw.js": ("text/javascript", "sw.js"),
    "/ui/app.js": ("text/javascript", "app.js"),
    "/ui/app.css": ("text/css", "app.css"),
}


@pytest.fixture
def app():
    """A new app per test: its Socket.IO drain task lives on the event loop
    of the test's ``asyncio.run``."""
    return build_asgi_app(device="cpu")


def _out(name, img):
    return get_animal(name, "cpu").visualize(img)


@pytest.mark.parametrize("path", list(GET_ROUTES))
def test_get_routes_in_process(app, path):
    status, headers, body = asyncio.run(http(app, "GET", path))
    media, asset = GET_ROUTES[path]
    assert status == 200 and headers["content-type"] == media
    want = {
        "/": json.dumps("animal-vision-tpu server").encode(),
        "/ui": ui_page().encode(),
        "/manifest.webmanifest": MANIFEST_JSON.encode(),
    }.get(path) or (UI_DIR / asset).read_bytes()
    assert body == want


@pytest.mark.parametrize("name", ["index.html", "app.js", "app.css", "sw.js"])
def test_ui_assets_equal_jax_files(name):
    jax_file = REPO / "animal_vision_tpu" / "server" / "ui" / name
    assert (UI_DIR / name).read_bytes() == jax_file.read_bytes()


def test_manifest_equals_jax():
    from animal_vision_tpu.server.app import MANIFEST_JSON as JAX_MANIFEST

    assert MANIFEST_JSON == JAX_MANIFEST
    man = json.loads(MANIFEST_JSON)
    assert man["display"] == "standalone" and man["start_url"] == "/ui" and man["icons"]


def test_ui_page_carries_the_ports_species():
    from animal_vision_tpu_torch.service import species_categories

    html = ui_page()
    assert "__DATA__" not in html and "<html" in html and 'rel="manifest"' in html
    data = json.loads(html.split("<script>const DATA = ", 1)[1].split(";</script>", 1)[0])
    assert data == {"animals": animal_names(), "categories": species_categories()}
    assert len(data["animals"]) == 36


@pytest.mark.parametrize("name", SPECIES)
def test_getframe_is_visualize_jpeg(app, name):
    img = frame(seed=SPECIES.index(name))
    status, out = post_json(app, "/getframe", {"image": data_url(img), "animal": name})
    assert status == 200
    assert uri_bytes(out["image"], "image/jpeg") == jpeg_of(_out(name, img)[1])


@pytest.mark.parametrize("name", SPECIES)
def test_getpic_is_the_split_of_visualize(app, name):
    img = frame(seed=10 + SPECIES.index(name))
    status, out = post_json(app, "/getpic", {"image": data_url(img), "animal": name})
    assert status == 200
    np.testing.assert_array_equal(decode_uri(out["image"], "image/png"), compose_split(*_out(name, img)))


def test_getgallery_is_the_grid_of_visualize(app):
    img = frame(seed=20)
    names = ["dog", "rat", "kestrel"]
    status, out = post_json(app, "/getgallery", {"image": data_url(img), "animals": names})
    assert status == 200
    want = build_labeled_grid([_out(n, img)[1] for n in names], [display_name(n) for n in names])
    np.testing.assert_array_equal(decode_uri(out["image"], "image/png"), want)


def test_gettip_is_empty_without_key(app, monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    assert post_json(app, "/gettip", {"animal": "dog"}) == (200, {"tip": ""})


@pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/nope"), ("POST", "/"), ("GET", "/getpic")])
def test_unknown_route_is_404(app, method, path):
    status, _, body = asyncio.run(http(app, method, path))
    assert status == 404 and json.loads(body) == {"error": "not found"}


@pytest.mark.parametrize("payload", [{"image": "x", "animal": "unicorn"}, {"image": "bm90IGFuIGltYWdl", "animal": "dog"},
                                     {"animal": "dog"}])
def test_bad_request_is_500_with_error(app, payload):
    status, out = post_json(app, "/getframe", payload)
    assert status == 500 and out["error"]


def test_ws_route_streams_frames_in_process(app):
    """The plain-WebSocket /ws route (the built-in UI's preferred path):
    frames in order, a bad frame answered with an error, the socket kept."""

    async def scenario():
        c = AsgiWsClient(app, path="/ws", query=b"")
        await c.start()
        for i, name in enumerate(["bear", "dog", "kestrel"]):
            img = frame(seed=30 + i)
            await c.send(json.dumps({"image": data_url(img), "animal": name}))
            out = json.loads(await c.recv())
            assert uri_bytes(out["image"], "image/jpeg") == jpeg_of(_out(name, img)[1])
        await c.send(json.dumps({"image": "bm90anBlZw==", "animal": "dog"}))
        assert "decode" in json.loads(await c.recv())["error"]
        img = frame(seed=33)
        await c.send(json.dumps({"image": data_url(img), "animal": "cat"}))
        assert uri_bytes(json.loads(await c.recv())["image"], "image/jpeg") == jpeg_of(_out("cat", img)[1])
        await c.close()

    asyncio.run(scenario())


def test_unknown_websocket_path_is_closed(app):
    async def scenario():
        c = AsgiWsClient(app, path="/nope", query=b"")
        await c.to_app.put({"type": "websocket.connect"})
        msg = await asyncio.wait_for(c.from_app.get(), 5)
        assert msg == {"type": "websocket.close", "code": 1008}

    asyncio.run(scenario())


def _event(reply: str):
    assert reply.startswith("42")
    return json.loads(reply[2:])


def test_socketio_connect_sendimage_getimage_loop(app):
    """engine.io open -> socket.io connect -> sendimage (bytes as a data URI
    or bare base64) -> drain loop -> getimage with visualize's JPEG."""

    async def scenario():
        c = AsgiWsClient(app)
        await c.sio_connect()
        for i, as_uri in enumerate((True, False)):
            img = frame(seed=40 + i)
            url = data_url(img)
            await c.send("42" + json.dumps(["sendimage", url if as_uri else url.split(",", 1)[1], "dog"]))
            event, data = _event(await c.recv())
            assert event == "getimage"
            assert uri_bytes(data["image"], "image/jpeg") == jpeg_of(_out("dog", img)[1])
        await c.close()

    asyncio.run(scenario())


def test_socketio_bad_frame_emits_error_and_loop_survives(app):
    async def scenario():
        c = AsgiWsClient(app)
        await c.sio_connect()
        await c.send("42" + json.dumps(["sendimage", "bm90anBlZw==", "dog"]))
        event, data = _event(await c.recv())
        assert event == "error" and "decode" in data["error"]
        await c.send("42" + json.dumps(["sendimage", data_url(frame(seed=1)), "unicorn"]))
        assert _event(await c.recv())[0] == "error"
        img = frame(seed=2)
        await c.send("42" + json.dumps(["sendimage", data_url(img), "cat"]))
        event, data = _event(await c.recv())
        assert event == "getimage" and uri_bytes(data["image"], "image/jpeg") == jpeg_of(_out("cat", img)[1])
        await c.close()

    asyncio.run(scenario())


def test_socketio_disconnect_cleans_session(monkeypatch):
    dropped = []
    monkeypatch.setattr(StreamHub, "disconnect", lambda self, sid: dropped.append((sid, self.conns.pop(sid, None))))
    app = build_asgi_app(device="cpu")

    async def scenario():
        c = AsgiWsClient(app)
        sid = await c.sio_connect()
        assert sid in app.sio._sessions
        await c.send("41")  # namespace disconnect
        await c.close()
        return sid

    sid = asyncio.run(scenario())
    assert app.sio._sessions == {}
    assert len(dropped) == 1 and dropped[0][0] == sid and dropped[0][1] is not None


def test_socketio_event_with_ack_id_dispatches_and_acks(app):
    """'42<id>[...]' is dispatched and acknowledged with '43<id>[]'."""

    async def scenario():
        c = AsgiWsClient(app)
        await c.sio_connect()
        img = frame(seed=6)
        await c.send("427" + json.dumps(["sendimage", data_url(img), "cat"]))
        seen = {}
        for _ in range(2):
            reply = await c.recv()
            seen["ack" if reply.startswith("43") else "event"] = reply
        assert seen["ack"] == "437[]"
        event, data = _event(seen["event"])
        assert event == "getimage" and uri_bytes(data["image"], "image/jpeg") == jpeg_of(_out("cat", img)[1])
        await c.close()

    asyncio.run(scenario())


def test_socketio_clients_are_answered_once_in_order(app):
    """Three clients send three frames each before reading: each frame is
    answered once, to its own client, in its order."""
    names = ["dog", "rat", "kestrel"]

    async def scenario():
        clients = [AsgiWsClient(app) for _ in names]
        for c in clients:
            await c.sio_connect()
        frames = {k: [frame(seed=50 + 3 * k + i) for i in range(3)] for k in range(len(clients))}
        for i in range(3):
            for k, c in enumerate(clients):
                await c.send("42" + json.dumps(["sendimage", data_url(frames[k][i]), names[k]]))
        for k, c in enumerate(clients):
            for i in range(3):
                event, data = _event(await c.recv())
                assert event == "getimage"
                assert uri_bytes(data["image"], "image/jpeg") == jpeg_of(_out(names[k], frames[k][i])[1])
            assert c.from_app.empty()
        for c in clients:
            await c.close()

    asyncio.run(scenario())


# -- real TCP: the stdlib server and a hand-rolled client ---------------------


async def _serving(app, fn):
    server = await miniasgi.serve_async(app, "127.0.0.1", 0)
    try:
        return await fn(server.sockets[0].getsockname()[1])
    finally:
        server.close()
        await asyncio.wait_for(server.wait_closed(), 30)


def test_rest_routes_over_tcp(app):
    img = frame(seed=60)

    async def scenario(port):
        for path, (media, _) in GET_ROUTES.items():
            status, headers, body = await tcp_request(port, "GET", path)
            assert status == 200 and headers["content-type"] == media and body
        body = json.dumps({"image": data_url(img), "animal": "deer"}).encode()
        status, _, out = await tcp_request(port, "POST", "/getframe", body)
        assert status == 200
        assert uri_bytes(json.loads(out)["image"], "image/jpeg") == jpeg_of(_out("deer", img)[1])
        status, _, out = await tcp_request(port, "POST", "/getpic", body)
        assert status == 200
        np.testing.assert_array_equal(decode_uri(json.loads(out)["image"], "image/png"),
                                      compose_split(*_out("deer", img)))
        status, _, out = await tcp_request(port, "POST", "/gettip", b'{"animal": "deer"}')
        assert status == 200 and json.loads(out) == {"tip": ""}
        status, _, out = await tcp_request(port, "GET", "/nope")
        assert status == 404 and json.loads(out) == {"error": "not found"}

    asyncio.run(_serving(app, scenario))


def test_socketio_and_ws_over_tcp(app):
    """Socket.IO's event loop and /ws over real upgraded sockets."""

    async def scenario(port):
        async with ws_session(port, "/socket.io/?EIO=4&transport=websocket") as (reader, writer):
            _, opened = await read_server_frame(reader)
            assert opened.startswith(b"0")
            writer.write(mask_frame(0x1, b"40"))
            _, ack = await read_server_frame(reader)
            assert ack.startswith(b"40")
            img = frame(seed=61)
            writer.write(mask_frame(0x1, ("42" + json.dumps(["sendimage", data_url(img), "fox"])).encode()))
            _, reply = await asyncio.wait_for(read_server_frame(reader), 30)
            event, data = json.loads(reply[2:].decode())
            assert event == "getimage" and uri_bytes(data["image"], "image/jpeg") == jpeg_of(_out("fox", img)[1])
            writer.write(mask_frame(0x8, (1000).to_bytes(2, "big")))

        async with ws_session(port, "/ws") as (reader, writer):
            for i, name in enumerate(["dog", "rat"]):
                img = frame(seed=62 + i)
                writer.write(mask_frame(0x1, json.dumps({"image": data_url(img), "animal": name}).encode()))
                op, payload = await asyncio.wait_for(read_server_frame(reader), 30)
                assert op == 0x1
                assert uri_bytes(json.loads(payload)["image"], "image/jpeg") == jpeg_of(_out(name, img)[1])
            writer.write(mask_frame(0x8, (1000).to_bytes(2, "big")))

    asyncio.run(_serving(app, scenario))


def test_server_reassembles_fragmented_frames(app):
    """A /ws JSON message split over a FIN=0 text frame and continuations,
    with a ping between them, arrives as one message (RFC 6455 §5.4)."""
    img = frame(seed=65)

    async def scenario(port):
        async with ws_session(port, "/ws") as (reader, writer):
            msg = json.dumps({"image": data_url(img), "animal": "dog"}).encode()
            third = len(msg) // 3
            writer.write(mask_frame(0x1, msg[:third], fin=False))
            writer.write(mask_frame(0x9, b"hb"))  # ping mid-message
            writer.write(mask_frame(0x0, msg[third:2 * third], fin=False))
            writer.write(mask_frame(0x0, msg[2 * third:], fin=True))
            await writer.drain()
            got_pong = False
            while True:
                op, payload = await asyncio.wait_for(read_server_frame(reader), 30)
                if op == 0xA:
                    got_pong = payload == b"hb"
                    continue
                break
            assert got_pong
            assert uri_bytes(json.loads(payload)["image"], "image/jpeg") == jpeg_of(_out("dog", img)[1])

    asyncio.run(_serving(app, scenario))


# -- the framework-free handler, the hub, and the device ----------------------


@pytest.mark.parametrize("path", ["/getpic", "/getframe", "/getgallery", "/gettip", "/nope"])
def test_stdlib_handler(path, monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    img = frame(seed=70)
    body = json.dumps({"image": data_url(img), "animal": "rat", "animals": ["rat", "cat"]}).encode()
    code, payload = _StdlibHandler.handle(path, body, device="cpu")
    if path == "/nope":
        assert (code, payload) == (404, {"error": "not found"})
        return
    assert code == 200
    if path == "/getpic":
        np.testing.assert_array_equal(decode_uri(payload["image"], "image/png"), compose_split(*_out("rat", img)))
    elif path == "/getframe":
        assert uri_bytes(payload["image"], "image/jpeg") == jpeg_of(_out("rat", img)[1])
    elif path == "/getgallery":
        want = build_labeled_grid([_out(n, img)[1] for n in ("rat", "cat")], ["Rat", "Cat"])
        np.testing.assert_array_equal(decode_uri(payload["image"], "image/png"), want)
    else:
        assert payload == {"tip": ""}


def test_stream_hub_queue_and_drain():
    """Per-sid bounded queues, one frame per client per pass, a bad frame
    answered with an error, disconnect drops the queue."""

    def fake_process(image, animal):
        if animal == "boom":
            raise ValueError("bad frame")
        return f"uri:{image}:{animal}"

    hub = StreamHub(maxlen=3, process=fake_process)
    emitted = []

    async def emit(event, payload, sid):
        emitted.append((event, payload, sid))

    async def scenario():
        hub.connect("a")
        hub.enqueue("a", "f1", "dog")
        hub.enqueue("a", "f2", "boom")
        hub.enqueue("b", "f3", "cat")  # created lazily
        for i in range(5):
            hub.enqueue("c", f"x{i}", "dog")
        assert len(hub.conns["c"]) == 3
        assert await hub.drain_once(emit) is True
        assert [s for _, _, s in emitted] == ["a", "b", "c"]  # one frame per client
        while await hub.drain_once(emit):
            pass
        assert await hub.drain_once(emit) is False
        hub.disconnect("a")
        assert "a" not in hub.conns

    asyncio.run(scenario())
    events = [(e, s) for e, _, s in emitted]
    assert events.count(("getimage", "a")) == 1 and ("error", "a") in events and ("getimage", "b") in events
    assert [p["image"] for e, p, s in emitted if s == "c"] == ["uri:x2:dog", "uri:x3:dog", "uri:x4:dog"]


def test_stream_hub_default_process_runs_on_its_device():
    img = frame(seed=71)
    ok, buf = cv2.imencode(".png", img)
    uri = StreamHub(device="cpu").process(buf.tobytes(), "pig")
    assert uri_bytes(uri, "image/jpeg") == jpeg_of(_out("pig", img)[1])


@pytest.mark.parametrize("device", [None, "cuda"])
def test_no_card_raises(device, monkeypatch):
    """Without a card the app is not built and nothing serves on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(miniasgi, "serve", lambda *a, **k: pytest.fail("served without a card"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_asgi_app(device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        appmod.run(host="127.0.0.1", port=0, device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamHub(device=device).process(b"", "dog")


def test_module_main_without_card_raises():
    out = subprocess.run(
        [sys.executable, "-m", "animal_vision_tpu_torch.server.app"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and "stdlib ASGI server" not in out.stdout
