"""The port's ASGI app (``device="cpu"``) against the JAX package's, on the
CPU: the same requests through both apps in process.

Bars: ``/getpic`` and ``/getgallery`` decoded within 1 LSB of JAX's for the
non-UV species (dog, deer, rat, the cat) and >= 40 dB for kestrel, on PNG
inputs made from ``np.random.default_rng(seed)`` with at most 64 rows (the
JAX cat is far from its oracle on taller uint8 frames); ``/getframe``'s JPEG
bytes equal to ``cv2.imencode(".jpg", ...)`` of each package's own
``visualize`` output (JPEG quantisation sets no bar across the two apps'
bytes), with the two ``visualize`` outputs under the bars above; the static
routes, ``ui_page()`` and the REST, ``/ws`` and Socket.IO transcripts of
errors, acks and event names equal."""

import asyncio
import json

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest

from animal_vision_tpu.server import app as japp
from animal_vision_tpu.species import get_animal as jax_animal
from animal_vision_tpu_torch.server import app as tapp
from animal_vision_tpu_torch.species import get_animal
from torch_server_checks import AsgiWsClient, data_url, decode_uri, frame, http, jpeg_of, post_json, uri_bytes

NON_UV = ["dog", "deer", "rat", "cat"]
SHAPES = [(48, 64), (37, 53)]
MIN_DB = 40.0


@pytest.fixture
def apps():
    return tapp.build_asgi_app(device="cpu"), japp.build_asgi_app()


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _close(got, want, name, psnr_fn):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    if name == "kestrel":
        assert psnr_fn(got / 255.0, want / 255.0) >= MIN_DB
    else:
        assert _lsb(got, want) <= 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NON_UV + ["kestrel"])
def test_getpic_vs_jax(apps, name, shape, psnr_fn):
    img = frame(shape, seed=NON_UV.index(name) + 1 if name in NON_UV else 0)
    (ts, tout), (js, jout) = (post_json(a, "/getpic", {"image": data_url(img), "animal": name}) for a in apps)
    assert ts == js == 200
    got, want = decode_uri(tout["image"], "image/png"), decode_uri(jout["image"], "image/png")
    assert got.shape == img.shape
    _close(got, want, name, psnr_fn)


@pytest.mark.parametrize("names", [NON_UV, ["kestrel", "dog"]])
def test_getgallery_vs_jax(apps, names, psnr_fn):
    img = frame(SHAPES[0], seed=len(names))
    (ts, tout), (js, jout) = (post_json(a, "/getgallery", {"image": data_url(img), "animals": names}) for a in apps)
    assert ts == js == 200
    got, want = decode_uri(tout["image"], "image/png"), decode_uri(jout["image"], "image/png")
    assert got.shape[0] > img.shape[0]  # label strips
    _close(got, want, "kestrel" if "kestrel" in names else "dog", psnr_fn)


@pytest.mark.parametrize("name", NON_UV + ["kestrel"])
def test_getframe_vs_jax(apps, name, psnr_fn):
    img = frame(SHAPES[0], seed=100 + len(name))
    (ts, tout), (js, jout) = (post_json(a, "/getframe", {"image": data_url(img), "animal": name}) for a in apps)
    assert ts == js == 200
    ours, theirs = get_animal(name, "cpu").visualize(img)[1], np.asarray(jax_animal(name).visualize(img)[1])
    assert uri_bytes(tout["image"], "image/jpeg") == jpeg_of(ours)
    assert uri_bytes(jout["image"], "image/jpeg") == jpeg_of(theirs)
    _close(ours, theirs, name, psnr_fn)


def test_ui_page_equals_jax():
    assert tapp.ui_page() == japp.ui_page()


@pytest.mark.parametrize("path", ["/", "/ui", "/manifest.webmanifest", "/sw.js", "/ui/app.js", "/ui/app.css",
                                  "/nope"])
def test_get_routes_equal_jax(apps, path):
    got, want = (asyncio.run(http(a, "GET", path)) for a in apps)
    assert got == want


REST_CASES = [
    ("/gettip", {"animal": "dog"}),
    ("/getframe", {"image": "bm90IGFuIGltYWdl", "animal": "dog"}),
    ("/getpic", {"image": "x", "animal": "dog"}),
    ("/getgallery", {"image": "x", "animals": ["dog"]}),
    ("/getframe", {"animal": "dog"}),
    ("/nope", {}),
]


@pytest.mark.parametrize("path,payload", REST_CASES)
def test_rest_errors_and_tip_equal_jax(apps, path, payload, monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    got, want = (post_json(a, path, payload) for a in apps)
    assert got == want


@pytest.mark.parametrize("path", ["/gettip", "/nope"])
def test_stdlib_handler_equals_jax(path, monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    body = json.dumps({"animal": "dog"}).encode()
    assert tapp._StdlibHandler.handle(path, body, device="cpu") == japp._StdlibHandler.handle(path, body)


def _shape(reply: str):
    """A Socket.IO packet with any image reduced to its data URI's head."""
    if not reply.startswith("42"):
        return reply
    event, *args = json.loads(reply[2:])
    return event, [{k: (v.split(",", 1)[0] if k == "image" else v) for k, v in a.items()} for a in args]


def test_socketio_transcript_equals_jax(apps):
    """Good frame, bad frame, unknown species, an ack id, then a namespace
    disconnect: the same packets from both apps, image payloads aside."""
    good = data_url(frame(seed=7), ".jpg")

    async def transcript(app):
        c = AsgiWsClient(app)
        await c.sio_connect()
        out = []
        for packet, replies in (("42" + json.dumps(["sendimage", good, "dog"]), 1),
                                ("42" + json.dumps(["sendimage", "bm90anBlZw==", "dog"]), 1),
                                ("42" + json.dumps(["sendimage", good, "unicorn"]), 1),
                                ("429" + json.dumps(["sendimage", good.split(",", 1)[1], "cat"]), 2)):
            await c.send(packet)
            out.append(sorted([_shape(await c.recv()) for _ in range(replies)], key=str))
        await c.send("41")
        await c.close()
        return out

    got, want = (asyncio.run(transcript(a)) for a in apps)
    assert got == want
    assert [r[0][0] if isinstance(r[0], tuple) else r[0] for r in got][:3] == ["getimage", "error", "error"]


def test_ws_transcript_equals_jax(apps):
    async def transcript(app):
        c = AsgiWsClient(app, path="/ws", query=b"")
        await c.start()
        out = []
        for msg in ({"image": data_url(frame(seed=8), ".jpg"), "animal": "rat"},
                    {"image": "bm90anBlZw==", "animal": "rat"}, {"animal": "rat"}):
            await c.send(json.dumps(msg))
            reply = json.loads(await c.recv())
            out.append({k: (v.split(",", 1)[0] if k == "image" else v) for k, v in reply.items()})
        await c.close()
        return out

    got, want = (asyncio.run(transcript(a)) for a in apps)
    assert got == want and got[0] == {"image": "data:image/jpeg;base64"} and "error" in got[1]
