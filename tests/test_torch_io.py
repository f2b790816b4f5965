"""The port's frame I/O (``animal_vision_tpu_torch/io``) against the JAX
package's on the same arrays: split composition, labels, colour
normalization and the gallery grid bit for bit; the image, video and webcam
renderers; and the error without cv2."""

import sys

import cv2
import numpy as np
import pytest

from animal_vision_tpu.io import gallery as jgallery
from animal_vision_tpu.io import renderer as jrenderer
from animal_vision_tpu_torch.io import ImageRenderer, VideoRenderer, WebcamRenderer
from animal_vision_tpu_torch.io import gallery, renderer


def _img(h, w, seed, c=3):
    shape = (h, w) if c == 0 else (h, w, c)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("hw", [(64, 96), (37, 211), (8, 5)])
@pytest.mark.parametrize("modified_hw", ["same", "other"])
def test_compose_split_equals_jax(hw, modified_hw):
    original = _img(*hw, seed=1)
    modified = _img(*hw, seed=2) if modified_hw == "same" else _img(hw[0] * 2 + 1, hw[1] + 3, seed=2)
    for seam in (True, False):
        want = jrenderer.compose_split(original, modified, "Left", "Cat", seam)
        got = renderer.compose_split(original, modified, "Left", "Cat", seam)
        np.testing.assert_array_equal(got, want)
    assert not np.shares_memory(got, original)


@pytest.mark.parametrize("text,org", [("Original", (10, 24)), ("Mantis Shrimp", (40, 30)), ("x", (0, 0))])
def test_draw_label_equals_jax(text, org):
    got, want = _img(48, 120, seed=3), _img(48, 120, seed=3)
    renderer.draw_label(got, text, org)
    jrenderer.draw_label(want, text, org)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [0, 3, 4])
@pytest.mark.parametrize("from_bgr", [True, False])
def test_to_rgb_uint8_equals_jax(channels, from_bgr):
    frame = _img(9, 13, seed=4, c=channels)
    np.testing.assert_array_equal(renderer.to_rgb_uint8(frame, from_bgr), jrenderer.to_rgb_uint8(frame, from_bgr))


@pytest.mark.parametrize("tile_height,cols", [(32, None), (48, 2), (17, 5)])
def test_labeled_grid_equals_jax(tile_height, cols):
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (40 + 3 * i, 60 - 2 * i, 3), dtype=np.uint8) for i in range(5)]
    imgs.append(rng.random((30, 50, 3), dtype=np.float32))  # float tiles in [0, 1]
    labels = [f"species {i}" for i in range(len(imgs))]
    got = gallery.build_labeled_grid(imgs, labels, tile_height, cols)
    np.testing.assert_array_equal(got, jgallery.build_labeled_grid(imgs, labels, tile_height, cols))
    with pytest.raises(ValueError):
        gallery.build_labeled_grid(imgs, labels[:-1])


def test_image_renderer_roundtrip(tmp_path, img_u8):
    src = tmp_path / "in.png"
    cv2.imwrite(str(src), cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))
    out = tmp_path / "sub" / "out.png"
    r = ImageRenderer(str(src), show_window=False, save_to=str(out))
    with pytest.raises(RuntimeError, match="open"):
        r.render(img_u8)
    r.open()
    img = r.get_image()
    np.testing.assert_array_equal(img, img_u8)  # a PNG round trip is lossless
    flipped = img[::-1].copy()
    r.render_split_compare(img, flipped)
    r.close()
    saved = cv2.cvtColor(cv2.imread(str(out)), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(saved, jrenderer.compose_split(img_u8, flipped))
    with pytest.raises(FileNotFoundError):
        ImageRenderer(str(tmp_path / "missing.png"), show_window=False).get_image()


def test_video_renderer_writes_8_frames(tmp_path, img_u8):
    out = tmp_path / "out.mp4"
    sink = VideoRenderer(save_to=str(out), fps=10, show_window=False)
    frames = [np.roll(img_u8, 3 * i, axis=1) for i in range(8)]
    for f in frames:
        sink.render(sink.make_split_frame(f, f[::-1]))
    sink.close()
    src = VideoRenderer(str(out))
    src.open()
    assert src.fps == pytest.approx(10.0)
    got = list(src.frames())
    src.close()
    assert len(got) == 8 and got[0].shape == img_u8.shape and got[0].dtype == np.uint8
    with pytest.raises(FileNotFoundError):
        VideoRenderer(str(tmp_path / "missing.mp4")).open()


class _FakeCapture:
    """A stand-in for cv2.VideoCapture that records the properties set."""

    instances = []

    def __init__(self, index):
        self.index = index
        self.props = {}
        self.frames = [np.full((6, 8, 3), i, np.uint8) for i in range(3)]
        _FakeCapture.instances.append(self)

    def isOpened(self):
        return True

    def set(self, prop, val):
        self.props[prop] = val
        return True

    def read(self):
        if not self.frames:
            return False, None
        f = self.frames.pop(0)
        f[:, :4, 0] = 200  # a left half that differs from the right
        return True, f

    def release(self):
        pass


def test_webcam_renderer_with_fake_capture(monkeypatch, tmp_path):
    shown = []
    monkeypatch.setattr(cv2, "VideoCapture", _FakeCapture)
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append(img.copy()))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    monkeypatch.setattr(cv2, "destroyWindow", lambda name: None)
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.delenv("ANIMAL_VISION_HEADLESS", raising=False)
    cam = WebcamRenderer(index=2, width=640, height=480, fps=24.0, show_window=True)
    cam.open()
    cap = _FakeCapture.instances[-1]
    assert cap.index == 2
    assert cap.props[cv2.CAP_PROP_FRAME_WIDTH] == 640 and cap.props[cv2.CAP_PROP_FRAME_HEIGHT] == 480
    assert cap.props[cv2.CAP_PROP_FPS] == 24.0
    assert cap.props[cv2.CAP_PROP_AUTOFOCUS] == 1 and cap.props[cv2.CAP_PROP_AUTO_EXPOSURE] == 1
    frames = list(cam.frames())
    assert len(frames) == 3
    cam.render(frames[1])
    cam.close()
    # the preview is mirrored: shown (BGR) is the RGB frame flipped left-right
    np.testing.assert_array_equal(shown[0], cv2.cvtColor(frames[1][:, ::-1], cv2.COLOR_RGB2BGR))
    assert not np.array_equal(shown[0], cv2.cvtColor(frames[1], cv2.COLOR_RGB2BGR))


def test_without_cv2_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # makes `import cv2` raise ImportError
    a = _img(8, 8, seed=6)
    with pytest.raises(ImportError, match="cv2"):
        renderer.compose_split(a, a)
    with pytest.raises(ImportError, match="cv2"):
        gallery.build_labeled_grid([a], ["a"])
