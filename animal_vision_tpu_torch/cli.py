"""CLI: ``python -m animal_vision_tpu_torch.cli image|video|webcam|gallery``.

Counterpart of ``animal_vision_tpu/cli.py``, with the same commands and
flags (non-interactive ``--input/--output/--animal/--no-show``; numbered
menus with fuzzy filtering where they are omitted), plus ``--device``: the
CUDA card by default, where a missing card is an error; ``--device cpu``
runs the plain PyTorch path. Frame I/O needs cv2.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from animal_vision_tpu_torch.species import NON_UV_NAMES, UNIQUE_UV_NAMES, UV_NAMES, display_name, get_animal

IMAGE_DIR = os.path.join("input", "images")
VIDEO_DIR = os.path.join("input", "video")
OUTPUT_DIR = "output"
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")


def fuzzy_filter(query: str, options: list[str]) -> list[str]:
    """Dependency-free fuzzy match: an option matches when the query's
    characters appear in it in order (case-insensitive); ranked by (earlier
    first hit, tighter span, shorter option)."""
    q = query.lower()
    scored = []
    for opt in options:
        hay = opt.lower()
        pos = -1
        first = last = None
        ok = True
        for ch in q:
            pos = hay.find(ch, pos + 1)
            if pos < 0:
                ok = False
                break
            first = pos if first is None else first
            last = pos
        if ok:
            span = 0 if first is None else last - first
            scored.append(((first or 0, span, len(opt)), opt))
    return [opt for _, opt in sorted(scored)]


def _menu(title: str, options: list[str]) -> str:
    """Numbered menu with fuzzy filtering: a number picks, an exact name
    picks, any other text narrows the list (a single survivor is picked)."""
    print(title)
    shown = options
    for i, opt in enumerate(shown, 1):
        print(f"  {i}. {opt}")
    while True:
        raw = input("> ").strip()
        if raw.isdigit() and 1 <= int(raw) <= len(shown):
            return shown[int(raw) - 1]
        if raw in options:
            return raw
        matches = fuzzy_filter(raw, options) if raw else []
        if len(matches) == 1:
            return matches[0]
        if matches:
            shown = matches
            for i, opt in enumerate(shown, 1):
                print(f"  {i}. {opt}")
            print("(filtered; pick a number, refine, or type the full name)")
        else:
            print(f"pick 1..{len(shown)} or type to filter")


def choose_file(directory: str, exts: tuple[str, ...], given: str | None) -> str:
    if given:
        return given
    files = sorted(f for f in os.listdir(directory) if f.lower().endswith(exts)) if os.path.isdir(directory) else []
    if not files:
        raise SystemExit(f"no files with {exts} in {directory!r}; pass --input")
    return os.path.join(directory, _menu(f"Choose a file from {directory}:", files))


def choose_filename(directory: str, ext: str, given: str | None) -> str:
    if given:
        return given
    name = input(f"Output name (saved to {directory}, {ext}): ").strip() or "out"
    if not name.endswith(ext):
        name += ext
    return os.path.join(directory, name)


def choose_animal(given: str | None, device: str):
    if given:
        return get_animal(given, device), given
    slug = _menu("Choose an animal:", NON_UV_NAMES + UV_NAMES + UNIQUE_UV_NAMES)
    return get_animal(slug, device), slug


def cmd_image(args) -> None:
    from animal_vision_tpu_torch.io import ImageRenderer

    animal, name = choose_animal(args.animal, args.device)
    path = choose_file(IMAGE_DIR, IMAGE_EXTS, args.input)
    save_to = args.output or choose_filename(OUTPUT_DIR, ".png", None)
    r = ImageRenderer(path, show_window=not args.no_show, save_to=save_to)
    r.open()
    img = r.get_image()
    t0 = time.perf_counter()
    base, out = animal.visualize(img)
    print(f"{name}: {img.shape[1]}x{img.shape[0]} in {time.perf_counter() - t0:.2f}s -> {save_to}")
    r.render_split_compare(base, out, right_label=display_name(name))
    r.close()


def cmd_video(args) -> None:
    from animal_vision_tpu_torch.io import VideoRenderer
    from animal_vision_tpu_torch.pipeline import StreamingExecutor

    animal, name = choose_animal(args.animal, args.device)
    path = choose_file(VIDEO_DIR, VIDEO_EXTS, args.input)
    save_to = args.output or choose_filename(OUTPUT_DIR, ".mp4", None)
    src = VideoRenderer(path)
    src.open()
    sink = VideoRenderer(save_to=save_to, fps=src.fps, show_window=not args.no_show)
    ex = StreamingExecutor(animal, batch=args.batch, split=not args.full_frame, right_label=display_name(name))
    t0 = time.perf_counter()
    try:
        n = ex.run(src.frames(), sink.render)
    finally:
        src.close()
        sink.close()
    dt = time.perf_counter() - t0
    print(f"{name}: {n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.1f} fps) -> {save_to}")


def cmd_webcam(args) -> None:
    from animal_vision_tpu_torch.io import WebcamRenderer
    from animal_vision_tpu_torch.pipeline import StreamingExecutor

    animal, name = choose_animal(args.animal, args.device)
    cam = WebcamRenderer(index=args.camera, width=args.width, height=args.height, save_to=args.output,
                         show_window=not args.no_show)
    cam.open()
    ex = StreamingExecutor(animal, batch=1, split=True, right_label=display_name(name))

    def frames():
        end = time.time() + args.seconds if args.seconds else None
        while end is None or time.time() < end:
            f = cam.get_image()
            if f is None:
                return
            yield f

    try:
        n = ex.run(frames(), cam.render)
    finally:
        cam.close()
    print(f"{name}: processed {n} webcam frames")


def _gallery_group(frame: np.ndarray, names: list[str], device: str):
    """Tiles and labels of the species that render; a failing one is
    reported and left out."""
    tiles, labels = [], []
    for n in names:
        try:
            _, out = get_animal(n, device).visualize(frame)
        except Exception as e:  # noqa: BLE001  (the gallery skips a failing species)
            print(f"  [skip] {n}: {e}")
            continue
        tiles.append(out)
        labels.append(display_name(n))
    return tiles, labels


def cmd_gallery(args) -> None:
    from animal_vision_tpu_torch.io.gallery import build_labeled_grid
    from animal_vision_tpu_torch.io.renderer import require_cv2
    from animal_vision_tpu_torch.species import resolve_device

    cv2 = require_cv2()
    resolve_device(args.device)
    path = choose_file(IMAGE_DIR, IMAGE_EXTS, args.input)
    frame = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    if args.max_side and max(frame.shape[:2]) > args.max_side:
        s = args.max_side / max(frame.shape[:2])
        frame = cv2.resize(frame, (int(frame.shape[1] * s), int(frame.shape[0] * s)))
    os.makedirs(OUTPUT_DIR, exist_ok=True)
    groups = [("gallery_NonUV.png", NON_UV_NAMES), ("gallery_UV.png", UV_NAMES),
              ("gallery_Unique_UV.png", UNIQUE_UV_NAMES)]
    if args.group != "all":
        groups = [g for g in groups if args.group in g[0].lower()]
    for fname, names in groups:
        t0 = time.perf_counter()
        tiles, labels = _gallery_group(frame, names, args.device)
        grid = build_labeled_grid(tiles, labels, tile_height=args.tile_height)
        out_path = os.path.join(OUTPUT_DIR, fname)
        cv2.imwrite(out_path, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))
        print(f"{fname}: {len(tiles)} tiles in {time.perf_counter() - t0:.1f}s -> {out_path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="animal_vision_tpu_torch.cli", description="animal-vision on PyTorch and CUDA")
    p.add_argument(
        "--morpho-gate", type=float, default=None, metavar="RANGE",
        help="orientation gate for the morpho butterfly: frames whose local "
        "UV contrast is below RANGE (try 1e-2) render deterministically "
        "instead of amplifying gradient noise; default keeps exact "
        "reference behavior (sets ANIMAL_VISION_MORPHO_GATE)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda, an error without a card; cpu for the plain path)")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("image", help="transform one image")
    pi.add_argument("--input")
    pi.add_argument("--output")
    pi.add_argument("--animal")
    pi.add_argument("--no-show", action="store_true")
    pi.set_defaults(fn=cmd_image)

    pv = sub.add_parser("video", help="transform a video file")
    pv.add_argument("--input")
    pv.add_argument("--output")
    pv.add_argument("--animal")
    pv.add_argument("--no-show", action="store_true")
    pv.add_argument("--batch", type=int, default=4)
    pv.add_argument("--full-frame", action="store_true",
                    help="write the transformed frame instead of the split compare")
    pv.set_defaults(fn=cmd_video)

    pw = sub.add_parser("webcam", help="live webcam")
    pw.add_argument("--camera", type=int, default=0)
    pw.add_argument("--width", type=int, default=1280)
    pw.add_argument("--height", type=int, default=720)
    pw.add_argument("--animal")
    pw.add_argument("--output")
    pw.add_argument("--seconds", type=float, default=None)
    pw.add_argument("--no-show", action="store_true")
    pw.set_defaults(fn=cmd_webcam)

    pg = sub.add_parser("gallery", help="render species gallery grids")
    pg.add_argument("--input")
    pg.add_argument("--group", choices=["all", "nonuv", "uv", "unique"], default="all")
    pg.add_argument("--tile-height", type=int, default=256)
    pg.add_argument("--max-side", type=int, default=640)
    pg.set_defaults(fn=cmd_gallery)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # before the first get_animal: animals are cached per device, and the
    # morpho reads the gate when it is made
    if args.morpho_gate is not None:
        os.environ["ANIMAL_VISION_MORPHO_GATE"] = repr(args.morpho_gate)
    args.fn(args)


if __name__ == "__main__":
    main()
