"""Texture packer CLI — the spritesheet_stuff/texturepacker.html analog.

The reference tool is a browser page: drop images, optionally declare a
frame grid per sheet, MaxRects-pack everything, download the atlas PNG +
TexturePacker JSON (texturepacker.html:1-732). This CLI drives the same
runtime pipeline (render/atlas.py: MaxRectsPacker + create_big_atlas) from
the shell:

    python -m multithreadedgameengine_tpu_torch.tools.texture_packer \
        bunny.png blood.png \
        --sheet "civil1=lpc.png:64x64:idle_up,idle_right,idle_down,idle_left" \
        --out atlas.png --json atlas.json --inspect atlas_debug.png

Loose PNGs pack whole; ``--sheet name=path:FWxFH[:row_names]`` slices a sheet
into a FW×FH frame grid where each ROW becomes one animation (the LPC sheet
convention the demos use); trailing fully-transparent frames in a row are
trimmed. Omitted row names auto-number (``row0``, ``row1``, …).

The port's own copy of ``multithreadedgameengine_tpu/tools/texture_packer.py``,
which imports no JAX (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..render.atlas import BigAtlas, create_big_atlas, inspect_atlas, load_png
from ..render.headless import encode_png


def slice_sheet(
    img: np.ndarray, fw: int, fh: int, row_names: List[str]
) -> dict:
    """Grid-slice a sheet into TexturePacker-style metadata: one animation
    per row, trailing empty (all-alpha-0) frames trimmed."""
    rows = img.shape[0] // fh
    cols = img.shape[1] // fw
    frames: Dict[str, dict] = {}
    animations: Dict[str, List[str]] = {}
    for r in range(rows):
        name = row_names[r] if r < len(row_names) else f"row{r}"
        # scan the WHOLE row, then trim only the trailing empty run —
        # an interior gap frame must not truncate the rest of the animation
        empty = [
            img[r * fh:(r + 1) * fh, c * fw:(c + 1) * fw].shape[2] == 4
            and not img[r * fh:(r + 1) * fh, c * fw:(c + 1) * fw][..., 3].any()
            for c in range(cols)
        ]
        last = cols
        while last > 1 and empty[last - 1]:
            last -= 1
        frame_names = []
        for c in range(last):
            fname = f"{name}_{c}"
            frames[fname] = {
                "frame": {"x": c * fw, "y": r * fh, "w": fw, "h": fh}
            }
            frame_names.append(fname)
        if frame_names:
            animations[name] = frame_names
    return {"frames": frames, "animations": animations}


def parse_sheet_arg(spec: str) -> Tuple[str, str, int, int, List[str]]:
    """``name=path:FWxFH[:row1,row2,...]`` → (name, path, fw, fh, names)."""
    name, rest = spec.split("=", 1)
    parts = rest.split(":")
    if len(parts) < 2:
        raise ValueError(f"--sheet {spec!r}: expected name=path:FWxFH[:rows]")
    path = parts[0]
    fw, fh = (int(v) for v in parts[1].lower().split("x"))
    names = parts[2].split(",") if len(parts) > 2 and parts[2] else []
    return name, path, fw, fh, names


def pack(
    image_paths: List[str],
    sheet_specs: List[str],
    size: int = 1024,
) -> Tuple[BigAtlas, dict]:
    images = {
        p.rsplit("/", 1)[-1].rsplit(".", 1)[0]: load_png(p) for p in image_paths
    }
    sheets = {}
    for spec in sheet_specs:
        name, path, fw, fh, row_names = parse_sheet_arg(spec)
        img = load_png(path)
        sheets[name] = (img, slice_sheet(img, fw, fh, row_names))
    atlas = create_big_atlas(images, sheets, size=size)
    return atlas, atlas.json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="texture_packer",
        description="MaxRects-pack PNGs + grid-sliced sheets into one atlas",
    )
    ap.add_argument("images", nargs="*", help="loose PNGs (pack whole)")
    ap.add_argument(
        "--sheet", action="append", default=[],
        metavar="name=path:FWxFH[:rows]",
        help="grid-slice a spritesheet; each row becomes one animation",
    )
    ap.add_argument("--out", default="atlas.png", help="atlas PNG output")
    ap.add_argument("--json", default="atlas.json", help="metadata output")
    ap.add_argument("--inspect", default=None, help="outlined debug PNG")
    ap.add_argument("--size", type=int, default=1024, help="initial canvas")
    args = ap.parse_args(argv)
    if not args.images and not args.sheet:
        ap.error("nothing to pack: pass PNGs and/or --sheet specs")

    atlas, meta = pack(args.images, args.sheet, size=args.size)
    with open(args.out, "wb") as f:
        f.write(encode_png(atlas.image))
    with open(args.json, "w") as f:
        json.dump(meta, f, indent=1)
    if args.inspect:
        inspect_atlas(atlas, args.inspect)
    n = len(atlas.frames)
    side = meta["meta"]["size"]["w"]
    print(f"packed {n} frames into {side}x{side} -> {args.out} + {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
