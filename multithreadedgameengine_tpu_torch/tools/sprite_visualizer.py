"""Animated-sprite visualizer CLI — the animatedSpriteVisualizer.html analog.

The reference tool is a browser page: load a sheet, set the frame size, and
watch each row play as an animation (animatedSpriteVisualizer.html:1-575).
This CLI slices the sheet the same way and emits:

 - one strip PNG per animation (frames side by side), and
 - a self-contained HTML page that PLAYS every animation with CSS
   ``steps()`` keyframes over the original sheet — open it in any browser,
   no server or JS framework required.

    python -m multithreadedgameengine_tpu_torch.tools.sprite_visualizer \
        lpc.png 64x64 --rows idle_up,idle_right --out preview/

The port's own copy of ``multithreadedgameengine_tpu/tools/sprite_visualizer.py``,
which imports no JAX (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import base64
import os
import sys

import numpy as np

from ..render.atlas import load_png
from ..render.headless import encode_png, write_png
from .texture_packer import slice_sheet

_PAGE = """<!doctype html>
<title>sprite visualizer — {name}</title>
<style>
 body {{ background: #222; color: #ddd; font: 14px monospace; }}
 .anim {{ display: inline-block; margin: 12px; text-align: center; }}
 .sprite {{
   width: {fw}px; height: {fh}px; display: inline-block;
   background-image: url(data:image/png;base64,{b64});
   background-repeat: no-repeat; image-rendering: pixelated;
   transform: scale({scale}); transform-origin: top left;
 }}
 .cell {{ width: {sfw}px; height: {sfh}px; overflow: hidden; }}
{rules}
</style>
<h3>{name} — {fw}x{fh} frames (speed: {fps} fps)</h3>
{divs}
"""

_RULE = """ .a{i} {{ background-position: 0px {ny}px;
   animation: kf{i} {dur}s steps({n}) infinite; }}
 @keyframes kf{i} {{ to {{ background-position: {nx}px {ny}px; }} }}
"""

_DIV = """<div class="anim"><div class="cell"><div class="sprite a{i}"></div></div>
<div>{label} ({n}f)</div></div>
"""


def build_page(
    img: np.ndarray, fw: int, fh: int, row_names, fps: float = 8.0,
    scale: int = 2, name: str = "sheet",
) -> str:
    meta = slice_sheet(img, fw, fh, row_names)
    b64 = base64.b64encode(encode_png(img)).decode()
    rules, divs = [], []
    for i, (anim, frames) in enumerate(meta["animations"].items()):
        n = len(frames)
        y = meta["frames"][frames[0]]["frame"]["y"]
        rules.append(_RULE.format(i=i, n=n, nx=-n * fw, ny=-y, dur=n / fps))
        divs.append(_DIV.format(i=i, label=anim, n=n))
    return _PAGE.format(
        name=name, fw=fw, fh=fh, b64=b64, rules="".join(rules),
        divs="".join(divs), fps=fps, scale=scale,
        sfw=fw * scale, sfh=fh * scale,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sprite_visualizer",
        description="slice a spritesheet and preview its animations",
    )
    ap.add_argument("sheet", help="sheet PNG")
    ap.add_argument("frame", help="frame size, e.g. 64x64")
    ap.add_argument("--rows", default="", help="comma-separated row names")
    ap.add_argument("--fps", type=float, default=8.0)
    ap.add_argument("--out", default="preview", help="output directory")
    args = ap.parse_args(argv)

    fw, fh = (int(v) for v in args.frame.lower().split("x"))
    row_names = [r for r in args.rows.split(",") if r]
    img = load_png(args.sheet)
    os.makedirs(args.out, exist_ok=True)

    meta = slice_sheet(img, fw, fh, row_names)
    for anim, frames in meta["animations"].items():
        cuts = [
            img[f["frame"]["y"]:f["frame"]["y"] + fh,
                f["frame"]["x"]:f["frame"]["x"] + fw]
            for f in (meta["frames"][fn] for fn in frames)
        ]
        strip = np.concatenate(cuts, axis=1)
        write_png(os.path.join(args.out, f"{anim}.png"), strip)

    name = args.sheet.rsplit("/", 1)[-1]
    page = build_page(img, fw, fh, row_names, fps=args.fps, name=name)
    html_path = os.path.join(args.out, "index.html")
    with open(html_path, "w") as f:
        f.write(page)
    print(
        f"{len(meta['animations'])} animations -> {args.out}/ "
        f"(open {html_path} in a browser)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
