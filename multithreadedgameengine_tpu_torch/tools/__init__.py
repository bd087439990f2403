"""Standalone asset tooling — the analogs of the reference's
spritesheet_stuff/ utilities (texturepacker.html, the MaxRects packer UI, and
animatedSpriteVisualizer.html, the animation preview page), re-shaped as CLI
tools over the same atlas pipeline the engine uses at runtime
(render/atlas.py).

- ``python -m multithreadedgameengine_tpu_torch.tools.texture_packer`` — pack loose
  PNGs and grid-sliced spritesheets into one atlas PNG + TexturePacker-style
  JSON (+ an outlined inspection image).
- ``python -m multithreadedgameengine_tpu_torch.tools.sprite_visualizer`` — slice a
  sheet, write per-animation strips, and emit a self-contained HTML page that
  plays every animation with CSS ``steps()`` keyframes (open in any browser —
  no server needed).

The port's own copy of ``multithreadedgameengine_tpu/tools/__init__.py``,
which imports no JAX (the port imports nothing of the JAX package).
"""
