"""Procedural demo assets: LPC-layout character sheets and demo textures.

The reference demos ship CC-licensed LPC character art
(the predators demo's img/civil*.png + TexturePacker json). This
build generates equivalent assets procedurally — same frame layout, same
animation names and frame counts (assets.LPC_ANIMATIONS subset the demos
use), drawn as simple articulated figures — so the full pipeline
(sheet → big atlas → numeric animation indices → renderer drawImage
sub-rects with frame advance) is exercised end-to-end without shipping any
third-party art.

Only the animations the demos drive are generated (idle/walk/run × 4
directions + hurt); the registry still carries the full LPC index space, and
renderers fall back for states with no frames.

The port's own copy of ``multithreadedgameengine_tpu/render/procgen.py``,
which imports no JAX (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: the animation subset the predators demo's state machine actually plays
#: (prey.js:196-224 walk/run/idle × direction; hurt on death)
DEMO_ANIMS: Tuple[Tuple[str, int], ...] = (
    ("idle_up", 2), ("idle_left", 2), ("idle_down", 2), ("idle_right", 2),
    ("walk_up", 9), ("walk_left", 9), ("walk_down", 9), ("walk_right", 9),
    ("run_up", 8), ("run_left", 8), ("run_down", 8), ("run_right", 8),
    ("hurt", 6),
)

FRAME = 64  # LPC frame size


def _put_rect(img, x0, y0, w, h, color):
    x0, y0 = int(round(x0)), int(round(y0))
    x1, y1 = x0 + int(round(w)), y0 + int(round(h))
    x0, y0 = max(0, x0), max(0, y0)
    x1, y1 = min(img.shape[1], x1), min(img.shape[0], y1)
    if x1 > x0 and y1 > y0:
        img[y0:y1, x0:x1] = color


def _put_disc(img, cx, cy, r, color):
    yy, xx = np.mgrid[0 : img.shape[0], 0 : img.shape[1]]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    img[mask] = color


def _character_frame(anim: str, k: int, n: int, skin, shirt, pants) -> np.ndarray:
    """One 64×64 RGBA frame: head + torso + swinging limbs. Directionality:
    up/down = front/back symmetric, left/right = mirrored profile; walk/run
    swing legs with phase k/n (run swings harder and leans)."""
    img = np.zeros((FRAME, FRAME, 4), np.uint8)
    cx, ground = 32, 58
    phase = np.sin(2 * np.pi * (k / max(n, 1)))
    if anim.startswith("idle"):
        swing, lean, bob = 0.0, 0.0, (k % 2)  # two-frame breathing bob
    elif anim.startswith("walk"):
        swing, lean, bob = 6.0 * phase, 0.0, 0
    elif anim.startswith("run"):
        swing, lean, bob = 10.0 * phase, 3.0, abs(phase)
    else:  # hurt: collapse toward the ground over the frames
        fall = k / max(n - 1, 1)
        img2 = np.zeros_like(img)
        _put_rect(img2, 14, ground - 8 - 10 * (1 - fall), 36, 8, (*shirt, 255))
        _put_disc(img2, 20 + 18 * fall, ground - 12 - 14 * (1 - fall), 7, (*skin, 255))
        return img2

    direction = anim.rsplit("_", 1)[-1]
    mirror = direction == "left"
    side = direction in ("left", "right")

    top = int(round(16 + 2 * bob))
    # legs (pants)
    leg_w = 6
    _put_rect(img, cx - 8 + (swing if side else swing * 0.6),
              ground - 16, leg_w, 16, (*pants, 255))
    _put_rect(img, cx + 2 - (swing if side else swing * 0.6),
              ground - 16, leg_w, 16, (*pants, 255))
    # torso (shirt)
    _put_rect(img, cx - 9 + lean * (1 if side else 0), top + 12, 18, 16, (*shirt, 255))
    # arms (skin), counter-swinging
    _put_rect(img, cx - 13 - swing * 0.5, top + 13, 4, 13, (*skin, 255))
    _put_rect(img, cx + 9 + swing * 0.5, top + 13, 4, 13, (*skin, 255))
    # head (skin), with a face pixel patch to make direction readable
    _put_disc(img, cx + lean * (1 if side else 0), top + 5, 7, (*skin, 255))
    eye = (20, 20, 30, 255)
    if direction == "down":
        img[top + 4 : top + 6, cx - 4 : cx - 2] = eye
        img[top + 4 : top + 6, cx + 2 : cx + 4] = eye
    elif direction in ("left", "right"):
        ex = cx - 4 if mirror else cx + 2
        img[top + 4 : top + 6, ex : ex + 2] = eye
    if mirror:
        img = img[:, ::-1]
    return img


def make_character_sheet(
    seed: int,
) -> Tuple[np.ndarray, Dict]:
    """One LPC-subset character sheet: frames laid out one animation per row
    (the LPC grid convention). Returns (RGBA sheet, TexturePacker-style meta
    with 'frames' and 'animations')."""
    rng = np.random.default_rng(seed)
    skin = tuple(int(v) for v in rng.integers(140, 230, 3))
    shirt = tuple(int(v) for v in rng.integers(40, 220, 3))
    pants = tuple(int(v) for v in rng.integers(30, 140, 3))
    max_frames = max(n for _, n in DEMO_ANIMS)
    sheet = np.zeros((FRAME * len(DEMO_ANIMS), FRAME * max_frames, 4), np.uint8)
    frames: Dict[str, dict] = {}
    animations: Dict[str, list] = {}
    for row, (anim, n) in enumerate(DEMO_ANIMS):
        names = []
        for k in range(n):
            fr = _character_frame(anim, k, n, skin, shirt, pants)
            y, x = row * FRAME, k * FRAME
            sheet[y : y + FRAME, x : x + FRAME] = fr
            name = f"{anim}_{k}"
            frames[name] = {"frame": {"x": x, "y": y, "w": FRAME, "h": FRAME}}
            names.append(name)
        animations[anim] = names
    return sheet, {"frames": frames, "animations": animations}


def make_demo_textures() -> Dict[str, np.ndarray]:
    """Static textures the demos reference: bunny / blood / tallLight."""
    bunny = np.zeros((26, 26, 4), np.uint8)
    _put_disc(bunny, 13, 16, 8, (235, 235, 235, 255))
    _put_rect(bunny, 8, 1, 4, 12, (225, 225, 225, 255))
    _put_rect(bunny, 15, 1, 4, 12, (225, 225, 225, 255))
    bunny[14:16, 10:12] = (40, 40, 60, 255)
    bunny[14:16, 16:18] = (40, 40, 60, 255)

    blood = np.zeros((12, 12, 4), np.uint8)
    rng = np.random.default_rng(0xB100D)
    _put_disc(blood, 6, 6, 4, (170, 10, 10, 255))
    for _ in range(10):
        x, y = rng.integers(1, 11, 2)
        blood[y, x] = (140, 0, 0, 255)

    pole = np.zeros((120, 40, 4), np.uint8)
    _put_rect(pole, 18, 20, 4, 100, (70, 60, 50, 255))
    _put_disc(pole, 20, 14, 9, (255, 240, 180, 255))
    return {"bunny": bunny, "blood": blood, "tallLight": pole}
