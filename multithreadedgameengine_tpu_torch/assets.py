"""Asset metadata registry — the SpriteSheetRegistry analog
(src/core/SpriteSheetRegistry.js).

The port's own copy of ``multithreadedgameengine_tpu/assets.py`` (which
imports no JAX, but the port imports nothing of the JAX package): spritesheet
ids 1-255 (:389-431), per-sheet animation name -> index spaces (:37-133,
:869-902), static texture ids, and serialize/deserialize (:222-274). The
registry is host-side Python; what reaches the device are the integers it
hands out (``sprite.spritesheet_id``, ``sprite.animation_state``, particle
``texture_id``) and the per-(sheet, animation) frame-count table the engine
builds from it (``Engine._frame_counts``). The atlas packing of the
reference's ``render/atlas.py`` (ROADMAP slice D) is not ported.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def _hint(name: str, names) -> str:
    match = difflib.get_close_matches(name, list(names), n=1)
    return f" — did you mean {match[0]!r}?" if match else ""


@dataclass
class SheetMeta:
    """One spritesheet: ordered animations with frame counts. The animation
    index space is per-sheet and independent (SpriteSheetRegistry.js proxy
    sheets, :869-902)."""

    name: str
    sheet_id: int  # 1-255, 0 = "no sheet / static texture"
    animations: List[str] = field(default_factory=list)  # index = position
    frame_counts: List[int] = field(default_factory=list)
    image: Optional[str] = None  # path/url, for the host renderer

    def animation_index(self, anim: str) -> int:
        try:
            return self.animations.index(anim)
        except ValueError:
            raise KeyError(
                f"sheet {self.name!r} has no animation {anim!r}{_hint(anim, self.animations)}"
            ) from None


class SpriteRegistry:
    """Host-side name -> index registry. ``MAX_SHEETS`` mirrors the u8
    spritesheetId storage (ids 1-255, SpriteSheetRegistry.js:389-431)."""

    MAX_SHEETS = 255

    def __init__(self):
        self._sheets: Dict[str, SheetMeta] = {}
        self._sheets_by_id: Dict[int, SheetMeta] = {}
        self._textures: Dict[str, int] = {}  # static textures (setSprite names)
        self._texture_images: Dict[str, Optional[str]] = {}
        self._next_sheet_id = 1

    # -- spritesheets --
    def register_spritesheet(
        self,
        name: str,
        animations: Sequence[Tuple[str, int]],
        image: Optional[str] = None,
    ) -> SheetMeta:
        """Register a sheet with its ordered (animation, frame_count) list.
        Registration order defines animation indices; registering a name
        again returns the first registration."""
        if name in self._sheets:
            return self._sheets[name]
        if self._next_sheet_id > self.MAX_SHEETS:
            raise RuntimeError(f"more than {self.MAX_SHEETS} spritesheets")
        meta = SheetMeta(
            name=name,
            sheet_id=self._next_sheet_id,
            animations=[a for a, _ in animations],
            frame_counts=[int(f) for _, f in animations],
            image=image,
        )
        self._next_sheet_id += 1
        self._sheets[name] = meta
        self._sheets_by_id[meta.sheet_id] = meta
        return meta

    def sheet(self, name: str) -> SheetMeta:
        if name not in self._sheets:
            raise KeyError(f"unknown spritesheet {name!r}{_hint(name, self._sheets)}")
        return self._sheets[name]

    @property
    def sheets(self) -> List[SheetMeta]:
        """Every registered sheet, in id order (ids 1 .. n)."""
        return [self._sheets_by_id[i] for i in range(1, self._next_sheet_id)]

    def sheet_id(self, name: str) -> int:
        return self.sheet(name).sheet_id

    def animation_index(self, sheet_name: str, anim: str) -> int:
        """getAnimationIndex (:88-133) with typo suggestions (:294-327)."""
        return self.sheet(sheet_name).animation_index(anim)

    # -- static textures (setSprite / particle textures) --
    def register_texture(self, name: str, image: Optional[str] = None) -> int:
        if name not in self._textures:
            self._textures[name] = len(self._textures) + 1  # 0 = none
            self._texture_images[name] = image
        return self._textures[name]

    def texture_id(self, name: str) -> int:
        if name not in self._textures:
            raise KeyError(f"unknown texture {name!r}{_hint(name, self._textures)}")
        return self._textures[name]

    @property
    def textures(self) -> Dict[str, int]:
        return dict(self._textures)

    # -- worker serialize/deserialize (:222-274) --
    def serialize(self) -> dict:
        return {
            "sheets": [
                {
                    "name": m.name,
                    "sheet_id": m.sheet_id,
                    "animations": list(m.animations),
                    "frame_counts": list(m.frame_counts),
                    "image": m.image,
                }
                for m in self._sheets.values()
            ],
            "textures": dict(self._textures),
            "texture_images": dict(self._texture_images),
        }

    @classmethod
    def deserialize(cls, data: dict) -> "SpriteRegistry":
        reg = cls()
        for m in data["sheets"]:
            meta = SheetMeta(
                name=m["name"], sheet_id=m["sheet_id"],
                animations=list(m["animations"]),
                frame_counts=list(m["frame_counts"]), image=m.get("image"),
            )
            reg._sheets[meta.name] = meta
            reg._sheets_by_id[meta.sheet_id] = meta
            reg._next_sheet_id = max(reg._next_sheet_id, meta.sheet_id + 1)
        reg._textures = dict(data["textures"])
        reg._texture_images = dict(data.get("texture_images", {}))
        return reg


# The LPC character-sheet animation set of the predators demo's civil1-7
# sheets (demos/predators/img/civil*.json "animations" metadata). All seven
# sheets share this order, so animation indices are interchangeable across
# them, which lets one [state, direction] int table drive every prey.
LPC_ANIMATIONS: List[Tuple[str, int]] = [
    ("spellcast_up", 7), ("spellcast_left", 7), ("spellcast_down", 7), ("spellcast_right", 7),
    ("thrust_up", 8), ("thrust_left", 8), ("thrust_down", 8), ("thrust_right", 8),
    ("walk_up", 9), ("walk_left", 9), ("walk_down", 9), ("walk_right", 9),
    ("slash_up", 6), ("slash_left", 6), ("slash_down", 6), ("slash_right", 6),
    ("shoot_up", 13), ("shoot_left", 13), ("shoot_down", 13), ("shoot_right", 13),
    ("hurt", 6), ("climb", 6),
    ("idle_up", 2), ("idle_left", 2), ("idle_down", 2), ("idle_right", 2),
    ("jump_up", 5), ("jump_left", 5), ("jump_down", 5), ("jump_right", 5),
    ("sit_up", 3), ("sit_left", 3), ("sit_down", 3), ("sit_right", 3),
    ("emote_up", 3), ("emote_left", 3), ("emote_down", 3), ("emote_right", 3),
    ("run_up", 8), ("run_left", 8), ("run_down", 8), ("run_right", 8),
    ("combat_up", 2), ("combat_left", 2), ("combat_down", 2), ("combat_right", 2),
    ("1h_slash_up", 13), ("1h_slash_left", 13), ("1h_slash_down", 13), ("1h_slash_right", 13),
    ("1h_halfslash_up", 6), ("1h_halfslash_left", 6), ("1h_halfslash_down", 6),
    ("1h_halfslash_right", 6),
]
