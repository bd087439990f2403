from .extract import RenderPacket, advance_animation, extract_render_packet  # noqa: F401
from .headless import render_frame, write_png  # noqa: F401
