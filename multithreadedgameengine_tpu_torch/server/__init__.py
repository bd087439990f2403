from .render_server import RenderServer, run_scene  # noqa: F401
