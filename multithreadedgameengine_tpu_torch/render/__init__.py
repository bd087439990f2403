"""Render-side state updates of the port (advance_animation so far)."""
