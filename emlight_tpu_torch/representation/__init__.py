from .splat import render_anchor_params, render_sg  # noqa: F401
