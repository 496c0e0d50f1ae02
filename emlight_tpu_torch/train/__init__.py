from . import jax_weights, pipeline, projector, regression  # noqa: F401
