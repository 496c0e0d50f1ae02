from . import data, jax_weights, pipeline, projector, regression  # noqa: F401
