from . import data, jax_weights, optim, pipeline, projector, regression  # noqa: F401
