from . import (checkpoint, config_io, data, jax_weights, optim, pipeline, projector,  # noqa: F401
               regression, torch_import)
