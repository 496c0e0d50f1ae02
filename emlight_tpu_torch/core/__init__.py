from . import device, geometry  # noqa: F401
