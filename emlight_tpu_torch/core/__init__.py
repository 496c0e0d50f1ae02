from . import device, exr, geometry, hdr, msgpack, piz, png  # noqa: F401
