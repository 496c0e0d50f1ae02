from . import harmonics, healpix, needlets  # noqa: F401
from .pipeline import NeedletPipeline, gt_grid_angles  # noqa: F401
