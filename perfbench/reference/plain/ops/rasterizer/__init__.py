from .api import RasterizeConfig, RasterizeResult, rasterize  # noqa: F401
