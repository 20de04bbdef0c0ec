from .series import MotionSeries, SMPLParameters  # noqa: F401
