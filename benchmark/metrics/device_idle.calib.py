"""device_idle.calib: the share of the traced window in which no kernel,
copy or memset runs on the device (the union of the profiler's device
intervals), in percent."""
from benchmark.metrics._idle import idle as read  # noqa: F401
