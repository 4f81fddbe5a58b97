"""postnorm_roofline: the least time of the traced requests' Swin V2
res-post-norms (their bytes at the bandwidth,
``counts_window.row_epilogue_work``) over the device time of
``postnorm_kernel``, in percent."""
from benchmark import counts_window
from benchmark.metrics import _window


def read(run):
    return _window.row_roofline(run, "postnorm_kernel", counts_window
                                .row_epilogue_work, "postnorm")
