"""The device's idle share of a traced window, in percent."""


def idle(run):
    tr = run.trace
    if tr is None or tr.window_s() <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
