"""device_idle_share: the share of the traced window in which no op ran
on the device: 1 - (union of device op intervals / the window's wall
time), in %."""


def read(facts):
    t = facts["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
