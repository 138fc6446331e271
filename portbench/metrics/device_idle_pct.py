"""device_idle_pct: the share of the profiled window in which no operation
ran on the device (%), from the profiler's trace."""


def read(record):
    window = record.profile["window_s"]
    if window <= 0:
        return None
    return 100.0 * (1.0 - record.profile["busy_s"] / window)
