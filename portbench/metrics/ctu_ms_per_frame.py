"""ctu_ms_per_frame: the program's `ctu` spans (one a spill pass of a
dispatch: the gathers around K1 and K1) in the span window, divided by its
frames (ms)."""


def read(record):
    walls = [w for name, _, w in record.spans if name == "ctu"]
    if not walls or not record.span_frames:
        return None
    return 1e3 * sum(walls) / record.span_frames
