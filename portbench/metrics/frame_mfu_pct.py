"""frame_mfu_pct: the whole frame's share of the card's peak (%): the least
time the profiled frames need (`portbench.work.frame_bound_s` of the
reference's counts) over the profiled window's length, which is the
frame's bound times the frames per second in that window."""

from portbench import work


def read(record):
    window = record.profile["window_s"]
    if window <= 0 or not record.counts:
        return None
    return 100.0 * sum(work.frame_bound_s(c) for c in record.counts) / window
