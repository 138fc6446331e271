"""k2_roofline_pct: K2's share of its roofline (%): the least time the card
needs for the lanes the profiled frames blend (`portbench.work.k2_bound_s`
of the reference's counts) over K2's device time in the profiled window
(`blend_fused_kernel`)."""

from portbench import work

KERNEL = "blend_fused_kernel"


def read(record):
    t = sum(s for name, s in record.profile["kernels"].items()
            if KERNEL in name)
    if t <= 0 or not record.counts:
        return None
    return 100.0 * sum(work.k2_bound_s(c) for c in record.counts) / t
