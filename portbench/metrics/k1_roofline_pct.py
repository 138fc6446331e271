"""k1_roofline_pct: K1's share of its roofline (%): the least time the card
needs for the mini-tile tests the profiled frames need
(`portbench.work.k1_bound_s` of the reference's counts) over K1's device
time in the profiled window (`prtu_entry_kernel`)."""

from portbench import work

KERNEL = "prtu_entry_kernel"


def read(record):
    t = sum(s for name, s in record.profile["kernels"].items()
            if KERNEL in name)
    if t <= 0 or not record.counts:
        return None
    return 100.0 * sum(work.k1_bound_s(c) for c in record.counts) / t
