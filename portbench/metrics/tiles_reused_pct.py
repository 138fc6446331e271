"""tiles_reused_pct: the share of tiles whose Stage-1 lists a session frame
reused, from the program's per-frame `tiles_reused` and
`tiles_recompacted` counters over the span window (%). Nothing to read
where no frame took the frame-coherent path."""


def read(record):
    rows = [c for c in record.counters if "tiles_reused" in c]
    reused = sum(c["tiles_reused"] for c in rows)
    total = reused + sum(c["tiles_recompacted"] for c in rows)
    if total <= 0:
        return None
    return 100.0 * reused / total
