"""stage1_ms_per_frame: the program's Stage-1 spans of a render
(`stage1_compact`, or `stage1_incremental` on a session's reuse path) in the
span window, divided by its frames (ms). Only the spans directly under a
`render` span count: the coherence path opens a second
`stage1_incremental` around its whole frame."""

STAGES = ("stage1_compact", "stage1_incremental")


def read(record):
    walls = [w for name, parent, w in record.spans
             if name in STAGES and parent == "render"]
    if not walls or not record.span_frames:
        return None
    return 1e3 * sum(walls) / record.span_frames
