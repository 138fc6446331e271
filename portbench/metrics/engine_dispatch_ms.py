"""engine_dispatch_ms: the mean wall of the harness's own span around each
`Scheduler.step()` in the span window, device-inclusive (ms). A sessioned
request leaves `engine.render_batch` for `engine.render_incremental`, so no
span of the program covers every cell."""


def read(record):
    if not record.dispatch_s:
        return None
    return 1e3 * sum(record.dispatch_s) / len(record.dispatch_s)
