"""entry_host_ms: host milliseconds of the entry call until it returns,
unsynchronised, as a mean over the traced window's requests (a span of
the harness around the call: the dispatch, the folds and every launch
the entry enqueues, not the device's work)."""


def read(ctx):
    if not ctx.entry_s:
        return None
    return 1e3 * sum(ctx.entry_s) / len(ctx.entry_s)
