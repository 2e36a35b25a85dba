"""other_device_ms: device milliseconds a request of every op and kernel
that is not a traversal kernel (hit finalization, the compressed fold,
the generator's and the sample's ops), from the profiler's trace. The
traversal kernels are those that the per-layer metrics name (`KERNEL`)."""
import re


def read(ctx):
    if ctx.trace is None or ctx.requests == 0:
        return None
    pats = [re.compile(r"\b" + re.escape(k) + r"\b")
            for k in ctx.traversal_kernels]
    s = sum(v for n, v in ctx.trace.device_s.items()
            if not any(p.search(n) for p in pats))
    return 1e3 * s / ctx.requests
