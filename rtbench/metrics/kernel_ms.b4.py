"""kernel_ms.b4: device milliseconds a request of B4, the compressed closest hit (traverse/cbvh_kernel.py -> csrc/cbvh.cu),
from the profiler's trace of the window (its kernels found by name)."""

KERNEL = "cbvh_kernel"


def read(ctx):
    s = ctx.kernel_seconds(KERNEL)
    return None if s is None or ctx.requests == 0 else 1e3 * s / ctx.requests
