"""kernel_ms.b1: device milliseconds a request of B1, the treelet walk (traverse/rowtrace2.py -> csrc/rowtrace2.cu),
from the profiler's trace of the window (its kernels found by name)."""

KERNEL = "rowtrace2_kernel"


def read(ctx):
    s = ctx.kernel_seconds(KERNEL)
    return None if s is None or ctx.requests == 0 else 1e3 * s / ctx.requests
