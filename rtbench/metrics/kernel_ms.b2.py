"""kernel_ms.b2: device milliseconds a request of B2, the packet walk (traverse/packet_kernel.py -> csrc/packet.cu),
from the profiler's trace of the window (its kernels found by name)."""

KERNEL = "packet_kernel"


def read(ctx):
    s = ctx.kernel_seconds(KERNEL)
    return None if s is None or ctx.requests == 0 else 1e3 * s / ctx.requests
