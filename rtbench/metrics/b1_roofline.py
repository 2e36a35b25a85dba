"""b1_roofline: the share of its roofline that B1, the treelet walk (traverse/rowtrace2.py -> csrc/rowtrace2.cu)
reaches: the least time the card could take for what the cell's inputs
need, over the kernel's device time a request.

The least time is bytes over the card's published memory rate
(rtbench/peaks.json): each ray's 32 bytes in (origin, direction, tnear,
tfar), the kernel's 8 bytes out (t, prim), and the geometry that the
configuration defines, once (the scene's `geometry_bytes`). These counts
do not depend on the tree, the record layout or the kernel that answers
the query, so no later change to those can move the yardstick. Operations
are not counted.
"""

KERNEL = "rowtrace2_kernel"
RAY_BYTES = 32
OUT_BYTES = 8


def least_bytes(rays: int, geometry_bytes: int) -> int:
    return rays * (RAY_BYTES + OUT_BYTES) + geometry_bytes


def read(ctx):
    s = ctx.kernel_seconds(KERNEL)
    if not s or ctx.requests == 0 or not ctx.peak_bytes_per_s:
        return None
    least_s = least_bytes(ctx.rays, ctx.geometry_bytes) / ctx.peak_bytes_per_s
    return 100.0 * least_s / (s / ctx.requests)
