"""scene_mb: megabytes of device memory that `Scene.commit` leaves
allocated (torch.cuda.memory_allocated after the commit less before it),
measured by the harness."""


def read(ctx):
    return None if ctx.scene_bytes is None else ctx.scene_bytes / 1e6
