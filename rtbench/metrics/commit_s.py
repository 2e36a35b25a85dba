"""commit_s: seconds of `Scene.commit`, the sum of the program's own
`scene.*` phase spans (embree_tpu_torch/core/profile.py's global timer):
flatten, SAH build, treelets, packing, the compressed build, upload."""


def read(ctx):
    return ctx.commit_s if ctx.commit_s > 0 else None
