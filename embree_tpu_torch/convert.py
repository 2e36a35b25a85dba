"""State carried across from the JAX package.

`committed_scene_from_reference` takes the committed state of
`embree_tpu` as plain numpy arrays (the caller does the `np.asarray` on
the JAX side; nothing here sees a JAX object) and returns this
package's `CommittedScene` on the given device.
"""
from __future__ import annotations

import numpy as np
import torch

from .build.treelets import BLOCK_ROWS, TreeletScene
from .scene.prims import TrianglePrims
from .scene.scene import CommittedScene


def _tensor(a, dtype, device, shape=None):
    # a copy: the result never aliases the other package's buffers
    a = np.array(a, dtype=dtype, order="C")
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(a).to(device)


def committed_scene_from_reference(arrays: dict, device) -> CommittedScene:
    """Build a CommittedScene from the JAX package's committed state.

    `arrays` holds numpy arrays / python scalars under these keys:
    `tris.v0`, `tris.v1`, `tris.v2` (T, 3) f32; `tris.geom_id`,
    `tris.prim_id`, `tris.uv_flip` (T,) i32; `rowtrace.blocks`
    (Ntr, 52, 128) f32, `rowtrace.mid_boxes` (M, 6) or flat (M*6,) f32,
    `rowtrace.tre_boxes` (M, 6, 128) f32, `rowtrace.fan`,
    `rowtrace.num_mids`, `rowtrace.num_treelets`, `rowtrace.num_prims`;
    `prim_mask` (T,) i32; `world_lower`, `world_upper` (3,) f32;
    `backface_cull` bool. The `rowtrace.*` keys may all be absent for an
    empty scene."""
    device = torch.device(device)
    f32, i32 = np.float32, np.int32
    tris = TrianglePrims(
        _tensor(arrays["tris.v0"], f32, device, (-1, 3)),
        _tensor(arrays["tris.v1"], f32, device, (-1, 3)),
        _tensor(arrays["tris.v2"], f32, device, (-1, 3)),
        _tensor(arrays["tris.geom_id"], i32, device),
        _tensor(arrays["tris.prim_id"], i32, device),
        _tensor(arrays["tris.uv_flip"], i32, device))
    rowtrace = None
    if "rowtrace.blocks" in arrays:
        fan = int(arrays["rowtrace.fan"])
        M = int(arrays["rowtrace.num_mids"])
        n_tre = int(arrays["rowtrace.num_treelets"])
        if n_tre != M * fan:
            raise ValueError(f"num_treelets {n_tre} != num_mids {M} x fan {fan}")
        # blocks keep their bit patterns (prim ids live in the f32 planes)
        blocks = np.asarray(arrays["rowtrace.blocks"])
        if blocks.dtype != f32 or blocks.shape != (n_tre, BLOCK_ROWS, 128):
            raise ValueError(f"rowtrace.blocks: {blocks.dtype} {blocks.shape}")
        rowtrace = TreeletScene(
            blocks=_tensor(blocks, f32, device),
            mid_boxes=_tensor(arrays["rowtrace.mid_boxes"], f32, device,
                              (M, 6)),
            tre_boxes=_tensor(arrays["rowtrace.tre_boxes"], f32, device,
                              (M, 6, 128)),
            fan=fan, num_mids=M, num_treelets=n_tre,
            num_prims=int(arrays["rowtrace.num_prims"]))
    elif tris.num_prims:
        raise ValueError("a non-empty scene needs the rowtrace.* arrays")
    return CommittedScene(
        tris=tris, rowtrace=rowtrace,
        prim_mask=_tensor(arrays["prim_mask"], i32, device),
        world_lower=_tensor(arrays["world_lower"], f32, device, (3,)),
        world_upper=_tensor(arrays["world_upper"], f32, device, (3,)),
        backface_cull=bool(arrays["backface_cull"]))
