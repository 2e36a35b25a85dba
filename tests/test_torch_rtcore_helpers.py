"""The box helpers (core/math.py) and the barycentric hit point
(traverse/moeller.py::triangle_uv_and_point) of the port against the JAX
package (the tolerances of tests/test_torch_rtcore.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embree_tpu.core import math as ref_math
from embree_tpu.traverse import moeller as ref_moeller
from embree_tpu_torch.core import math as port_math
from embree_tpu_torch.traverse.moeller import triangle_uv_and_point

from test_torch_build import reference_native  # noqa: F401


@pytest.mark.parametrize("name", ["bbox_empty", "bbox_merge", "bbox_area",
                                  "bbox_half_area", "triangle_uv_and_point"])
def test_box_helpers_and_hit_point_against_jax(rng, name):
    """core/math.py's box helpers and moeller.py's hit point from
    barycentrics equal the JAX package's on the same inputs: the empty
    box and merged boxes bit for bit, areas and points at 1e-6 relative
    (XLA:CPU contracts the products into FMAs), inverted boxes (area 0)
    included."""
    lo = rng.uniform(-2, 2, (2, 64, 3)).astype(np.float32)
    hi = (lo + rng.uniform(-0.5, 3, (2, 64, 3))).astype(np.float32)
    if name == "bbox_empty":
        got = port_math.bbox_empty((5,))
        want = ref_math.bbox_empty((5,))
    elif name == "bbox_merge":
        got = port_math.bbox_merge(*(torch.from_numpy(x) for x in
                                     (lo[0], hi[0], lo[1], hi[1])))
        want = ref_math.bbox_merge(*(jnp.asarray(x) for x in
                                     (lo[0], hi[0], lo[1], hi[1])))
    elif name == "triangle_uv_and_point":
        uv = rng.uniform(0, 0.5, (2, 64)).astype(np.float32)
        got = (triangle_uv_and_point(
            None, None, None, *(torch.from_numpy(x) for x in (
                uv[0], uv[1], lo[0], lo[1], hi[0]))),)
        want = (ref_moeller.triangle_uv_and_point(
            None, None, None, *(jnp.asarray(x) for x in (
                uv[0], uv[1], lo[0], lo[1], hi[0]))),)
    else:
        got = (getattr(port_math, name)(torch.from_numpy(lo[0]),
                                        torch.from_numpy(hi[0])),)
        want = (getattr(ref_math, name)(jnp.asarray(lo[0]),
                                        jnp.asarray(hi[0])),)
        assert (np.asarray(want[0]) == 0).any()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        if name in ("bbox_empty", "bbox_merge"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
