"""The closest-hit tests of tests/test_torch_cbvh_interpret.py in `grid`
mode: the port's plain version of the compressed kernel against the JAX
package's Pallas kernel in interpret mode, on the same rays and at the
same tolerances. The tests are that file's own, collected here with this
module's `traced` fixture, so that the mode's interpret-mode trace runs
once, in this module."""
import pytest

from test_torch_build import reference_native  # noqa: F401
from test_torch_cbvh_interpret import (  # noqa: F401
    test_counting_walk_leaves_the_answer_unchanged,
    test_port_built_tiles_trace_the_same,
    test_prim_and_uv_match_the_pallas_kernel,
    test_valid_geom_and_t_match_the_pallas_kernel, trace)


@pytest.fixture(scope="module", params=["grid"])
def traced(request):
    return trace(request.param)
