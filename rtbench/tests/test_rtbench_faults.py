"""`correct` comes out false when the timed path is broken underneath,
and the control (the reference in bfloat16 in the program's place) fails
the limits through the harness's own check, at sizes a test run holds.
The harness's look for a card is skipped: these run on the CPU's plain
versions."""
import pytest
import torch

from conftest import cage_overrides
from rtbench import control, harness

SPHERE = {"params": {"n": 40},
          "traffic": {"rays": 4096, "sample_rays": 1024, "sample_every": 1},
          "check": {"check_rays": 2048}}
CELLS = (("sphere1m.incoherent", SPHERE),
         ("bomberman.incoherent8m", cage_overrides()))


def _half_missed(call):
    """Half of the batch left out: the second half answered as misses."""
    def broken(req):
        h = call(req)
        n = h.t.shape[0] // 2
        miss = torch.zeros(h.t.shape[0], dtype=torch.bool)
        miss[n:] = True
        return h._replace(t=torch.where(miss, req["tfar"], h.t),
                          geom_id=torch.where(miss, -1, h.geom_id),
                          prim_id=torch.where(miss, -1, h.prim_id))
    return broken


def _t_altered(call):
    """An answer altered where it is produced: every hit's t 1 % on."""
    def broken(req):
        h = call(req)
        return h._replace(t=torch.where(h.geom_id >= 0, h.t * 1.01, h.t))
    return broken


def _id_altered(call):
    """An answer altered where it is produced: the next primitive's id."""
    def broken(req):
        h = call(req)
        return h._replace(prim_id=torch.where(h.geom_id >= 0,
                                              h.prim_id + 1, h.prim_id))
    return broken


def _few_altered(call):
    """A fault on under 1 % of the rays, which a 99th percentile misses:
    one ray in 111 answered 5 % short."""
    def broken(req):
        h = call(req)
        few = (torch.arange(h.t.shape[0]) % 111 == 0) & (h.geom_id >= 0)
        return h._replace(t=torch.where(few, h.t * 0.95, h.t))
    return broken


@pytest.mark.parametrize("cell,ov", CELLS, ids=[c for c, _ in CELLS])
def test_faults_fail(cell, ov):
    ok = harness.run(cell, 41, 0.3, False, device="cpu", overrides=ov)
    assert ok["correct"], (cell, ok["checks"])
    for fault in (_half_missed, _t_altered, _id_altered, _few_altered):
        res = harness.run(cell, 41, 0.3, False, device="cpu", overrides=ov,
                          loop_hook=fault)
        assert not res["correct"], (cell, fault.__name__, res["checks"])
        far = res["checks"].get("far_share")
        if fault is _few_altered and far is not None:
            assert far["value"] > far["limit"], res["checks"]


@pytest.mark.parametrize("cell,ov", CELLS, ids=[c for c, _ in CELLS])
def test_control_fails(cell, ov):
    r = control.readings(cell, [3, 4, 5], 0.3, device="cpu", overrides=ov)
    for (p_ok, prog), (c_ok, ctl) in zip(r["program"], r["control"]):
        assert p_ok, prog
        assert not c_ok, ctl
        assert any(c["value"] > c["limit"] for c in ctl.values()), ctl
