"""Entry `scene_intersect`: one request is one `Scene.intersect` call over
the request's rays (closest hit; `coherent` from the traffic file), the
public entry a renderer or sampler calls (scene/scene.py::Scene.intersect
-> scene_intersect -> _closest_flat).

An entry file names the kind of answer it gives (`QUERY`); the harness
judges it with the scene's reference for that query,
`rtbench/reference/<scene>.<QUERY>.py`."""
from __future__ import annotations

QUERY = "closest"


def make(scene, traffic: dict):
    """A function (request) -> the request's hit records."""
    from embree_tpu_torch import Rays
    coherent = bool(traffic["coherent"])

    def call(req):
        return scene.intersect(Rays(req["org"], req["dir"], req["tnear"],
                                    req["tfar"]), coherent=coherent)
    return call


def keep(req, hits, idx) -> dict:
    """The rays `idx` of a request and their hit records, in the keys the
    references read."""
    return {"org": req["org"][idx], "dir": req["dir"][idx],
            "valid": hits.geom_id[idx] >= 0, "t": hits.t[idx],
            "u": hits.u[idx], "v": hits.v[idx], "ng": hits.ng[idx],
            "prim_id": hits.prim_id[idx].long(),
            "geom_id": hits.geom_id[idx].long()}


def well_formed(hits, req) -> bool:
    """Whether a request's answer has one record a ray."""
    n = req["org"].shape[0]
    return (tuple(hits.t.shape) == (n,) and tuple(hits.ng.shape) == (n, 3)
            and tuple(hits.prim_id.shape) == (n,))
