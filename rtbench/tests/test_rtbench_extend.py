"""A new configuration, traffic mix, ray generator, kind of query (an
entry with its reference and limits) and per-layer metric are added as
new files and new entries of BENCHMARK.json alone: in a copy of the
benchmark, with no file that is there edited, the new cells run, are
judged by their own reference and report the new metric. A cell on the
frame generator that the benchmark keeps for later is added the same way."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from rtbench import harness
assert harness.ROOT == {root!r}
small = {{"traffic": {{"rays": 2048}}, "check": {{"check_rays": 128}}}}
frame = {{"traffic": {{"width": 48, "height": 27}},
          "check": {{"check_rays": 128}}}}
res = harness.run("tiny.fan", 3, 0.3, False, device="cpu", overrides=small)
tr = harness.run("tiny.fan", 4, 0.3, True, device="cpu", overrides=small)
fr = harness.run("tiny.frame4k", 5, 0.3, False, device="cpu", overrides=frame)
print(json.dumps([res, tr, fr]))
"""

GENERATOR = '''
import torch
from rtbench.raygen import RequestRng


class Fan(RequestRng):
    """Rays from one point on the x axis, fanned towards the origin."""

    def request(self, index):
        self.start(index)
        d = torch.randn((self.n, 3), generator=self.gen) * 0.2
        d[:, 0] -= 1.0
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        org = torch.tensor([3.0, 0.0, 0.0]).expand(self.n, 3).contiguous()
        return self.rays(index, org, d)


def make(traffic, cfg, box, seed, device):
    return Fan(seed, traffic["rays"], device)
'''

ENTRY = '''
QUERY = "occluded"


def make(scene, traffic):
    from embree_tpu_torch import Rays

    def call(req):
        return scene.occluded(Rays(req["org"], req["dir"], req["tnear"],
                                   req["tfar"]))
    return call


def keep(req, occ, idx):
    return {"org": req["org"][idx], "dir": req["dir"][idx],
            "occluded": occ[idx]}


def well_formed(occ, req):
    return tuple(occ.shape) == (req["org"].shape[0],)
'''

REFERENCE = '''
import torch
from . import triangles


def prepare(inp, device):
    tri = torch.as_tensor(inp["triangles"], dtype=torch.int64)
    v = torch.as_tensor(inp["vertices"], dtype=torch.float32)
    return {"v": [v[tri[:, k]] for k in range(3)]}


def answer(state, kept, dtype=torch.float32):
    h = triangles.closest(*state["v"], kept["org"], kept["dir"], dtype)
    return {"occluded": h["valid"]}


def compare(prog, ref):
    return {"occluded_mismatch":
            float((prog["occluded"] != ref["occluded"]).float().mean()),
            "occluded_share": 1.0 - float(ref["occluded"].float().mean())}
'''


def test_new_cells_from_new_files_only(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in tmp_path.rglob("*") if x.is_file())}
    rb = tmp_path / "rtbench"
    cfg = json.load(open(rb / "configs" / "sphere1m.json"))
    cfg.update(name="tiny", params={"center": [0, 0, 0], "radius": 1.0,
                                    "n": 24})
    json.dump(cfg, open(rb / "configs" / "tiny.json", "w"))
    json.dump({"generator": "fan", "rays": 4096,
               "entry": "scene_occluded", "inflight": 3, "sample_every": 2,
               "sample_rays": 8}, open(rb / "traffic" / "fan.json", "w"))
    (rb / "generators" / "fan.py").write_text(GENERATOR)
    (rb / "entries" / "scene_occluded.py").write_text(ENTRY)
    (rb / "reference" / "triangle_sphere.occluded.py").write_text(REFERENCE)
    json.dump({"check_rays": 128, "limits": {"occluded_mismatch": 0.0,
                                             "occluded_share": 0.9}},
              open(rb / "limits" / "tiny.occluded.json", "w"))
    json.dump(json.load(open(rb / "limits" / "sphere1m.closest.json")),
              open(rb / "limits" / "tiny.closest.json", "w"))
    (rb / "metrics" / "requests_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.requests)\n")
    b = json.load(open(tmp_path / "BENCHMARK.json"))
    b["configs"].append({"name": "tiny", "source": "https://example.org/t",
                         "file": "rtbench/configs/tiny.json",
                         "reduced": [], "why": "a test"})
    for traffic in ("fan", "frame4k"):
        b["workloads"].append({"name": f"tiny.{traffic}", "config": "tiny",
                               "traffic": traffic, "chips": 1,
                               "why": "a test"})
    b["per_layer"].append({"name": "requests_traced", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry points", "moves": "mrays_s",
                           "workloads": ["tiny.fan"]})
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT.format(root=root)],
                       cwd=root, capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res, tr, fr = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"occluded_mismatch", "occluded_share"}
    assert res["metrics"]["mrays_s"]["value"] > 0
    assert tr["metrics"]["requests_traced"]["value"] > 0
    assert fr["correct"] and set(fr["checks"]) == {
        "valid_mismatch", "id_mismatch", "t_gap", "uv_gap", "ng_gap"}
    for p, data in before.items():
        if os.path.basename(p) != "BENCHMARK.json":
            assert open(p, "rb").read() == data, p
