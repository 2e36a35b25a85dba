"""Every cell, configuration, traffic mix and per-layer metric of
BENCHMARK.json resolves to its files by name, and the file keeps to the
benchmark's contract."""
import json
import os
import re

from conftest import ROOT
from rtbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_resolves():
    b = _bench()
    for w in b["workloads"]:
        c = harness.resolve(b, w["name"])
        assert callable(c.generator.make)
        for fn in ("make", "keep", "well_formed"):
            assert callable(getattr(c.entry, fn))
        for fn in ("prepare", "answer", "compare"):
            assert callable(getattr(c.reference, fn))
        for fn in ("inputs", "bounds", "geometry_bytes", "commit"):
            assert callable(getattr(c.scene, fn))
        assert set(c.check["limits"]) and c.check["check_rays"] > 0
        for m in c.layer:
            assert callable(c.readers[m["name"]].read)
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "rtbench", "metrics",
                                           m["name"] + ".py"))


def test_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["rtbench"] and 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rtbench/") and not c["reduced"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == []
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for w in cells:
        layer = [m for m in b["per_layer"] if w in m["workloads"]]
        assert layer
    assert len(json.dumps(b)) < 64 * 1024


def test_cage_file_held_to_its_hash(tmp_path):
    import pytest
    from rtbench.scenes import obj_subdiv
    params = harness.load_json("rtbench/configs/bomberman.json")["params"]
    assert obj_subdiv.inputs(params, ROOT)["face_counts"].shape == (727,)
    changed = tmp_path / params["obj"]
    changed.parent.mkdir(parents=True)
    raw = open(os.path.join(ROOT, params["obj"]), "rb").read()
    changed.write_bytes(raw.replace(b"v ", b"v  ", 1))
    with pytest.raises(ValueError, match="SHA-256"):
        obj_subdiv.inputs(params, str(tmp_path))
