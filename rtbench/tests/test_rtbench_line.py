"""The result line's shape, and the command's refusals."""
import json
import os
import shutil
import subprocess
import sys

import torch

from conftest import ROOT
from rtbench import harness

SMALL = {"params": {"n": 40}, "traffic": {"rays": 4096},
         "check": {"check_rays": 256}}


def test_last_line_shape():
    res = harness.run("sphere1m.incoherent", 2**31 + 17, 0.5, False,
                      device="cpu", overrides=SMALL)
    json.dumps(res)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"mrays_s", "request_p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    traced = harness.run("sphere1m.incoherent", 5, 0.5, True, device="cpu",
                         overrides=SMALL)
    assert set(traced["metrics"]) <= {m["name"] for m in harness.load_json(
        "BENCHMARK.json")["per_layer"]}
    assert "entry_host_ms" in traced["metrics"]
    assert "commit_s" in traced["metrics"]
    assert "kernel_ms.b1" not in traced["metrics"]   # no device here


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present")
    cmd = [sys.executable, "rtbench/run.py", "--workload",
           "sphere1m.incoherent", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    # the benchmark alone, without the program beside it
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode != 0 and r.stdout == ""


import pytest  # noqa: E402


@pytest.mark.card
def test_card_run(card):
    cmd = [sys.executable, "rtbench/run.py", "--workload",
           "sphere1m.incoherent", "--seed", str(2**31 + 99), "--seconds",
           "2", "--trace", "0"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
