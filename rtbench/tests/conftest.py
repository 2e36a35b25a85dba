"""CPU tests of the benchmark harness (python -m pytest rtbench/tests -q).
The tests marked `card` run only where a CUDA device is present."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided here, at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def cage_overrides(level: int = 4) -> dict:
    """The demo's cage at subdivision `level` (CPU-sized), 4,096 rays a
    request, 1,024 of each kept and 2,048 checked. The compressed leaf's uv error scales with the cell's width,
    2^-level, so the `uv_gap` limit (set at level 6) is scaled by
    2^(6 - level); the other limits stand."""
    import json
    with open(os.path.join(ROOT, "rtbench", "configs", "bomberman.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "rtbench", "limits",
                           "bomberman.closest.json")) as f:
        limits = dict(json.load(f)["limits"])
    limits["uv_gap"] *= 2.0 ** (cfg["params"]["subdivision_level"] - level)
    return {"params": {"subdivision_level": level},
            "traffic": {"rays": 4096, "sample_rays": 1024, "sample_every": 1},
            "check": {"check_rays": 2048, "limits": limits}}
