"""Nothing under rtbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program. Module names are compared by
their top-level name, whole: `embree_tpu_torch` is not `embree_tpu`."""
import ast
import os

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "embree_tpu"}
HERE = os.path.join(ROOT, "rtbench")


def _imports(path):
    """(top-level name, relative level) of every import in a file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = [(p, n) for p in _files(HERE) for n, lvl in _imports(p)
             if lvl == 0 and n in BANNED]
    assert not found, found
    assert "embree_tpu" not in {"embree_tpu_torch".split(".")[0]}


def test_reference_stands_alone():
    ref = os.path.join(HERE, "reference")
    found = []
    for p in _files(ref):
        for n, lvl in _imports(p):
            if lvl == 0 and (n in BANNED or n == "embree_tpu_torch"
                             or n == "rtbench"):
                found.append((p, n))
            if lvl > 1:          # nothing from outside the reference
                found.append((p, f"level {lvl}"))
    assert not found, found
