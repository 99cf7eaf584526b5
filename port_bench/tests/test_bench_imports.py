"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port either."""

import ast
import os

import pytest

from harness import common

JAX = {"jax", "jaxlib", "flax", "stylegan_directions_face_reenactment_tpu"}


def _files(root):
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_files(common.BENCH_DIR)),
                         ids=lambda p: os.path.relpath(p, common.BENCH_DIR))
def test_no_jax(path):
    assert not (set(_top_names(path)) & JAX)


def test_reference_imports_nothing_of_the_port():
    for path in _files(os.path.join(common.BENCH_DIR, "reference")):
        assert common.PORT not in set(_top_names(path)), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    before = set(common.forbidden_modules())
    monkeypatch.setitem(sys.modules, "stylegan_directions_face_reenactment_tpu_torch_x", sys)
    assert set(common.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert set(common.forbidden_modules()) == before | {"jaxlib"}
