"""The port's public surface against the JAX package's.

The JAX package's files are walked, not listed, so a module added there
later fails here until the port has it. One case a JAX module, named by
its dotted path under the package. For each, the port module of the same
dotted path must import and have, as attributes:

* every public function and class the JAX module defines at its top level;
* every UPPER_CASE constant it assigns or imports at its top level;
* every name in its ``__all__``;
* for a package ``__init__``, every name it imports that is not a module.

The JAX sources are parsed with ``ast``; nothing of JAX is imported.
``EXCEPTIONS`` is the only room: each entry is (module pattern, name
pattern, reason), matched with ``fnmatch`` against the dotted path ("" for
the package root) and the name; a name pattern ``*`` excepts the whole
module. ``test_exceptions_are_not_stale`` holds each entry to something the
JAX package still has.
"""

import ast
import fnmatch
import importlib
import os

import pytest

import stylegan_directions_face_reenactment_tpu_torch as port_pkg

from torch_threads import _threads  # noqa: F401

PORT = port_pkg.__name__
JAX_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(port_pkg.__file__))),
                       "stylegan_directions_face_reenactment_tpu")

_INITS = "JAX pytree inits; the port builds nn.Modules, its seeded inits are weights/from_jax.py's"
_CONVERT = ("reference state dicts into JAX pytrees; the port loads them with "
            "load_state_dict")
_SWITCH = "a switch between Pallas and XLA; the port runs its kernels on the card with no switch"
_SHARDING = "jax.sharding; the port has shard_batch and data_parallel"
_PYTREE = "pytree plumbing for jit and optax"
_XLA_CACHE = "XLA's compile cache"
_LIBAV = ("a ctypes handle to the JAX package's libav library; the port reads video "
          "through OpenCV")

EXCEPTIONS = (
    ("models*", "init_*", _INITS),
    ("losses*", "init_*", _INITS),
    ("weights.torch_convert", "*", _CONVERT),
    ("weights", "convert_*", _CONVERT),
    ("weights", "conv_w", _CONVERT),
    ("weights", "lin_w", _CONVERT),
    ("weights", "bn", _CONVERT),
    ("losses*", "convert_lpips_alex", _CONVERT),
    ("ops.pallas_upfirdn", "*",
     "Pallas bodies; their counterparts are csrc/*.cu through ops/upfirdn2d_kernel.py and "
     "the sdfr::* operators"),
    ("ops*", "*_pallas", "a Pallas body; its counterpart is a csrc/*.cu kernel"),
    ("ops.upfirdn2d", "get_resample_backend", _SWITCH),
    ("ops.upfirdn2d", "set_resample_backend", _SWITCH),
    ("ops.fused_conv_block", "set_fused_convblock", _SWITCH),
    ("parallel*", "P", _SHARDING),
    ("parallel*", "batch_sharding", _SHARDING),
    ("parallel*", "replicated", _SHARDING),
    ("parallel*", "data_parallel_jit", _SHARDING),
    ("train.steps", "strip_statics", _PYTREE),
    ("train.steps", "merge_statics", _PYTREE),
    ("train.steps", "split_a", _PYTREE),
    ("utils.jax_cache", "*", _XLA_CACHE),
    ("utils", "enable_persistent_cache", _XLA_CACHE),
    ("utils.common", "jit_build", _XLA_CACHE),
    ("native.imgproc", "get_lib", _LIBAV),
    ("native.imgproc", "native_available", _LIBAV),
)


def _jax_modules():
    """{dotted path under the package: (file, is a package __init__)}."""
    out = {}
    for root, dirs, files in os.walk(JAX_DIR):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f[:-3]), JAX_DIR).split(os.sep)
            is_pkg = rel[-1] == "__init__"
            parts = rel[:-1] if is_pkg else rel
            out[".".join(parts)] = (os.path.join(root, f), is_pkg)
    return out


def _is_module(path, module, level, name):
    """Whether ``from <level dots><module> import name`` in the file at
    ``path`` names a module of the JAX package."""
    base = os.path.dirname(path)
    for _ in range(level - 1):
        base = os.path.dirname(base)
    if module:
        base = os.path.join(base, *module.split("."))
    return os.path.isfile(os.path.join(base, name + ".py")) or os.path.isdir(
        os.path.join(base, name))


def _surface(path, is_pkg):
    """The public names the JAX module at ``path`` exposes (module doc)."""
    tree = ast.parse(open(path).read())
    names = set()
    for s in tree.body:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(s.name)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            for t in (s.targets if isinstance(s, ast.Assign) else [s.target]):
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id == "__all__":
                        names.update(ast.literal_eval(s.value))
                    elif isinstance(n, ast.Name) and n.id.isupper():
                        names.add(n.id)
        elif isinstance(s, (ast.Import, ast.ImportFrom)):
            for a in s.names:
                name = (a.asname or a.name).split(".")[0]
                relative_non_module = (is_pkg and isinstance(s, ast.ImportFrom) and s.level
                                       and not _is_module(path, s.module, s.level, a.name))
                if name.isupper() or relative_non_module:
                    names.add(name)
    return {n for n in names if not n.startswith("_")}


def _excepted(module, name):
    return any(fnmatch.fnmatchcase(module, m) and fnmatch.fnmatchcase(name, n)
               for m, n, _ in EXCEPTIONS)


MODULES = _jax_modules()
CASES = sorted(m for m in MODULES if not _excepted(m, "*"))


def test_the_walk_finds_the_jax_package():
    assert len(MODULES) > 60
    assert {"", "serving", "models.face.landmarks", "native.imgproc"} <= set(MODULES)
    assert MODULES["models.face"][1] and not MODULES["models.face.landmarks"][1]
    assert {"crop_transform", "CROP_RESOLUTION", "REFERENCE_SCALE"} <= _surface(
        *MODULES["models.face.landmarks"])


@pytest.mark.parametrize("module", CASES, ids=lambda m: m or "<root>")
def test_port_module_has_the_jax_names(module):
    port = importlib.import_module(".".join(filter(None, (PORT, module))))
    want = {n for n in _surface(*MODULES[module]) if not _excepted(module, n)}
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


@pytest.mark.parametrize("entry", EXCEPTIONS, ids=lambda e: f"{e[0]}::{e[1]}")
def test_exceptions_are_not_stale(entry):
    """Each exception names a JAX module that exists and, unless it takes
    the whole module, a name that one of its modules still exposes; and
    gives its reason."""
    mod_pat, name_pat, reason = entry
    assert reason
    modules = [m for m in MODULES if fnmatch.fnmatchcase(m, mod_pat)]
    assert modules, f"no JAX module matches {mod_pat}"
    if name_pat != "*":
        assert any(fnmatch.fnmatchcase(n, name_pat)
                   for m in modules for n in _surface(*MODULES[m])), entry
