"""FLAME model data: ``generic_model.pkl`` and ``landmark_embedding.npy``
→ :class:`..models.deca.flame.FLAME`.

The FLAME pickle holds chumpy arrays and scipy sparse matrices (the
reference's ``FLAME.py:43-91`` decodes them with chumpy installed). chumpy
is not needed here: the pickle is read with a stub class whose
``__setstate__`` keeps the underlying numpy arrays.

:func:`write_flame_files` writes a seeded pair in the real files' layouts
(plain arrays) for runs without the separately licensed model.
"""

from __future__ import annotations

import pickle

import numpy as np

from ..models.deca.flame import FLAME

N_SHAPE = 100
N_EXP = 50
N_VERTS, N_FACES = 5023, 9976   # the real FLAME 2020 mesh


class _ChumpyStub:
    """Stands in for chumpy's array types while unpickling."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_data"] = None

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @property
    def r(self):
        return self.to_np()

    def to_np(self):
        for key in ("x", "_data", "a"):
            v = self.__dict__.get(key)
            if v is not None:
                return np.asarray(v)
        raise ValueError("could not extract array from chumpy stub")


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if isinstance(x, _ChumpyStub):
        return x.to_np()
    if hasattr(x, "todense"):  # scipy sparse
        return np.asarray(x.todense())
    return np.asarray(x)


def load_flame_params(model_path: str, lmk_embedding_path: str, n_shape: int = N_SHAPE,
                      n_exp: int = N_EXP) -> FLAME:
    """``generic_model.pkl`` + ``landmark_embedding.npy`` → :class:`FLAME`
    on the CPU: shapedirs sliced to [:n_shape] + [300:300 + n_exp],
    posedirs reshaped to (36, V·3) (``FLAME.py:51-66``)."""
    with open(model_path, "rb") as f:
        ss = _StubUnpickler(f, encoding="latin1").load()

    def get(key):
        return _to_np(ss[key] if isinstance(ss, dict) else getattr(ss, key))

    shapedirs = get("shapedirs").astype(np.float32)
    posedirs = get("posedirs").astype(np.float32)
    lmk = np.load(lmk_embedding_path, allow_pickle=True, encoding="latin1")[()]

    def lk(key):
        v = lmk[key]
        return v.numpy() if hasattr(v, "numpy") else np.asarray(v)

    return FLAME({
        "v_template": get("v_template"),
        "shapedirs": np.concatenate([shapedirs[:, :, :n_shape],
                                     shapedirs[:, :, 300:300 + n_exp]], axis=2),
        "posedirs": posedirs.reshape(-1, posedirs.shape[-1]).T,
        "j_regressor": get("J_regressor"),
        "lbs_weights": get("weights"),
        "faces": get("f").astype(np.int64),
        "lmk_faces_idx": lk("static_lmk_faces_idx"),
        "lmk_bary_coords": lk("static_lmk_bary_coords"),
        "dynamic_lmk_faces_idx": lk("dynamic_lmk_faces_idx"),
        "dynamic_lmk_bary_coords": lk("dynamic_lmk_bary_coords"),
        "full_lmk_faces_idx": lk("full_lmk_faces_idx").reshape(-1),
        "full_lmk_bary_coords": lk("full_lmk_bary_coords").reshape(-1, 3),
    })


def write_flame_files(model_path: str, lmk_embedding_path: str, n_verts: int = N_VERTS,
                      n_faces: int = N_FACES, seed: int = 0) -> None:
    """A FLAME ``generic_model.pkl`` and ``landmark_embedding.npy`` in the
    real files' layouts (400 shape and expression components, 36 pose
    blend shapes, 5 joints), from ``np.random.RandomState(seed)``: rows of
    ``J_regressor``, of ``weights`` and of the barycentric coordinates each
    sum to 1."""
    rs = np.random.RandomState(seed)
    v, f = n_verts, n_faces
    flame = {"v_template": (0.1 * rs.randn(v, 3)).astype(np.float32),
             "shapedirs": (0.01 * rs.randn(v, 3, 400)).astype(np.float32),
             "posedirs": (0.01 * rs.randn(v, 3, 36)).astype(np.float32),
             "J_regressor": rs.dirichlet(np.ones(v), 5).astype(np.float32),
             "weights": rs.dirichlet(np.ones(5), v).astype(np.float32),
             "f": rs.randint(0, v, (f, 3)).astype(np.uint32)}
    with open(model_path, "wb") as fh:
        pickle.dump(flame, fh, protocol=2)
    np.save(lmk_embedding_path, {
        "static_lmk_faces_idx": rs.randint(0, f, (51,)),
        "static_lmk_bary_coords": rs.dirichlet(np.ones(3), 51),
        "dynamic_lmk_faces_idx": rs.randint(0, f, (79, 17)),
        "dynamic_lmk_bary_coords": rs.dirichlet(np.ones(3), (79, 17)),
        "full_lmk_faces_idx": rs.randint(0, f, (1, 68)),
        "full_lmk_bary_coords": rs.dirichlet(np.ones(3), (1, 68))}, allow_pickle=True)
