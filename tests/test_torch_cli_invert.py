"""The port's ``cli/invert_images.py::main`` (``--device cpu``) against the
JAX package's on the CPU: the same checkpoint files
(``tests/torch_cli_files.py``: generator and e4e), at
``--image_resolution 64``, on a fabricated tree of 2 identities × 1 video
× 3 frames of 64² (``<id>/<video>/frames_cropped/*.png``), batch 3.

The one substitution: both packages draw the truncation's mean latent from
their own random z, so the JAX run's is handed to the port's
``compute_trunc``.

Tolerance: the two write the same files; the resynthesized PNGs within 1
intensity unit, the W+ codes rtol 1e-4, atol 1e-4·max.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_directions_face_reenactment_tpu.cli.invert_images import main as j_invert_main
from stylegan_directions_face_reenactment_tpu.utils import jax_cache

from stylegan_directions_face_reenactment_tpu_torch.cli.invert_images import main

from torch_cli_files import hand_over_trunc, point_registries, seeded_modules, write_pretrained

TREE = {"id00001": ["vidA"], "id00002": ["vidB"]}
FRAMES = 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("invert")
    write_pretrained(str(root), seeded_modules(("g", "e4e")))
    rs = np.random.RandomState(2)
    for ident, videos in TREE.items():
        for v in videos:
            d = root / "tree" / ident / v / "frames_cropped"
            os.makedirs(d)
            for f in range(FRAMES):
                Image.fromarray(rs.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
                    d / f"{f:05d}.png")
    return root


def listing(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs)


def test_invert_images_main_matches_jax(files, tmp_path, monkeypatch):
    point_registries(monkeypatch, str(files))
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)
    hand_over_trunc(monkeypatch)
    jax_tree, port_tree = tmp_path / "jax", tmp_path / "port"
    for t in (jax_tree, port_tree):
        shutil.copytree(files / "tree", t)
    argv = ["--image_resolution", "64", "--batch_size", "3"]
    j_invert_main(argv + ["--dataset_path", str(jax_tree)])
    res = main(argv + ["--dataset_path", str(port_tree), "--device", "cpu"])
    n = sum(len(v) for v in TREE.values()) * FRAMES
    assert res == {"frames": n, "batches": n // 3}
    names = listing(port_tree)
    assert names == listing(jax_tree)
    inv = [f for f in names if "/inversion/" in f]
    assert len(inv) == 2 * n
    for f in inv:
        if f.endswith(".png"):
            got = np.asarray(Image.open(port_tree / f)).astype(int)
            want = np.asarray(Image.open(jax_tree / f)).astype(int)
            assert got.shape == (64, 64, 3) and np.abs(got - want).max() <= 1, f
        else:
            got, want = np.load(port_tree / f), np.load(jax_tree / f)
            assert got.shape == (10, 512) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_default_device_needs_a_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset_path", str(files / "tree")])
