"""The port's ``cli/run_inference.py::main`` (``--device cpu``) against the
JAX package's ``main`` on the CPU: the same checkpoint files
(``tests/torch_cli_files.py``), the same PNG inputs, the same flags, at
``--image_resolution 64``, ``--no-optimize_generator --no-save_video``
(PTI and the video files have their own tests).

Inputs: 128×160 frames, black with a textured patch, rescaled to the
detection width 200 by cv2 in both packages. Two targets keep their FFHQ
box in the frame; a third has its patch in the top-left corner, so its box
leaves the frame and the fused loop re-crops it on the host (the fallback).
The source's box stays in the frame.

The one substitution: both packages draw the truncation's mean latent from
their own random z, so the JAX run's mean latent is handed to the port's
``compute_trunc``.

Tolerance: every PNG the port writes is within 1 intensity unit of the JAX
package's, and the two write the same files; the ``--save_images`` PNGs
of the grid mode are the native 64² frames (a known divergence from the
JAX package, which writes the 256² grid cell, ROADMAP queue 3), equal to
those of the reenact mode.

Each case runs both mains once. The file's time is mostly the JAX
package's first ``main`` in the process, whose source set-up runs op by op
and compiles about 1,100 small XLA programs (about 70 s of the file's).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_directions_face_reenactment_tpu.cli import model_loading as j_model_loading
from stylegan_directions_face_reenactment_tpu.cli.run_inference import main as j_main
from stylegan_directions_face_reenactment_tpu.utils import jax_cache

from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading
from stylegan_directions_face_reenactment_tpu_torch.cli.run_inference import main
from stylegan_directions_face_reenactment_tpu_torch.native import resize_bilinear_u8

from torch_cli_files import patch_frame, point_registries, seeded_modules, write_pretrained

H, W, SIDE = 128, 160, 40
IN_FRAME = [(60, 50, 0), (56, 70, 1)]      # (top, left, seed) of the patch
OUT_OF_FRAME = [(0, 0, 3)]
SOURCE = (64, 40, 2)
COMMON = ["--image_resolution", "64", "--no-optimize_generator", "--no-save_video",
          "--frame_batch", "2", "--detect_width", "200", "--save_images"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_pretrained(str(root), seeded_modules())

    def save(path, frame):
        Image.fromarray(frame).save(path)

    save(root / "source.png", patch_frame(H, W, *SOURCE[:2], SIDE, SOURCE[2]))
    for name, spots in (("in_frame", IN_FRAME), ("mixed", IN_FRAME + OUT_OF_FRAME)):
        os.makedirs(root / name)
        for i, (top, left, seed) in enumerate(spots):
            save(root / name / f"{i:03d}.png", patch_frame(H, W, top, left, SIDE, seed))
    os.makedirs(root / "crops")
    rs = np.random.RandomState(5)
    save(root / "crop_source.png", rs.randint(0, 256, (256, 256, 3)).astype(np.uint8))
    for i in range(2):
        save(root / "crops" / f"{i:03d}.png", rs.randint(0, 256, (256, 256, 3)).astype(np.uint8))
    return root


CASES = {
    # the default fused loop with grids: [source | crop | reenacted]
    "fused_grid": ("in_frame", ["--save_grid"]),
    # the reenacted frames alone, with one box out of the frame: the host
    # crop and the unfused program take that frame
    "reenact_out_of_frame": ("mixed", ["--video_content", "reenact"]),
    # the unfused loop: the host crop for every frame, and DECA aligned by
    # the preprocessing landmarks
    "no_device_crop_reuse_landmarks": ("mixed", ["--no-device_crop", "--reuse_landmarks",
                                                 "--save_grid"]),
    # 256² crops: no detection, the unfused loop, the resize alignment
    "skip_preprocess_resize": ("crops", ["--skip_preprocess", "--deca_alignment", "resize",
                                         "--save_grid"]),
}


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """``runs(case)`` → (JAX output folder, port output folder, the port's
    counts): both mains run once per case and module."""
    done = {}

    def run(case):
        if case in done:
            return done[case]
        targets, flags = CASES[case]
        out = tmp_path_factory.mktemp(case)
        source = "crop_source.png" if targets == "crops" else "source.png"
        argv = ["--source_path", str(files / source), "--target_path", str(files / targets)]
        argv += COMMON + flags
        with pytest.MonkeyPatch.context() as mp:
            point_registries(mp, str(files))
            mp.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)
            kept = {}
            j_compute_trunc = j_model_loading.compute_trunc

            def keep_trunc(g, *args, **kwargs):
                kept["trunc"] = np.asarray(j_compute_trunc(g, *args, **kwargs))
                return kept["trunc"]

            mp.setattr(j_model_loading, "compute_trunc", keep_trunc)
            mp.setattr(model_loading, "compute_trunc",
                       lambda g, *args, **kwargs: torch.tensor(kept["trunc"]))
            j_main(argv + ["--output_path", str(out / "jax")])
            stats = main(argv + ["--output_path", str(out / "port"), "--device", "cpu"])
        done[case] = (out / "jax", out / "port", stats)
        run.trunc = kept["trunc"]
        return done[case]

    return run


def pngs(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs if f.endswith(".png"))


def read(path):
    return np.asarray(Image.open(path)).astype(int)


def grid_cell(frame):
    """A 64² frame as the port's grid row resizes it to the 256 crop."""
    return resize_bilinear_u8(frame.astype(np.uint8)[None], (256, 256))[0].astype(int)


def assert_same_pngs(jax_dir, port_dir, n_frames, grids, fused):
    """Same files, each within 1 unit. Where the JAX package's fused grid
    mode writes the 256² grid cell as the frame's PNG, the port's 64² PNG
    is resized as the grid resizes it before the comparison. The JAX
    package's unfused grid resizes its 64² cell with Pillow's two passes,
    its device grid and the port's grid in one: the two resizes differ by
    up to 1 on their own (``test_torch_host_prep.py``), so there the port's
    reenacted cell is held against its resize of the JAX package's frame,
    and that against the JAX package's cell."""
    want = [f"{i:06d}.png" for i in range(n_frames)]
    if grids:
        want += [os.path.join("grids", f) for f in want]
    assert pngs(port_dir) == sorted(want) == pngs(jax_dir)
    for name in want:
        got, ref = read(port_dir / name), read(jax_dir / name)
        if name.startswith("grids"):
            assert got.shape == ref.shape == (256, 3 * 256, 3)
            if not fused:
                cell = grid_cell(read(jax_dir / os.path.basename(name)))
                assert np.abs(ref[:, 512:] - cell).max() <= 1, name
                ref = np.concatenate([ref[:, :512], cell], axis=1)
        else:
            assert got.shape == (64, 64, 3)
            if grids and fused:
                got = grid_cell(got)
        assert np.abs(got - ref).max() <= 1, name


@pytest.mark.parametrize("case", list(CASES))
def test_main_matches_jax(runs, case):
    targets, flags = CASES[case]
    jax_dir, port_dir, stats = runs(case)
    n = {"in_frame": len(IN_FRAME), "mixed": len(IN_FRAME) + len(OUT_OF_FRAME), "crops": 2}
    fused = case in ("fused_grid", "reenact_out_of_frame")
    assert stats["frames"] == n[targets] and stats["fused"] == fused
    if fused:
        assert stats["no_face"] == 0
        assert stats["fallback_frames"] == stats["fallback_calls"] == (targets == "mixed")
    assert_same_pngs(jax_dir, port_dir, n[targets], "--save_grid" in flags, fused)


def test_grid_mode_writes_native_frames(runs):
    """The port's ``--save_images`` PNG in grid mode is the 64² reenacted
    frame, equal to the reenact mode's (the JAX package writes the 256²
    grid cell there): the in-frame targets are the mixed folder's first
    chunk, so both cases reenact them in the same call."""
    grid, reenact = runs("fused_grid")[1], runs("reenact_out_of_frame")[1]
    for i in range(len(IN_FRAME)):
        got = read(grid / f"{i:06d}.png")
        assert got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, read(reenact / f"{i:06d}.png"))


@pytest.mark.parametrize("flags,error", [
    (["--reuse_landmarks", "--skip_preprocess"], ValueError),
    (["--reuse_landmarks", "--deca_alignment", "resize"], ValueError),
    (["--n_devices", "3"], ValueError),        # does not divide --frame_batch 16
])
def test_refused_flags(files, tmp_path, flags, error):
    with pytest.raises(error):
        main(["--source_path", str(files / "source.png"), "--target_path",
              str(files / "in_frame"), "--output_path", str(tmp_path), "--device", "cpu"]
             + flags)


def test_n_devices_splits_the_fused_loop_over_two_slots(files, runs, tmp_path):
    """``--n_devices 2 --device cpu``: every chunk of 2 frames split over a
    two-slot CPU mesh, a frame a slot, gathered in order; the same files
    as the one-device run (which the tests above hold against the JAX
    package), within 1 intensity unit of its PNGs."""
    _, port_out, _ = runs("fused_grid")
    targets, flags = CASES["fused_grid"]
    out = tmp_path / "mesh"
    with pytest.MonkeyPatch.context() as mp:
        point_registries(mp, str(files))
        mp.setattr(model_loading, "compute_trunc",
                   lambda g, *args, **kwargs: torch.tensor(runs.trunc))
        stats = main(["--source_path", str(files / "source.png"), "--target_path",
                      str(files / targets), *COMMON, *flags, "--n_devices", "2",
                      "--output_path", str(out), "--device", "cpu"])
    assert stats["fused"] and stats["frames"] == len(IN_FRAME)
    names = sorted(p.relative_to(port_out) for p in port_out.rglob("*.png"))
    assert names == sorted(p.relative_to(out) for p in out.rglob("*.png"))
    for name in names:
        assert np.abs(read(out / name) - read(port_out / name)).max() <= 1, name


def test_default_device_needs_a_card(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--source_path", str(files / "source.png"), "--target_path",
              str(files / "in_frame"), "--output_path", str(tmp_path)])
