"""Facial editing's parts against the JAX package on the CPU:
``geometry/directions.py::get_direction_info`` for all 15 directions,
``pipeline/editing.py::{one_hot_shift, sweep_direction}``,
``utils/visualization.py`` (the landmark drawings, the interpolation chart
and the GIF) and ``data/datasets.py`` (``DatasetInversion`` and ``Loader``).

Weights: a 64² voxceleb-layout generator (channel multiplier 1) seeded in
the port and converted by the JAX package's converter, and the JAX
package's seeded A, carried into the port with ``weights/from_jax.py``.
Inputs are made with numpy from a seed.

Tolerances: the sweep's values exactly and its images atol 2e-4·max|JAX
image|; the chart's uint8 frames within 1 unit (they truncate float
images); the direction info to float32 rounding; drawings, GIF frames,
dataset samples and the loader's order exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_directions_face_reenactment_tpu.data import datasets as jds
from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    get_direction_info as j_get_direction_info,
    initialize_directions as j_initialize_directions)
from stylegan_directions_face_reenactment_tpu.models.direction_matrix import (
    init_direction_matrix)
from stylegan_directions_face_reenactment_tpu.models.stylegan2 import n_latent_for
from stylegan_directions_face_reenactment_tpu.pipeline import editing as jed
from stylegan_directions_face_reenactment_tpu.utils import visualization as jvis
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_stylegan2_generator)

from stylegan_directions_face_reenactment_tpu_torch.data import datasets as pds
from stylegan_directions_face_reenactment_tpu_torch.geometry import (
    get_direction_info, initialize_directions)
from stylegan_directions_face_reenactment_tpu_torch.pipeline.editing import (
    one_hot_shift, sweep_direction)
from stylegan_directions_face_reenactment_tpu_torch.utils import visualization as pvis
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    direction_matrix_from_jax, generator_from_jax, init_generator)

from torch_face_zoo import to_np

SIZE = 64


@pytest.fixture(scope="module")
def world():
    sd = {k: (v[None] if k.endswith("conv.weight") else v) for k, v in
          init_generator(5, size=SIZE, channel_multiplier=1, device="cpu")
          .state_dict().items()}
    g = to_np(convert_stylegan2_generator(sd, size=SIZE, channel_multiplier=1))
    a = to_np(init_direction_matrix(jax.random.PRNGKey(6), 512, 15, w_plus=True,
                                    num_layers=8))
    rs = np.random.RandomState(0)
    return {"jax": (g, a),
            "port": (generator_from_jax(g, device="cpu"), direction_matrix_from_jax(a, "cpu")),
            "code": (0.5 * rs.randn(1, n_latent_for(SIZE), 512)).astype(np.float32),
            "trunc": (0.1 * rs.randn(1, 512)).astype(np.float32),
            "params": {"pose": (0.2 * rs.randn(1, 6)).astype(np.float32),
                       "alpha_exp": rs.randn(1, 50).astype(np.float32)},
            "angles": (15 * rs.randn(1, 3)).astype(np.float32)}


def _max_scaled(got, want, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_rel * np.abs(want).max())


@pytest.mark.parametrize("dataset", ["voxceleb", "ffhq"])
@pytest.mark.parametrize("direction", range(15))
def test_get_direction_info_matches_jax(world, dataset, direction):
    spec_j = j_initialize_directions(dataset, 15, 6.0)
    spec_p = initialize_directions(dataset, 15, 6.0)
    want = j_get_direction_info(spec_j, direction, world["params"], world["angles"], 7)
    got = get_direction_info(spec_p, direction, world["params"], world["angles"], 7)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6, atol=1e-6)


def test_one_hot_shift_matches_jax():
    values = np.linspace(-3, 3, 7).astype(np.float32)
    want = jed.one_hot_shift(15, 4, jnp.asarray(values))
    np.testing.assert_array_equal(one_hot_shift(15, 4, torch.from_numpy(values)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("direction", [0, 3, 9])
def test_sweep_direction_matches_jax(world, direction):
    g, a = world["jax"]
    spec_j = j_initialize_directions("voxceleb", 15, 6.0)
    name_j, values_j, imgs_j = jed.sweep_direction(
        g, a, spec_j, jnp.asarray(world["code"]), direction, world["params"],
        world["angles"], shifts_count=3, truncation=0.7,
        truncation_latent=jnp.asarray(world["trunc"]))
    pg, pa = world["port"]
    with torch.no_grad():
        name, values, imgs = sweep_direction(
            pg, pa, initialize_directions("voxceleb", 15, 6.0),
            torch.from_numpy(world["code"]), direction, world["params"], world["angles"],
            shifts_count=3, truncation=0.7, truncation_latent=torch.from_numpy(world["trunc"]))
    assert name == name_j and imgs.shape == (len(values), SIZE, SIZE, 3)
    np.testing.assert_array_equal(values, values_j)
    _max_scaled(imgs.numpy(), imgs_j, 2e-4)


def test_interpolation_chart_matches_jax(world):
    g, a = world["jax"]
    kw = dict(truncation=0.7, directions=[1, 4], steps=1)
    want = jvis.make_interpolation_chart(g, a, jnp.asarray(world["code"]),
                                         truncation_latent=jnp.asarray(world["trunc"]), **kw)
    pg, pa = world["port"]
    got = pvis.make_interpolation_chart(pg, pa, torch.from_numpy(world["code"]),
                                        truncation_latent=torch.from_numpy(world["trunc"]),
                                        **kw)
    assert len(got) == len(want) == 3
    for f, w in zip(got, want):
        assert f.shape == w.shape == (SIZE, 2 * SIZE, 3) and f.dtype == np.uint8
        assert np.abs(f.astype(int) - w.astype(int)).max() <= 1


def _kpts(seed, n=68, cols=2, hw=64):
    rs = np.random.RandomState(seed)
    k = rs.uniform(-6, hw + 6, (n, cols)).astype(np.float32)
    if cols == 4:
        k[:, 3] = rs.rand(n)
    return k


@pytest.mark.parametrize("cols,color", [(2, "r"), (3, "b"), (4, "g")])
def test_plot_kpts_matches_jax(cols, color):
    img = np.random.RandomState(1).uniform(0, 255, (64, 64, 3)).astype(np.float32)
    k = _kpts(2, cols=cols)
    np.testing.assert_array_equal(pvis.plot_kpts(img, k, color), jvis.plot_kpts(img, k, color))
    np.testing.assert_array_equal(pvis.plot_verts(img, k, color),
                                  jvis.plot_verts(img, k, color))


@pytest.mark.parametrize("is_scale", [True, False])
def test_vis_landmarks_matches_jax(is_scale):
    rs = np.random.RandomState(3)
    imgs = rs.rand(2, 64, 64, 3).astype(np.float32)
    lms = rs.uniform(-1.1, 1.1, (2, 68, 2)).astype(np.float32)
    if not is_scale:
        lms = (lms + 1) * 32
    gt = rs.uniform(-1, 1, (2, 68, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        pvis.vis_landmarks(imgs, lms, gt, is_scale=is_scale),
        jvis.vis_landmarks(imgs, lms, gt, is_scale=is_scale))


def _gif_frames(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
    return frames, im.info.get("duration"), im.info.get("loop")


def test_save_gif_matches_jax(tmp_path):
    rs = np.random.RandomState(4)
    frames = [rs.randint(0, 256, (32, 48, 3)).astype(np.uint8) for _ in range(5)]
    pvis.save_gif(frames, str(tmp_path / "port.gif"), fps=15)
    jvis.save_gif(frames, str(tmp_path / "jax.gif"), fps=15)
    got, want = _gif_frames(tmp_path / "port.gif"), _gif_frames(tmp_path / "jax.gif")
    assert len(got[0]) == 5 and got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


def _tree(root, ids=2, videos=2, frames=3, hw=40):
    rs = np.random.RandomState(5)
    for i in range(ids):
        for v in range(videos):
            d = os.path.join(root, f"id{i:02d}", f"vid{v}", "frames_cropped")
            os.makedirs(d)
            for f in range(frames):
                Image.fromarray(rs.randint(0, 256, (hw, hw, 3)).astype(np.uint8)).save(
                    os.path.join(d, f"{f:04d}.png"))


def test_dataset_inversion_and_loader_match_jax(tmp_path):
    _tree(str(tmp_path))
    want_ds = jds.DatasetInversion(str(tmp_path), image_size=32)
    got_ds = pds.DatasetInversion(str(tmp_path), image_size=32)
    assert got_ds.entries == want_ds.entries and len(got_ds) == 12
    for shuffle, drop_last in ((False, False), (True, True)):
        got = list(pds.Loader(got_ds, 5, shuffle=shuffle, drop_last=drop_last, seed=3))
        want = list(jds.Loader(want_ds, 5, shuffle=shuffle, drop_last=drop_last, seed=3))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for gb, wb in zip(got, want):
            assert gb.keys() == wb.keys() and gb["path"] == wb["path"]
            assert gb["filename"] == wb["filename"] and gb["id_index"] == wb["id_index"]
            np.testing.assert_array_equal(gb["image"], wb["image"])
    with pytest.raises(FileNotFoundError):
        pds.DatasetInversion(str(tmp_path / "empty"))
