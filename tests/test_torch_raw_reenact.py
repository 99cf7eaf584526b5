"""The port's default per-frame path, raw frames in (SFD → FAN → FFHQ crop →
SFD + FAN DECA alignment → DECA → Δp → A → synthesis), against the JAX
package's ``make_fused_reenact_fn`` on the CPU, stage by stage and whole,
in all three output modes. The set-up is ``tests/torch_reenact_world.py``
(T = 2 frames of 256², a 64² generator, a 2-module FAN, a boosted S3FD so
that every face passes the gate).

Tolerances:
* ok, in_frame: equal; landmarks: equal (FAN's argmax cells are 4 px; no
  peak on these seeds is within float noise of its runner-up);
* crops: at most 1 intensity unit, 1/127.5 in [-1, 1] (the uint8 rounding
  between the passes of the FFHQ resample); ``to_gan_range``: equal;
* the rest given the same crops, and the whole path: images rtol 1e-3,
  atol 2e-4·max|image|; latents rtol 1e-4, atol 1e-4·max|latent| (the
  bounds of ``tests/test_torch_reenact.py`` for DECA → Δp → A → synthesis);
* uint8 outputs: at most 1 unit from the JAX package's (the float images
  differ in their last digits, which can move a rounding).

bf16 (SFD, FAN and the DECA trunk in bf16 in both packages, rounding in
other places; boxes, peaks and coefficients f32): the limits are about
twice the readings.
* preprocessing heatmaps on the same frames: mean relative drift 0.0152
  (limit 0.03), max |diff| 0.024·max|heatmap| (limit 0.05); ok equal;
* the fused path: ok and in_frame equal; landmarks 16 of 136 moved to
  another argmax cell of the near-flat random-init heatmaps, mean |diff|
  1.65 px (limit 3.5 px); crops at most 1 unit, as in float32; latents
  mean relative 5.7e-8 (limit 2e-7: on these seeds the DECA warp lands
  in the crop's empty out-of-frame corner, so the coefficients are zero in
  both dtypes); images 0.0066 (limit 0.014).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.geometry.directions import (
    initialize_directions as j_initialize_directions)
from stylegan_directions_face_reenactment_tpu.models.face.landmarks import (
    estimate_landmarks as j_estimate_landmarks)
from stylegan_directions_face_reenactment_tpu.pipeline.preprocess import (
    to_gan_range as j_to_gan_range)
from stylegan_directions_face_reenactment_tpu.pipeline.reenactment import (
    make_fused_reenact_fn as j_make_fused_reenact_fn)

from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
from stylegan_directions_face_reenactment_tpu_torch.models.face import estimate_landmarks
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    make_fused_reenact_fn, preprocess_batch_device, reenact_batch, to_gan_range)

from torch_face_zoo import statics_jit
from torch_reenact_world import SIZE, T, build_world, close_scaled, mean_rel


@pytest.fixture(scope="module")
def world():
    return build_world()


def _jax_fused(world, dtype="float32"):
    g, a, deca, jf, js = world["jax"]
    fn = j_make_fused_reenact_fn(g, a, deca, j_initialize_directions("voxceleb", 15, 6.0),
                                 js, jf, truncation_latent=jnp.asarray(world["trunc"]),
                                 fan_params=jf, s3fd_params=js,
                                 compute_dtype=getattr(jnp, dtype))
    out = fn(world["code"], world["ps"], world["ang"], jnp.asarray(world["frames"]))
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def jax_full(world):
    return _jax_fused(world)


def _port_fused(world, **kw):
    g, a, deca, pf, ps = world["port"]
    fn = make_fused_reenact_fn(g, a, deca, initialize_directions("voxceleb", 15, 6.0),
                               ps, pf, truncation_latent=world["trunc"], fan_params=pf,
                               s3fd_params=ps, device="cpu", **kw)
    return fn(world["code"], world["ps"], world["ang"], world["frames"])


@pytest.fixture(scope="module")
def port_full(world):
    return [o.numpy() for o in _port_fused(world)]


def test_preprocessing_stage_matches_jax(jax_full, port_full):
    _, _, crops_w, ok_w, inf_w, pts_w = jax_full
    _, _, crops, ok, inf, pts = port_full
    assert ok.all() and ok.dtype == bool
    np.testing.assert_array_equal(ok, ok_w)
    np.testing.assert_array_equal(inf, inf_w)
    np.testing.assert_array_equal(pts, pts_w)
    assert crops.dtype == np.uint8 and crops.shape == (T, 256, 256, 3)
    assert np.abs(crops.astype(int) - crops_w.astype(int)).max() <= 1


def test_preprocess_batch_device_matches_jax(world, jax_full):
    """The preprocessing program alone (crops in [-1, 1]) against the JAX
    package's preprocessing stage of the same frames, and ``to_gan_range``."""
    _, _, crops_w, ok_w, inf_w, pts_w = jax_full
    pf, ps = world["port"][3:]
    with torch.no_grad():
        crops, ok, inf, pts = preprocess_batch_device(ps, pf, torch.from_numpy(world["frames"]))
    np.testing.assert_array_equal(ok.numpy(), ok_w)
    np.testing.assert_array_equal(inf.numpy(), inf_w)
    np.testing.assert_array_equal(pts.numpy(), pts_w)
    assert np.abs(crops.numpy() - j_to_gan_range(crops_w)).max() <= 1.0 / 127.5 + 1e-6
    np.testing.assert_array_equal(to_gan_range(world["frames"]), j_to_gan_range(world["frames"]))


def test_rest_on_the_same_crops_matches_jax(world, jax_full):
    """reenact_batch with the SFD + FAN alignment, fed the JAX package's
    crops: the alignment, DECA, Δp, A and the synthesis."""
    reen_w, lat_w, crops_w = jax_full[:3]
    g, a, deca, pf, ps = world["port"]
    t = torch.from_numpy
    with torch.no_grad():
        img, lat = reenact_batch(
            g, a, deca, initialize_directions("voxceleb", 15, 6.0), t(world["code"]),
            {k: t(v) for k, v in world["ps"].items()}, t(world["ang"]),
            t(crops_w.astype(np.float32)) / 127.5 - 1.0, truncation=0.7,
            truncation_latent=t(world["trunc"]), fan_params=pf, s3fd_params=ps)
    assert img.shape == (T, SIZE, SIZE, 3)
    close_scaled(lat.numpy(), lat_w, 1e-4, 1e-4)
    close_scaled(img.numpy(), reen_w, 1e-3, 2e-4)


def test_fused_full_matches_jax(jax_full, port_full):
    reen_w, lat_w = jax_full[:2]
    reen, lat = port_full[:2]
    assert reen.dtype == np.float32 and np.isfinite(reen).all()
    close_scaled(lat, lat_w, 1e-4, 1e-4)
    close_scaled(reen, reen_w, 1e-3, 2e-4)


def _u8(x):
    return np.floor(np.clip((np.asarray(x, np.float32) + 1.0) * 127.5, 0, 255) + 0.5) \
        .astype(np.uint8)


def _within_one(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["output_u8", "reenact"])
def test_fused_reduced_outputs(world, jax_full, port_full, mode):
    """uint8 images rounded half up; the reenact mode without crops."""
    reen_w, _, _, ok_w, inf_w, pts_w = jax_full
    reen_f = port_full[0]
    kw = {"output_u8": True} if mode == "output_u8" else {"outputs": mode}
    out = [o.numpy() for o in _port_fused(world, **kw)]
    if mode == "output_u8":
        np.testing.assert_array_equal(out[0], _u8(reen_f))
        _within_one(out[0], _u8(reen_w))
        return
    assert len(out) == 4
    np.testing.assert_array_equal(out[1], ok_w)
    np.testing.assert_array_equal(out[2], inf_w)
    np.testing.assert_array_equal(out[3], pts_w)
    np.testing.assert_array_equal(out[0], _u8(reen_f))
    _within_one(out[0], _u8(reen_w))


def test_bf16_preprocessing_heatmaps_match_jax(world):
    """The preprocessing pass's SFD → crop → FAN in bf16 on the same frames:
    the heatmaps (f32 out) drift only by bf16 rounding, so the boxes that
    placed the FAN crops agree."""
    _, _, _, jf, js = world["jax"]
    pf, ps = world["port"][3:]
    frames = world["frames"].astype(np.float32)
    _, ok_w, hm_w = statics_jit(lambda s, f, im: j_estimate_landmarks(
        s, f, im, compute_dtype=jnp.bfloat16), js, jf)(jnp.asarray(frames))
    with torch.no_grad():
        _, ok, hm = estimate_landmarks(ps, pf, torch.from_numpy(frames),
                                       compute_dtype=torch.bfloat16)
    hm_w = np.asarray(hm_w, np.float32)
    assert hm.dtype == torch.float32
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_w))
    assert mean_rel(hm, hm_w) < 0.03
    assert np.abs(hm.numpy() - hm_w).max() < 0.05 * np.abs(hm_w).max()


def test_fused_bf16_matches_jax(world):
    """``make_fused_reenact_fn(compute_dtype=bfloat16)`` against the JAX
    package's, every output."""
    reen_w, lat_w, crops_w, ok_w, inf_w, pts_w = _jax_fused(world, "bfloat16")
    with torch.no_grad():
        reen, lat, crops, ok, inf, pts = _port_fused(world, compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(ok.numpy(), ok_w)
    np.testing.assert_array_equal(inf.numpy(), inf_w)
    assert pts.dtype == torch.float32 and reen.dtype == torch.float32
    assert np.abs(pts.numpy() - pts_w).mean() < 3.5
    assert np.abs(crops.numpy().astype(int) - crops_w.astype(int)).max() <= 1
    assert mean_rel(lat, np.asarray(lat_w, np.float32)) < 2e-7
    assert mean_rel(reen, np.asarray(reen_w, np.float32)) < 0.014
