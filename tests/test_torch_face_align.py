"""The port's face alignment against the JAX package on the CPU: the
200·scale crop, the reference-face choice, landmark estimation in both
detector conventions, the FFHQ device crop, and the DECA kpt68 warp with
its failure sentinel.

Weights: the port's seeded S3FD (plain, whose faces never pass the 0.99
gate, and boosted, whose faces all do) and a 2-module FAN with randomized
batch-norm statistics, through the JAX converters and back
(``tests/torch_face_zoo.py``). Inputs are made with numpy from a seed.

Tolerances:
* crops of the same frames: atol 2e-3 on [0, 255] values (two taps of f32
  weights per axis, summed in another order);
* landmarks: equal. FAN's argmax cells are 4 px of the crop; on these
  seeds no peak is within float noise of its runner-up, so any difference
  would be a fault, not rounding;
* FFHQ crops given the same landmarks: at most 1 intensity unit, the
  uint8 rounding between the passes (half of the pixels must agree exactly);
* warps: atol 1e-4 on [0, 1] values; coefficients as in
  ``tests/test_torch_deca.py`` (rtol 1e-3, atol 1e-3·max).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models.deca.deca import (
    calculate_shapemodel as j_calculate_shapemodel)
from stylegan_directions_face_reenactment_tpu.models.face.cropping import (
    ffhq_crop_device as j_ffhq_crop_device, landmarks_in_crop as j_landmarks_in_crop)
from stylegan_directions_face_reenactment_tpu.models.face.landmarks import (
    crop_faces as j_crop_faces, crop_transform as j_crop_transform,
    estimate_landmarks as j_estimate_landmarks,
    select_reference_face as j_select_reference_face)
from stylegan_directions_face_reenactment_tpu.models.nn import resize_bilinear as j_resize
from stylegan_directions_face_reenactment_tpu.pipeline.alignment import (
    kpt68_center_size as j_kpt68_center_size, landmark_align as j_landmark_align,
    warp_to_224 as j_warp_to_224)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_resnet_encoder)

from stylegan_directions_face_reenactment_tpu_torch.models.deca import calculate_shapemodel
from stylegan_directions_face_reenactment_tpu_torch.models.face import (
    crop_faces, crop_transform, estimate_landmarks, ffhq_crop_device, landmarks_in_crop,
    select_reference_face)
from stylegan_directions_face_reenactment_tpu_torch.pipeline.alignment import (
    DECA_CROP, kpt68_center_size, landmark_align, warp_to_224)
from stylegan_directions_face_reenactment_tpu_torch.weights import deca_from_jax, init_deca

from torch_face_zoo import fan_pair, s3fd_pair, statics_jit, to_np
from torch_threads import _threads  # noqa: F401

BOOST = "conv5_3_norm_mbox_conf"


@pytest.fixture(scope="module")
def nets():
    jf, pf = fan_pair(seed=21, num_modules=2)
    js, ps = s3fd_pair(seed=22)
    jb, pb = s3fd_pair(seed=22, boost_head=BOOST)
    return {"fan": (jf, pf), "sfd": (js, ps), "boost": (jb, pb)}


def test_crop_faces_matches_jax():
    rs = np.random.RandomState(1)
    imgs = rs.uniform(0, 255, (3, 90, 120, 3)).astype(np.float32)
    center = np.float32([[60.3, 45.7], [10.0, 80.2], [118.9, -3.5]])   # in, and half out
    scale = np.float32([0.31, 0.52, 0.2])
    want = np.asarray(j_crop_faces(jnp.asarray(imgs), jnp.asarray(center),
                                   jnp.asarray(scale), 64))
    got = crop_faces(torch.from_numpy(imgs), torch.from_numpy(center),
                     torch.from_numpy(scale), 64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert (got[2, :8] == 0).all()          # zero padding above the frame


def test_crop_transform_matches_jax():
    """The 200·scale crop's src→dst affine against the JAX function (rtol
    1e-6), and the corners ``crop_faces`` takes (ul = trunc(c − h/2 + h/res),
    br = trunc(c + h/2)) land within one source pixel (res/h of the crop) of
    crop pixel 1 and of res."""
    center = np.float32([[60.3, 45.7], [10.0, 80.2], [118.9, -3.5]])
    scale = np.float32([0.31, 0.52, 0.2])
    tc, ts = torch.from_numpy(center), torch.from_numpy(scale)
    torch.testing.assert_close(crop_transform(tc, ts), crop_transform(tc, ts, 256.0),
                               rtol=0, atol=0)
    for res in (64.0, 256.0):
        want = np.asarray(j_crop_transform(jnp.asarray(center), jnp.asarray(scale), res))
        got = crop_transform(tc, ts, res)
        assert got.shape == (3, 3, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        h = 200.0 * ts
        ul = torch.trunc(tc - (h / 2.0 - h / res)[:, None])
        br = torch.trunc(tc + (h / 2.0)[:, None])
        for corner, to in ((ul, 1.0), (br, res)):
            dst = torch.einsum("bij,bj->bi", got, torch.cat([corner, torch.ones(3, 1)], 1))
            assert ((dst[:, :2] - to).abs() <= (res / h)[:, None] + 1e-4).all()
            assert (dst[:, 2] == 1).all()


def test_select_reference_face_last_passing():
    boxes = np.float32([
        [[0, 0, 10, 10, 0.999], [20, 20, 30, 30, 0.995], [5, 5, 6, 6, 0.4]],
        [[0, 0, 10, 10, 0.999], [20, 20, 30, 30, 0.95], [0, 0, 0, 0, 0.0]],
        [[1, 2, 10, 10, 0.95], [0, 0, 0, 0, 0.0], [0, 0, 0, 0, 0.0]],
        [[1, 1, 9, 9, 0.9999], [2, 2, 8, 8, 0.9995], [3, 3, 7, 7, 0.9991]]])
    valid = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 0, 1]], bool)
    want_b, want_ok = j_select_reference_face(jnp.asarray(boxes), jnp.asarray(valid))
    got_b, got_ok = select_reference_face(torch.from_numpy(boxes), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_ok.numpy(), [True, True, False, True])
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_b[3].numpy(), boxes[3, 2])


@pytest.mark.parametrize("detector,boost", [("vendored", False), ("fa", True)])
def test_estimate_landmarks_matches_jax(nets, detector, boost):
    """Both SFD input conventions; with the plain net no face passes (the
    top box is cropped anyway), with the boosted one every frame passes."""
    jf, pf = nets["fan"]
    js, ps = nets["boost" if boost else "sfd"]
    imgs = np.random.RandomState(2).uniform(0, 255, (2, 128, 160, 3)).astype(np.float32)
    want_pts, want_ok, want_hm = statics_jit(
        lambda s, f, im: j_estimate_landmarks(s, f, im, detector_input=detector),
        js, jf)(jnp.asarray(imgs))
    with torch.no_grad():
        pts, ok, hm = estimate_landmarks(ps, pf, torch.from_numpy(imgs),
                                         detector_input=detector)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert bool(ok.all()) is boost
    want_hm = np.asarray(want_hm)
    np.testing.assert_allclose(hm.numpy(), want_hm, rtol=1e-3,
                               atol=1e-4 * np.abs(want_hm).max())
    np.testing.assert_array_equal(pts.numpy(), np.asarray(want_pts))


def test_ffhq_crop_device_and_landmarks_in_crop():
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (3, 120, 200, 3)).astype(np.uint8)
    lms = (rs.rand(3, 68, 2) * [50, 40] + [[70, 50]]).astype(np.float32)
    lms[2] += [120, 60]                                  # this box leaves the frame
    want, want_in = j_ffhq_crop_device(jnp.asarray(frames), jnp.asarray(lms), 64)
    got, got_in = ffhq_crop_device(torch.from_numpy(frames), torch.from_numpy(lms), 64)
    np.testing.assert_array_equal(got_in.numpy(), [True, True, False])
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 1.0 and (diff == 0).mean() > 0.5
    np.testing.assert_array_equal(got.numpy(), np.round(got.numpy()))
    want_l, want_v = j_landmarks_in_crop(jnp.asarray(lms), 64)
    got_l, got_v = landmarks_in_crop(torch.from_numpy(lms), 64)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_kpt68_and_warp_to_224():
    rs = np.random.RandomState(4)
    lms = (rs.rand(2, 68, 2) * 120 + 60).astype(np.float32)
    imgs = rs.rand(2, 256, 256, 3).astype(np.float32)
    want_c, want_s = j_kpt68_center_size(jnp.asarray(lms))
    got_c, got_s = kpt68_center_size(torch.from_numpy(lms))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    want = np.asarray(j_warp_to_224(jnp.asarray(imgs), want_c, want_s))
    got = warp_to_224(torch.from_numpy(imgs), got_c, got_s).numpy()
    assert got.shape == (2, DECA_CROP, DECA_CROP, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("ok", [(True, True), (True, False), (False, False)])
def test_landmark_align_ok_and_fallback(ok):
    rs = np.random.RandomState(5)
    imgs = rs.rand(2, 256, 256, 3).astype(np.float32)
    lms = (rs.rand(2, 68, 2) * 120 + 60).astype(np.float32)
    ok = np.array(ok)
    want, want_ok = j_landmark_align(jnp.asarray(imgs), jnp.asarray(lms), jnp.asarray(ok))
    got, got_ok = landmark_align(torch.from_numpy(imgs), torch.from_numpy(lms),
                                 torch.from_numpy(ok))
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_calculate_shapemodel_sentinel():
    """Frames the aligner flags keep zero coefficients and −180° angles; the
    others match the JAX package."""
    jd = {"e_flame": to_np(convert_resnet_encoder(init_deca(7, device="cpu").E_flame.state_dict()))}
    pd = deca_from_jax(jd, device="cpu")
    imgs = np.random.RandomState(6).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ok = np.array([True, False])

    def j_align(im01):
        return j_resize(im01, (DECA_CROP, DECA_CROP)), jnp.asarray(ok)

    def p_align(im01):
        x = torch.nn.functional.interpolate(im01.permute(0, 3, 1, 2), size=(DECA_CROP, DECA_CROP),
                                            mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1), torch.from_numpy(ok)

    want_p, want_a = statics_jit(lambda d, im: j_calculate_shapemodel(d, im, align_fn=j_align),
                                 jd)(jnp.asarray(imgs))
    with torch.no_grad():
        got_p, got_a = calculate_shapemodel(pd, torch.from_numpy(imgs), align_fn=p_align)
    assert (got_a[1] == -180.0).all() and (got_a[0] != -180.0).all()
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=1e-2)
    for k in ("pose", "alpha_shp", "alpha_exp", "cam"):
        assert (got_p[k][1] == 0).all() and (got_p[k][0] != 0).any()
        w = np.asarray(want_p[k])
        np.testing.assert_allclose(got_p[k].numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max())

