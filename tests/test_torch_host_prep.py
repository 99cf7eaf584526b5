"""The port's host preparation against the JAX package's on the CPU: the
bilinear resize and range conversions (``native/imgproc.py``), the host
FFHQ crop (``models/face/cropping.py``), ``resize_width``,
``preprocess_images``, ``make_prep_fn`` and the grid row of the CLI's
``--save_grid`` (``utils/image_utils.py``).

Tolerances:
* ``resize_bilinear_u8``: within 1 unit of the JAX package's native resize
  (equal on these inputs: the same float64 arithmetic); the JAX package
  falls back to Pillow's antialiased bilinear without its native library,
  which agrees within 1 unit only where nothing shrinks;
* the host crop: within 1 unit of Pillow's bicubic (the JAX package's
  ``crop_using_landmarks``) and of the JAX batch crop; about 1e-5 to 3e-4 of
  the pixels differ, by 1;
* ``preprocess_images`` and ``make_prep_fn``: ok and in-frame decisions
  equal, crops within 1 unit (1/127.5 in [-1, 1]), landmarks in crop
  coordinates rtol 1e-5, atol 1e-4 px (the same SFD → FAN landmarks, mapped
  in float32 in both);
* the grid row: within 1 unit of the JAX package's host grid (Pillow's
  bilinear) and of its device grid's cell resize (``jax.image.resize``);
* video through OpenCV: a round trip within the codec's loss, and the JAX
  package's libav reader decodes the same frames (``tests/test_torch_video.py``
  holds the two further).
"""

import numpy as np
import jax
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models.face import cropping as j_cropping
from stylegan_directions_face_reenactment_tpu.native import imgproc as j_imgproc
from stylegan_directions_face_reenactment_tpu.pipeline.preprocess import (
    preprocess_images as j_preprocess_images, resize_width as j_resize_width)
from stylegan_directions_face_reenactment_tpu.pipeline.source_setup import (
    make_prep_fn as j_make_prep_fn)
from stylegan_directions_face_reenactment_tpu.utils.image_utils import (
    generate_grid_image as j_generate_grid_image)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_fan, convert_s3fd)

from stylegan_directions_face_reenactment_tpu_torch.models.face.cropping import (
    crop_using_landmarks, crop_using_landmarks_batch)
from stylegan_directions_face_reenactment_tpu_torch.native import (
    extract_frames, from_gan_range, generate_video, resize_bilinear_u8, video_fps)
from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
    make_prep_fn, preprocess_images, resize_width, to_gan_range)
from stylegan_directions_face_reenactment_tpu_torch.utils.image_utils import (
    generate_grid_image, tensor_to_image)

from torch_cli_files import FAN_MODULES, patch_frame, seeded_modules
from torch_face_zoo import to_np

ONE = 1.0 / 127.5 + 1e-6


def max_diff(got, want):
    return int(np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int)).max())


@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (256, 256)), ((256, 256), (256, 256)),
                                          ((120, 160), (150, 401)), ((562, 1000), (256, 256))])
def test_resize_bilinear_u8_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(0).randint(0, 256, (2,) + in_hw + (3,)).astype(np.uint8)
    got = resize_bilinear_u8(x, out_hw)
    assert got.dtype == np.uint8 and got.shape == (2,) + out_hw + (3,)
    shrinks = in_hw[0] > out_hw[0] or in_hw[1] > out_hw[1]
    if j_imgproc.native_available() or not shrinks:
        assert max_diff(got, j_imgproc.resize_bilinear_u8(x, out_hw)) <= 1


def test_gan_range_conversions():
    """``to_gan_range`` is exact; ``from_gan_range`` clips and rounds half
    up as the JAX package's native library does."""
    u8 = np.random.RandomState(1).randint(0, 256, (3, 5, 7, 3)).astype(np.uint8)
    f = np.random.RandomState(2).uniform(-1.2, 1.2, (3, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_gan_range(u8), u8.astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(from_gan_range(f), np.floor(
        np.clip((f + 1.0) * 127.5, 0, 255) + 0.5).astype(np.uint8))
    if j_imgproc.native_available():
        np.testing.assert_array_equal(from_gan_range(f), j_imgproc.from_gan_range(f))
        np.testing.assert_array_equal(to_gan_range(u8), j_imgproc.to_gan_range(u8))


def _ring(cx, cy, r, seed):
    """68 landmarks on a jittered ring (float32)."""
    rs = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    k = rs.uniform(0.5, 1.0, (2, 68))
    return np.stack([cx + r * np.cos(t) * k[0], cy + r * np.sin(t) * k[1]], -1).astype(np.float32)


@pytest.fixture(scope="module")
def crop_inputs():
    h, w = 300, 400
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([128 + 100 * np.sin(xx / 17.0 + c) * np.cos(yy / 23.0) for c in range(3)],
                      -1).astype(np.uint8)
    noise = np.random.RandomState(3).randint(0, 256, (h, w, 3)).astype(np.uint8)
    # in the frame; over the left/top edges; over the right/bottom edges;
    # larger than the frame
    lms = [_ring(200, 160, 60, 4), _ring(60, 60, 70, 5), _ring(380, 280, 50, 6),
           _ring(200, 150, 140, 7)]
    return [smooth, noise], lms


def test_crop_using_landmarks_matches_jax(crop_inputs):
    images, lms = crop_inputs
    for img in images:
        for lm in lms:
            got = crop_using_landmarks(img, lm)
            assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
            assert max_diff(got, j_cropping.crop_using_landmarks(img, lm)) <= 1
    assert crop_using_landmarks(images[0], np.full((68, 2), 50.0, np.float32)) is None


def test_crop_using_landmarks_batch_matches_jax(crop_inputs):
    """In-frame and out-of-frame boxes of one frame shape, and a
    degenerate set of landmarks."""
    images, lms = crop_inputs
    frames = [images[1]] * 4 + [images[0]]
    pts = np.stack(lms + [np.full((68, 2), 50.0, np.float32)])
    got, ok = crop_using_landmarks_batch(frames, pts)
    want, ok_w = j_cropping.crop_using_landmarks_batch(frames, pts)
    np.testing.assert_array_equal(ok, ok_w)
    assert ok.tolist() == [True] * 4 + [False]
    assert max_diff(got, want) <= 1


@pytest.mark.parametrize("width", [200, 100])
def test_resize_width_matches_jax(width):
    img = patch_frame(128, 160, 40, 50, 40, 0)
    got = resize_width(img, width)
    assert got.shape == (int(128 * width / 160), width, 3)
    np.testing.assert_array_equal(got, j_resize_width(img, width))
    assert resize_width(img, 160) is img


@pytest.fixture(scope="module")
def nets():
    """(JAX S3FD, JAX FAN, port S3FD, port FAN) of ``tests/torch_cli_files.py``."""
    m = seeded_modules()
    return (to_np(convert_s3fd(m["sfd"].state_dict())),
            to_np(convert_fan(m["fan"].state_dict(), num_modules=FAN_MODULES)),
            m["sfd"], m["fan"])


@pytest.fixture(scope="module")
def frames():
    """Two frame shapes; frame 2's patch is in the corner, so its FFHQ box
    leaves the frame."""
    return [patch_frame(128, 160, 60, 50, 40, 0), patch_frame(120, 176, 56, 70, 40, 1),
            patch_frame(128, 160, 0, 0, 40, 3), patch_frame(128, 160, 64, 40, 40, 2)]


def _check(got, want, landmarks):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any() and got[0].shape == (len(got[1]), 256, 256, 3)
    assert np.abs(got[0] - np.asarray(want[0])).max() <= ONE
    if landmarks:
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("device_crop", [True, False])
def test_preprocess_images_matches_jax(nets, frames, device_crop):
    js, jf, ps, pf = nets
    kw = dict(device_crop=device_crop, return_landmarks=True, detect_width=200)
    want = j_preprocess_images(js, jf, frames, **kw)
    with torch.no_grad():
        got = preprocess_images(ps, pf, frames, device="cpu", **kw)
    _check(got, want, landmarks=True)


def test_make_prep_fn_matches_jax(nets, frames):
    """``skip_preprocess`` (a bilinear resize of ready crops), and the
    SFD → FAN → FFHQ crop chain at a detection width."""
    js, jf, ps, pf = nets
    crops = list(np.random.RandomState(4).randint(0, 256, (2, 200, 200, 3)).astype(np.uint8))
    got = make_prep_fn(None, None, skip_preprocess=True, device="cpu")(crops)
    want = j_make_prep_fn(None, None, skip_preprocess=True)(crops)
    _check(got, want, landmarks=False)
    assert got[1].all()
    with pytest.raises(ValueError):
        make_prep_fn(ps, pf, skip_preprocess=True, return_landmarks=True)
    got = make_prep_fn(ps, pf, detect_width=200, device="cpu")(frames[:1] + frames[2:])
    want = j_make_prep_fn(js, jf, detect_width=200)(frames[:1] + frames[2:])
    _check(got, want, landmarks=False)


def test_video_round_trip(tmp_path):
    """``generate_video`` → ``extract_frames`` / ``video_fps`` through
    OpenCV: every frame comes back at its shape, the last one twice, within
    the codec's loss (mean |diff| under 6 units on smooth frames), every
    second one with ``stride`` 2; the rate the one written; the JAX
    package's native reader, where it is built, decodes the same frames."""
    yy, xx = np.mgrid[:64, :96]
    frames = [np.stack([(xx * 2 + 5 * i) % 256, yy * 3, (xx + yy + 7 * i) % 256],
                       -1).astype(np.uint8) for i in range(40)]
    path = str(tmp_path / "v.mp4")
    generate_video(frames, path, fps=25)
    assert video_fps(path) == 25.0
    back = extract_frames(path)
    assert len(back) == len(frames) + 1 and back[0].shape == (64, 96, 3)
    for got, want in zip(back, frames + frames[-1:]):
        assert np.abs(got.astype(int) - want.astype(int)).mean() < 6
    assert len(extract_frames(path, stride=2)) == (len(back) + 1) // 2
    assert len(extract_frames(path, get_only_first=True)) == 1
    if j_imgproc.native_available():
        np.testing.assert_array_equal(np.stack(back), np.stack(j_imgproc.extract_frames(path)))


@pytest.mark.parametrize("size", [64, 128])
def test_grid_matches_jax(size):
    """[source | target | reenacted] rows of 256² cells with the frames of a
    smaller generator, which the grid upsamples: the JAX package's host
    grid (Pillow), and for the reenacted cell its device grid's resize."""
    rs = np.random.RandomState(size)
    src, tgt = (rs.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32) for _ in range(2))
    reen = rs.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    got = generate_grid_image(src, tgt, reen)
    assert got.dtype == np.uint8 and got.shape == (512, 768, 3)
    assert max_diff(got, j_generate_grid_image(src, tgt, reen)) <= 1
    cells = np.clip(np.round(np.asarray(jax.image.resize(
        np.stack([tensor_to_image(r) for r in reen]).astype(np.float32), (2, 256, 256, 3),
        "bilinear"))), 0, 255)
    assert max_diff(got[:, 512:], np.concatenate(list(cells), axis=0)) <= 1


def test_prep_runs_on_the_card_by_default(nets, frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prep_fn(nets[2], nets[3], detect_width=200)(frames[:1])
