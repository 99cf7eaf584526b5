"""Where the port's DECA alignment stops gradients, against the JAX
package's ``stop_gradient``s (``pipeline/alignment.py``,
``models/face/landmarks.py::estimate_landmarks``).

The gradient of a fixed random projection of the aligned 224 crop with
respect to the images: ``loss.backward()`` through the port's aligner
against ``jax.grad`` of the JAX package's, for ``landmark_align``,
``make_fan_align`` with S3FD (the boosted net of ``tests/torch_face_zoo.py``,
so every face passes the gate and the kpt68 warp runs) and without it
("fan_frame"). Only the warp carries a gradient; detection, FAN and the
landmarks are constants to autograd, so no S3FD or FAN parameter gets a
``.grad`` and the landmarks none either. ``estimate_landmarks`` alone, on
frames that need a gradient: its heatmaps carry one through FAN's crops,
in float64 on both sides, while S3FD's input and the box stay stopped.

Tolerance: rtol 1e-3, atol 2e-3·max|gradient| (the warp's weights come
from landmarks that agree to float32 rounding).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.pipeline.alignment import (
    landmark_align as j_landmark_align, make_fan_align as j_make_fan_align)

from stylegan_directions_face_reenactment_tpu_torch.models.face.landmarks import (
    estimate_landmarks)
from stylegan_directions_face_reenactment_tpu_torch.pipeline.alignment import (
    DECA_CROP, landmark_align, make_fan_align)

from torch_face_zoo import fan_pair, s3fd_pair, statics_jit

BOOST = "conv5_3_norm_mbox_conf"
RTOL, ATOL_REL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def nets():
    return {"fan": fan_pair(seed=41, num_modules=1),
            "sfd": s3fd_pair(seed=42, boost_head=BOOST)}


def _inputs(seed, n=2, hw=128):
    rs = np.random.RandomState(seed)
    imgs = rs.rand(n, hw, hw, 3).astype(np.float32)
    proj = rs.randn(n, DECA_CROP, DECA_CROP, 3).astype(np.float32)
    return imgs, proj


def _check(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * np.abs(want).max())


def _port_grad(align, imgs, proj, *extra):
    x = torch.from_numpy(imgs).requires_grad_()
    out = align(x, *extra)
    aligned = out[0] if isinstance(out, tuple) else out
    (aligned * torch.from_numpy(proj)).sum().backward()
    return x.grad.numpy()


@pytest.mark.parametrize("mode", ["sfd", "fan_frame"])
def test_make_fan_align_gradient_matches_jax(nets, mode):
    jf, pf = nets["fan"]
    js, ps = nets["sfd"] if mode == "sfd" else (None, None)
    imgs, proj = _inputs(3 if mode == "sfd" else 4)

    def jax_grad(f, s, im, w):
        return jax.grad(lambda x: jnp.sum(j_make_fan_align(f, s)(x) * w))(im)

    want = statics_jit(jax_grad, jf, js)(jnp.asarray(imgs), jnp.asarray(proj))
    got = _port_grad(make_fan_align(pf, ps), imgs, proj)
    _check(got, want)
    for net in (pf, ps):
        if net is not None:
            assert all(p.grad is None for p in net.parameters())


def test_landmark_align_gradient_matches_jax():
    imgs, proj = _inputs(5)
    rs = np.random.RandomState(6)
    lms = (40 + 48 * rs.rand(2, 68, 2)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(j_landmark_align(x, jnp.asarray(lms))[0]
                                      * jnp.asarray(proj)))(jnp.asarray(imgs))
    lms_t = torch.from_numpy(lms).requires_grad_()
    got = _port_grad(landmark_align, imgs, proj, lms_t)
    _check(got, want)
    assert lms_t.grad is None


def test_detection_with_grad_after_inference_mode(nets):
    """A frame size first detected under ``torch.inference_mode()`` (the
    serving paths) and then with grad on: S3FD's cached anchors must not be
    inference tensors, or autograd cannot use them. The gradient reaches
    the frame through FAN's crops."""
    _, ps = nets["sfd"]
    _, pf = nets["fan"]
    frame = 255 * np.random.RandomState(8).rand(1, 184, 216, 3).astype(np.float32)
    with torch.inference_mode():
        estimate_landmarks(ps, pf, torch.from_numpy(frame))
    x = torch.from_numpy(frame).requires_grad_()
    estimate_landmarks(ps, pf, x)[2].sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().max()) > 0


def test_estimate_landmarks_gradient_matches_jax(nets, monkeypatch):
    """``estimate_landmarks`` straight on frames that need a gradient: the
    gradient of a projection of its heatmaps and landmarks with respect to
    the frames against ``jax.grad`` of the JAX package's. The heatmaps
    carry one through FAN's crops (not stopped, as in the JAX package); the
    landmarks a zero one (the peaks and the truncation are flat). S3FD sees
    a detached input (``det_in``), and with the box stopped its weights get
    no ``.grad``; FAN's weights get theirs.

    Both sides run S3FD and FAN in float64 (``compute_dtype``): in float32
    one ReLU input that rounds to the other side of 0 moves this gradient
    of the random FAN by up to percents of its max, in either package
    (``chip_smoke.py::grad_witness`` reads such float32 paths against
    float64); in float64 no rounding flips one."""
    from stylegan_directions_face_reenactment_tpu.models.face.landmarks import (
        estimate_landmarks as j_estimate_landmarks)
    from stylegan_directions_face_reenactment_tpu_torch.models.face import landmarks
    (jf, pf), (js, ps) = nets["fan"], nets["sfd"]
    pf, ps = copy.deepcopy(pf).double(), copy.deepcopy(ps).double()
    rs = np.random.RandomState(9)
    imgs = 255 * rs.rand(2, 128, 128, 3)
    hproj, lproj = rs.randn(2, 64, 64, 68), rs.randn(2, 68, 2)

    def jax_grad(s, f, im, hw, lw):
        def loss(x):
            lms, _, heat = j_estimate_landmarks(s, f, x, compute_dtype=jnp.float64,
                                                detector_input="fa")
            return jnp.sum(heat * hw) + jnp.sum(lms * lw)
        return jax.grad(loss)(im)

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: a.astype(np.float64) if getattr(a, "dtype", None) == np.float32 else a,
            tree)

    with jax.enable_x64(True):
        want = statics_jit(jax_grad, f64(js), f64(jf))(*map(jnp.asarray, (imgs, hproj, lproj)))
        want = np.asarray(want)
    assert want.dtype == np.float64
    seen = []
    detect = landmarks.detect_faces
    monkeypatch.setattr(landmarks, "detect_faces",
                        lambda s, x, **kw: (seen.append(x.requires_grad), detect(s, x, **kw))[1])
    x = torch.from_numpy(imgs).requires_grad_()
    lms, ok, heat = estimate_landmarks(ps, pf, x, compute_dtype=torch.float64,
                                       detector_input="fa")
    assert bool(ok.all()) and seen == [False]
    ((heat * torch.from_numpy(hproj)).sum() + (lms * torch.from_numpy(lproj)).sum()).backward()
    _check(x.grad.numpy(), want)
    assert all(p.grad is None for p in ps.parameters())
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0 for p in pf.parameters())
