"""The port's S3FD detector against the JAX package on the CPU.

Weights: the port's seeded init through ``convert_s3fd`` and back
(``tests/torch_face_zoo.py``); a "boosted" copy biases one confidence head
so that every one of its anchors scores exactly 1.0, which makes the
ranking of the candidates a matter of tie order alone. Inputs are made
with numpy from a seed.

Tolerances: head maps rtol 1e-3, atol 1e-4·max|map| (19 convolutions summed
in another order); anchors exact; decoded boxes rtol 1e-6, atol 1e-4 (the
same f32 formula); candidate scores atol 1e-5; NMS on given candidates
exact; detections of the boosted net: the same candidates in the same
order (exact flags, boxes atol 1e-3 px), which holds only with a stable
sort.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models.face.s3fd import (
    decode_boxes as j_decode_boxes, dense_anchors as j_dense_anchors,
    detect_candidates as j_detect_candidates, detect_faces as j_detect_faces,
    nms_fixed as j_nms_fixed, s3fd_forward as j_s3fd_forward)

from stylegan_directions_face_reenactment_tpu_torch.models.face.s3fd import (
    decode_boxes, dense_anchors, detect_candidates, detect_faces, nms_fixed,
    s3fd_forward)

from torch_face_zoo import s3fd_pair, statics_jit
from torch_threads import _threads  # noqa: F401

BOOST = "conv4_3_norm_mbox_conf"


@pytest.fixture(scope="module")
def nets():
    return s3fd_pair(seed=11)


def test_s3fd_forward_odd_non_square(nets):
    """70×134: the pools floor 70 → 35 → 17 → 8 → 4 → 2 and 134 → 67 → 33 →
    16 → 8 → 4; fc6 pads by 3 without dilation, so the last maps are 2×2."""
    jp, pp = nets
    x = np.random.RandomState(1).uniform(-120, 140, (2, 70, 134, 3)).astype(np.float32)
    want = statics_jit(j_s3fd_forward, jp)(jnp.asarray(x))
    with torch.no_grad():
        got = s3fd_forward(pp, torch.from_numpy(x))
    assert len(got) == 12
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max())
    assert got[0].shape == (2, 17, 33, 2) and got[10].shape == (2, 2, 2, 2)


@pytest.mark.parametrize("h,w,stride", [(17, 33, 4), (2, 4, 32), (1, 1, 128)])
def test_anchors_and_decode(h, w, stride):
    want = j_dense_anchors(h, w, stride)
    got = dense_anchors(h, w, stride)
    np.testing.assert_array_equal(got.numpy(), want)
    assert dense_anchors(h, w, stride) is got          # built once a shape
    loc = np.random.RandomState(2).randn(2, h * w, 4).astype(np.float32)
    want_b = np.asarray(j_decode_boxes(jnp.asarray(loc), jnp.asarray(want)[None]))
    got_b = decode_boxes(torch.from_numpy(loc), got[None]).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("subtract_mean", [False, True])
def test_detect_candidates_matches_jax(nets, subtract_mean):
    jp, pp = nets
    x = np.random.RandomState(3).uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(statics_jit(
        lambda p, im: j_detect_candidates(p, im, subtract_mean=subtract_mean), jp)(
            jnp.asarray(x)))
    with torch.no_grad():
        got = detect_candidates(pp, torch.from_numpy(x), subtract_mean=subtract_mean).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-4, atol=1e-3)


def _tied_dets(rs, n=120):
    """Candidates with heavy ties: ten scores shared by many boxes, a block
    of exact zeros, and clusters of overlapping boxes."""
    xy = rs.uniform(0, 200, (n, 2)).astype(np.float32)
    xy[: n // 2] = np.repeat(xy[: n // 8], 4, axis=0) + rs.uniform(0, 6, (n // 2, 2))
    wh = rs.uniform(10, 40, (n, 2)).astype(np.float32)
    score = rs.choice(np.float32([0.3, 0.6, 0.7, 0.7, 0.9, 0.95, 0.999, 0.999, 1.0, 1.0]), n)
    score[rs.rand(n) < 0.3] = 0.0
    return np.concatenate([xy, xy + wh, score[:, None]], axis=1).astype(np.float32)


@pytest.mark.parametrize("top_k", [32, 200])
def test_nms_fixed_with_ties(top_k):
    rs = np.random.RandomState(4)
    dets = np.stack([_tied_dets(rs), _tied_dets(rs)])
    for b in range(2):
        want_d, want_k = j_nms_fixed(jnp.asarray(dets[b]), top_k=top_k)
        got_d, got_k = nms_fixed(torch.from_numpy(dets[b]), top_k=top_k)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    # the batched call gives each image its own result
    got_d, got_k = nms_fixed(torch.from_numpy(dets), top_k=top_k)
    want_d, want_k = jax.vmap(lambda d: j_nms_fixed(d, top_k=top_k))(jnp.asarray(dets))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    assert got_k.any() and not got_k.all()


def test_detect_faces_tied_scores():
    """Every anchor of the stride-8 head scores 1.0, so the 32 candidates
    are the first 32 of those anchors in anchor order, and NMS runs on
    them; an unstable sort would pick others."""
    jp, pp = s3fd_pair(seed=12, boost_head=BOOST)
    x = np.random.RandomState(5).uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    want_b, want_v = statics_jit(lambda p, im: j_detect_faces(p, im), jp)(jnp.asarray(x))
    with torch.no_grad():
        got_b, got_v = detect_faces(pp, torch.from_numpy(x))
        cands = detect_candidates(pp, torch.from_numpy(x))
    want_b, want_v = np.asarray(want_b), np.asarray(want_v)
    assert got_b.shape == (2, 32, 5)
    np.testing.assert_array_equal(got_b[..., 4].numpy(), want_b[..., 4])
    assert (got_b[..., 4] == 1.0).all()
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_allclose(got_b[..., :4].numpy(), want_b[..., :4], rtol=0, atol=1e-3)
    # the candidates kept are the stride-8 anchors in index order
    n4 = (96 // 4) * (128 // 4)
    first = cands[:, n4:n4 + 32, :4]
    torch.testing.assert_close(got_b[:, :, :4], first, rtol=0, atol=0)
    assert got_v.any() and not got_v.all()
