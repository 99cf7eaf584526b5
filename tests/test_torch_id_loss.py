"""The port's ArcFace backbone and identity loss (``models/irse.py::
Backbone, backbone_forward``, ``losses/id_loss.py``) against the JAX
package on the CPU.

A seeded port backbone (``tests/torch_face_zoo.py::damped_backbone``:
random batch-norm statistics, so the folds are exercised, and each IR-SE
block's last batch norm × 0.3, since the random body otherwise grows the
activations about 18,000-fold) goes through the JAX package's own converter
(``convert_irse_backbone``) and back into the port. Inputs are made with
numpy from a seed: 112² faces for the backbone, 256² images for the loss.

Tolerances: embeddings rtol 1e-4, atol 1e-5; the loss and CSIM rtol 1e-4;
the loss's image gradient rtol 1e-3, atol 1e-3·max|gradient|.
"""

import jax
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.losses.id_loss import (
    csim as j_csim, extract_id_feats as j_feats, id_loss as j_id_loss)
from stylegan_directions_face_reenactment_tpu.models.irse import (
    backbone_forward as j_backbone_forward)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_irse_backbone)

from stylegan_directions_face_reenactment_tpu_torch.losses import csim, extract_id_feats, id_loss
from stylegan_directions_face_reenactment_tpu_torch.models.irse import backbone_forward
from stylegan_directions_face_reenactment_tpu_torch.weights import id_backbone_from_jax

from torch_face_zoo import damped_backbone, statics_jit, to_np
from torch_threads import _threads  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    m = damped_backbone(0)
    j = to_np(convert_irse_backbone(m.state_dict()))
    return m, j, id_backbone_from_jax(j, device="cpu")


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(4)
    return [rs.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32) for _ in range(2)]


def t(a):
    return torch.from_numpy(np.array(a))


def test_state_dict_round_trips(pair):
    """The port's keys are the reference's: they go through the JAX
    converter and come back equal, and ``output_layer.4`` has no affine
    terms."""
    m, _, back = pair
    sd, sd_back = m.state_dict(), back.state_dict()
    assert set(sd) == set(sd_back)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd_back[k]), k
    assert "output_layer.4.weight" not in sd and "output_layer.3.weight" in sd
    assert tuple(sd["output_layer.3.weight"].shape) == (512, 512 * 7 * 7)


def test_backbone_forward_matches_jax(pair):
    _, j, port = pair
    x = np.random.RandomState(1).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    want = np.asarray(statics_jit(j_backbone_forward, j)(x))
    with torch.no_grad():
        got = backbone_forward(port, t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_id_feats_loss_and_csim_match_jax(pair, images):
    """The crop [35:223, 32:220] pooled to 112, the embedding, the loss and
    CSIM; y's features are constants in both (the gradient reaches y_hat
    alone)."""
    _, j, port = pair
    yh, y = images
    want_feats = np.asarray(statics_jit(j_feats, j)(yh))
    want, want_grad = statics_jit(
        lambda p, a, b: jax.value_and_grad(lambda a: j_id_loss(p, a, b))(a), j)(yh, y)
    want_csim = float(statics_jit(j_csim, j)(yh, y))
    yh_t, y_t = t(yh).requires_grad_(), t(y).requires_grad_()
    with torch.no_grad():
        np.testing.assert_allclose(extract_id_feats(port, t(yh)).numpy(), want_feats,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(csim(port, t(yh), t(y))), want_csim, rtol=1e-4)
    got = id_loss(port, yh_t, y_t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(yh_t.grad.numpy(), want_grad, rtol=1e-3,
                               atol=1e-3 * np.abs(want_grad).max())
    assert y_t.grad is None
    with torch.no_grad():
        assert float(id_loss(port, t(y), t(y))) == pytest.approx(0.0, abs=1e-5)
