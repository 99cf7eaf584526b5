"""The port's LPIPS (AlexNet, v0.1 heads) against the JAX package on the
CPU, as ``tests/test_losses.py`` holds the JAX package against torch.

A seeded port LPIPS goes through the JAX package's own converter
(``convert_lpips_alex``, two state dicts: AlexNet's ``features`` and the
``lin`` heads) and back into the port (``lpips_from_jax``). Inputs are
64² images in [-1, 1] made with numpy from a seed.

Tolerances: the value rtol 1e-5 (read 2e-7); the input gradient rtol 1e-4,
atol 1e-5·max|gradient| (read 3e-6·max).
"""

import numpy as np
import jax
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.losses.lpips import (
    convert_lpips_alex, lpips as j_lpips)

from stylegan_directions_face_reenactment_tpu_torch.losses import lpips
from stylegan_directions_face_reenactment_tpu_torch.weights import init_lpips, lpips_from_jax

from torch_face_zoo import to_np
from torch_threads import _threads  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    lp = init_lpips(0, device="cpu")
    j = to_np(convert_lpips_alex(lp.net.layers.state_dict(), lp.lin.state_dict()))
    return lp, j, lpips_from_jax(j, device="cpu")


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(3)
    return [rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2)]


def test_state_dicts_round_trip(pair):
    lp, _, back = pair
    for k, v in lp.state_dict().items():
        assert torch.equal(v, back.state_dict()[k]), k
    assert set(lp.net.layers.state_dict()) == {f"{i}.{n}" for i in (0, 3, 6, 8, 10)
                                               for n in ("weight", "bias")}
    assert set(lp.lin.state_dict()) == {f"{i}.1.weight" for i in range(5)}


def test_lpips_and_its_gradient_match_jax(pair, images):
    _, j, port = pair
    x, y = images
    want, want_grad = jax.jit(jax.value_and_grad(lambda a, b: j_lpips(j, a, b)))(x, y)
    xt = torch.from_numpy(x).requires_grad_()
    got = lpips(port, xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-5 * np.abs(want_grad).max())


def test_lpips_zero_for_identical_and_frozen(pair, images):
    """The distance of an image to itself is 0, and the net's parameters
    are frozen: a backward reaches the image only."""
    _, _, port = pair
    x = torch.from_numpy(images[0][:1]).requires_grad_()
    assert abs(float(lpips(port, x.detach(), x.detach()))) < 1e-6
    assert not any(p.requires_grad for p in port.parameters())
    lpips(port, x, torch.from_numpy(images[1][:1])).backward()
    assert x.grad is not None and all(p.grad is None for p in port.parameters())
