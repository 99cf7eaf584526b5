"""The shared set-up of the port's whole-path tests against the JAX package:
a random-init 64² generator (channel multiplier 1), A (15 → 8·512), the
DECA ResNet-50 encoder, a 2-module FAN and the boosted S3FD of
``tests/torch_face_zoo.py`` (every face passes the 0.99 gate, so the
landmark-driven crops and the kpt68 warp run), in both packages, with T = 2
raw 256² frames made with numpy from a seed (the shapes of
``tests/test_fused_reenact.py``)."""

import jax
import jax.numpy as jnp
import numpy as np

from stylegan_directions_face_reenactment_tpu.models.direction_matrix import (
    init_direction_matrix)
from stylegan_directions_face_reenactment_tpu.models.stylegan2 import (
    mapping as j_mapping, n_latent_for)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_resnet_encoder, convert_stylegan2_generator)

from stylegan_directions_face_reenactment_tpu_torch.weights import (
    deca_from_jax, direction_matrix_from_jax, generator_from_jax, init_deca,
    init_generator)

from torch_face_zoo import fan_pair, s3fd_pair, to_np

SIZE = 64
T = 2
BOOST = "conv5_3_norm_mbox_conf"


def build_world():
    sd = {k: (v[None] if k.endswith("conv.weight") else v) for k, v in
          init_generator(1, size=SIZE, channel_multiplier=1, device="cpu")
          .state_dict().items()}
    g = to_np(convert_stylegan2_generator(sd, size=SIZE, channel_multiplier=1))
    deca = {"e_flame": to_np(convert_resnet_encoder(
        init_deca(2, device="cpu").E_flame.state_dict()))}
    a = to_np(init_direction_matrix(jax.random.PRNGKey(3), 512, 15, w_plus=True,
                                    num_layers=8))
    jf, pf = fan_pair(seed=31, num_modules=2)
    js, ps = s3fd_pair(seed=32, boost_head=BOOST)
    rs = np.random.RandomState(0)
    z = rs.randn(32, 512).astype(np.float32)
    trunc = np.array(j_mapping(g, jnp.asarray(z)).mean(axis=0, keepdims=True))
    code = rs.randn(1, n_latent_for(SIZE), 512).astype(np.float32)
    ps_src = {"pose": (0.1 * rs.randn(1, 6)).astype(np.float32),
              "alpha_shp": rs.randn(1, 100).astype(np.float32),
              "alpha_exp": rs.randn(1, 50).astype(np.float32),
              "cam": rs.randn(1, 3).astype(np.float32)}
    ang = np.float32([[5.0, -10.0, 2.0]])
    frames = rs.randint(0, 256, (T, 256, 256, 3)).astype(np.uint8)
    port = (generator_from_jax(g, device="cpu"), direction_matrix_from_jax(a, device="cpu"),
            deca_from_jax(deca, device="cpu"), pf, ps)
    return dict(jax=(g, a, deca, jf, js), port=port, trunc=trunc, code=code,
                ps=ps_src, ang=ang, frames=frames)


def close_scaled(got, want, rtol, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())
