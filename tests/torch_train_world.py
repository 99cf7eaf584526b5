"""The shared set-up of the port's training tests against the JAX package:
a seeded 64² generator (channel multiplier 1), the DECA ResNet-50 encoder
(its output head damped, ``DECA_HEAD_SCALE``) with a small synthetic FLAME
(128 vertices, 200 faces), the damped ArcFace
backbone of ``torch_face_zoo.damped_backbone``, LPIPS and a 2-module FAN,
each made by the port, carried through the JAX package's converters, and
back into the port with ``weights/from_jax.py``; the truncation latent is
the mean mapped W of 32 z's made with numpy. ``world["jax"]`` and
``world["port"]`` are the two packages' ``FrozenModels``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stylegan_directions_face_reenactment_tpu.losses.lpips import convert_lpips_alex
from stylegan_directions_face_reenactment_tpu.models.deca import flame as jflame
from stylegan_directions_face_reenactment_tpu.models.stylegan2 import mapping as j_mapping
from stylegan_directions_face_reenactment_tpu.train import FrozenModels as JFrozenModels
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_irse_backbone, convert_resnet_encoder, convert_stylegan2_generator)

from stylegan_directions_face_reenactment_tpu_torch.train import FrozenModels
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    deca_from_jax, generator_from_jax, id_backbone_from_jax, init_deca, init_generator,
    init_lpips, lpips_from_jax)

from torch_face_zoo import damped_backbone, fan_pair, to_np

SIZE = 64
N_LAT = 10   # n_latent of a 64² generator
# DECA's last Linear × 0.1. The random-init head regresses poses up to 6.5
# rad and expressions up to 9 (a trained DECA's: about ±0.3 rad and ±2);
# there float32 rounding through FLAME, the ResNet-50 and the synthesis
# reaches A's gradient at 1e-3 of its max in both packages alike (the real
# step read 271 of 61440 entries past rtol 1e-3, atol 1e-3·max). Scaled,
# the coefficients stay within ±0.9.
DECA_HEAD_SCALE = 0.1


# DECA's input side on the resize alignment: the JAX package's knob for small
# runs (`TrainingArguments.deca_image_size`); the fan alignments warp to 224
DECA_SIZE = 64


def jax_flame(seed=3):
    make = functools.partial(jflame.synthetic_flame_params, n_verts=128, n_faces=200)
    return to_np(jax.jit(make)(jax.random.PRNGKey(seed)))


def build_train_world():
    sd = {k: (v[None] if k.endswith("conv.weight") else v) for k, v in
          init_generator(1, size=SIZE, channel_multiplier=1, device="cpu")
          .state_dict().items()}
    g = to_np(convert_stylegan2_generator(sd, size=SIZE, channel_multiplier=1))
    deca = {"e_flame": to_np(convert_resnet_encoder(
        init_deca(2, device="cpu").E_flame.state_dict())), "flame": jax_flame()}
    deca["e_flame"]["fc2"]["weight"] = deca["e_flame"]["fc2"]["weight"] * DECA_HEAD_SCALE
    idb = to_np(convert_irse_backbone(damped_backbone(4).state_dict()))
    lp_port = init_lpips(5, device="cpu")
    lp = to_np(convert_lpips_alex(lp_port.net.layers.state_dict(), lp_port.lin.state_dict()))
    jfan, pfan = fan_pair(seed=31, num_modules=2)
    z = np.random.RandomState(6).randn(32, 512).astype(np.float32)
    trunc = np.array(j_mapping(g, jnp.asarray(z)).mean(axis=0, keepdims=True))
    jm = JFrozenModels(g, deca, idb, lp, trunc, jfan, None)
    pm = FrozenModels(generator_from_jax(g, device="cpu"), deca_from_jax(deca, device="cpu"),
                      id_backbone_from_jax(idb, device="cpu"), lpips_from_jax(lp, device="cpu"),
                      torch.from_numpy(trunc), pfan, None)
    return {"jax": jm, "port": pm}


def t(a):
    return torch.from_numpy(np.array(a))


def close_scaled(got, want, rtol, atol_rel):
    """|got − want| ≤ atol_rel·max|want| + rtol·|want| everywhere."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())
