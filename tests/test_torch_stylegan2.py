"""The port's StyleGAN2 generator against the JAX package's on the CPU.

One random-init JAX generator (64², channel multiplier 1, 8 mapping
layers), with noise weights and activation biases set non-zero so that
every term is exercised, goes across with ``weights/from_jax.py``; inputs
are made with numpy from a seed and fed to both.

Tolerances: images rtol 1e-3, atol 2e-4 and latents rtol 1e-4, atol 1e-5,
the bounds the repo's torch-vs-JAX generator parity tests use: float32
sums over 512-channel convolutions taken in another order.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models.stylegan2 import (
    init_generator as j_init_generator, generator_forward as j_generator_forward,
    mapping as j_mapping)
from stylegan_directions_face_reenactment_tpu.pipeline.synthesis import (
    generate_image as j_generate_image,
    get_shifted_latent_code as j_get_shifted_latent_code)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_stylegan2_generator)

from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
    generator_forward, mapping, mean_latent, n_latent_for, channel_map)
from stylegan_directions_face_reenactment_tpu_torch.pipeline.synthesis import (
    generate_image, get_shifted_latent_code)
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    generator_from_jax, init_generator)
from torch_threads import _threads  # noqa: F401

SIZE = 64


def to_np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


@pytest.fixture(scope="module")
def gens():
    p = to_np(j_init_generator(jax.random.PRNGKey(0), size=SIZE,
                               channel_multiplier=1))
    rs = np.random.RandomState(0)
    for c in [p["conv1"]] + p["convs"]:
        c["noise_weight"] = np.float32(rs.randn() * 0.5)
        c["act_bias"] = (rs.randn(*c["act_bias"].shape) * 0.1).astype(np.float32)
    for r in [p["to_rgb1"]] + p["to_rgbs"]:
        r["bias"] = (rs.randn(3) * 0.1).astype(np.float32)
    return p, generator_from_jax(p, device="cpu")


@pytest.fixture(scope="module")
def trunc(gens):
    p, g = gens
    z = np.random.RandomState(11).randn(64, 512).astype(np.float32)
    want = j_mapping(p, jnp.asarray(z)).mean(axis=0, keepdims=True)
    with torch.no_grad():
        got = mapping(g, torch.from_numpy(z)).mean(dim=0, keepdim=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    return want, got


@pytest.mark.parametrize("n_styles,inject_index", [(1, None), (2, 3)])
def test_generator_forward_z_matches_jax(gens, n_styles, inject_index):
    """z → mapping → W+ (one style, or two mixed at inject_index) →
    synthesis with the fixed noise buffers."""
    p, g = gens
    rs = np.random.RandomState(21)
    zs = [rs.randn(2, 512).astype(np.float32) for _ in range(n_styles)]
    want_img, want_lat = j_generator_forward(p, [jnp.asarray(z) for z in zs],
                                             inject_index=inject_index,
                                             return_latents=True)
    with torch.no_grad():
        img, lat = generator_forward(g, [torch.from_numpy(z) for z in zs],
                                     inject_index=inject_index, return_latents=True)
    assert img.shape == (2, SIZE, SIZE, 3) and lat.shape == (2, n_latent_for(SIZE), 512)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_shift_and_truncation_match_jax(gens, trunc, backend):
    """W+ code + direction shift on the first 8 rows, truncation ψ=0.7 on
    the shifted code; the JAX side with its XLA or its Pallas (interpreted)
    resampling."""
    p, g = gens
    t_jax, t_torch = trunc
    rs = np.random.RandomState(22)
    code = rs.randn(1, n_latent_for(SIZE), 512).astype(np.float32)
    codes = np.repeat(code, 2, axis=0)
    shift = (rs.randn(2, 8, 512) * 0.3).astype(np.float32)
    j_up = importlib.import_module(
        "stylegan_directions_face_reenactment_tpu.ops.upfirdn2d")
    saved = j_up._RESAMPLE_BACKEND
    try:
        j_up.set_resample_backend(backend)
        want_img, want_lat = j_generate_image(
            p, jnp.asarray(codes), truncation=0.7, truncation_latent=t_jax,
            shift_code=jnp.asarray(shift), input_is_latent=True,
            return_latents=True)
    finally:
        j_up.set_resample_backend(saved)
    with torch.no_grad():
        img, lat = generate_image(
            g, torch.from_numpy(codes), truncation=0.7,
            truncation_latent=t_torch, shift_code=torch.from_numpy(shift),
            input_is_latent=True, return_latents=True)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("w_plus,num_layers", [(True, None), (False, None), (False, 3)])
def test_get_shifted_latent_code_matches_jax(gens, w_plus, num_layers):
    p, g = gens
    rs = np.random.RandomState(23)
    z = rs.randn(2, 512).astype(np.float32)
    shift = rs.randn(*((2, 8, 512) if w_plus else (2, 512))).astype(np.float32)
    want = j_get_shifted_latent_code(p, jnp.asarray(z), jnp.asarray(shift),
                                     w_plus=w_plus, num_layers=num_layers)
    with torch.no_grad():
        got = get_shifted_latent_code(g, torch.from_numpy(z), torch.from_numpy(shift),
                                      w_plus=w_plus, num_layers=num_layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_state_dict_keeps_the_reference_key_layout(gens):
    """The port's state_dict, with the reference's leading 1 on modulated
    conv weights, goes through the JAX package's converter for reference
    checkpoints and gives back the pytree it came from."""
    p, g = gens
    sd = {k: (v[None] if k.endswith("conv.weight") else v)
          for k, v in g.state_dict().items()}
    back = to_np(convert_stylegan2_generator(sd, size=SIZE, channel_multiplier=1))
    flat_p = jax.tree_util.tree_leaves_with_path(p)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_p:
        if isinstance(leaf, np.ndarray):
            np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_seeded_init_and_mean_latent():
    g1 = init_generator(3, size=16, channel_multiplier=1, device="cpu")
    g2 = init_generator(3, size=16, channel_multiplier=1, device="cpu")
    for (k, a), (_, b) in zip(g1.state_dict().items(), g2.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert g1.convs[0].conv.weight.shape == (channel_map(1)[8], 512, 3, 3)
    assert float(g1.convs[0].conv.modulation.bias.detach().mean()) == 1.0
    # the reference's init: N(0, 1) / lr_mul for the mapping network
    assert 50 < float(g1.style[1].weight.detach().std()) < 200
    with torch.no_grad():
        m = mean_latent(g1, torch.Generator().manual_seed(0), n_latent=32)
    assert m.shape == (1, 512) and torch.isfinite(m).all()


def mean_rel(got, want):
    """mean |got - want| / mean |want|, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def test_bf16_synthesis_tracks_f32(gens):
    """The bf16 path runs the synthesis in bf16 end to end; it must stay
    near the f32 image. Mean relative drift read 0.0107 at this seed (0.0073
    and 0.0094 at the next two); the limit is twice the largest reading."""
    _, g = gens
    z = torch.from_numpy(np.random.RandomState(24).randn(2, 512).astype(np.float32))
    with torch.no_grad():
        f32, _ = generator_forward(g, [z])
        bf16, _ = generator_forward(g, [z], compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    err = mean_rel(bf16, f32)
    assert err < 0.022, err


@pytest.mark.parametrize("noise_weight_dtype", ["float32", "bfloat16"])
def test_bf16_synthesis_matches_jax(gens, noise_weight_dtype):
    """The port's bf16 synthesis against the JAX package's
    ``generator_forward(compute_dtype=bfloat16)`` on the same weights.

    With float32 noise weights, as the JAX package keeps them, its synthesis
    promotes to f32 at the first noise add; with the noise weights held in
    bf16 (a change to the pytree, not to the package) it stays in bf16 end
    to end, as the port does. Both ways, the two round in other places (K2
    rounds once, the jnp activation three times; the convs accumulate in
    another order), so they are not bit equal:

    - mean relative drift port vs JAX read 0.0083 (float32 noise weights)
      and 0.0085 (bf16); the limit is about twice that, 0.017;
    - in bf16 end to end, the port is as far from the f32 image as the JAX
      package is (ratio read 0.99; limit 1.25).
    """
    p, g = gens
    if noise_weight_dtype == "bfloat16":
        p = dict(p, conv1=dict(p["conv1"]), convs=[dict(c) for c in p["convs"]])
        for c in [p["conv1"]] + p["convs"]:
            c["noise_weight"] = np.asarray(c["noise_weight"], dtype=jnp.bfloat16)
    z = np.random.RandomState(24).randn(2, 512).astype(np.float32)
    want, _ = j_generator_forward(p, [jnp.asarray(z)], compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got, _ = generator_forward(g, [torch.from_numpy(z)], compute_dtype=torch.bfloat16)
    err = mean_rel(got, want)
    assert err < 0.017, err
    if noise_weight_dtype == "bfloat16":
        f32, _ = j_generator_forward(p, [jnp.asarray(z)])
        ratio = mean_rel(got, f32) / mean_rel(want, f32)
        assert ratio < 1.25, ratio
