"""The port's DECA detail branch (``models/deca/deca.py``: ``DetailGenerator``,
``E_detail``, ``deca_encode(..., with_detail=True)``), FLAME's texture space
(``models/deca/flame.py::flametex_forward``,
``weights/flame_loader.py::load_flame_tex``) and their carriage
(``weights/from_jax.py``) against the JAX package on the CPU.

Inputs are made with numpy from seeds. Tolerances: the decoder's
displacements rtol 1e-5, atol 1e-5·max|JAX|; the detail code rtol 1e-3,
atol 1e-3·max, the bound of ``tests/test_torch_deca.py`` (float32 sums over
53 convolutions in another order); textures rtol 1e-5, atol 1e-5·max (a
product over 50 components against JAX's sum); loaders exactly.

The JAX package reads its decoder's linear output as (8, 8, 128),
channel-last, while the reference views it as (128, 8, 8)
(``decoders.py``: ``out.view(B, 128, 8, 8)``), and its converter keeps the
reference's rows: a reference checkpoint through ``convert_deca`` decodes
otherwise in JAX than in the reference. The port computes the reference's
way (its ``D_detail`` is the reference's module, its state dict the
checkpoint's), and ``deca_from_jax`` reorders the JAX rows so that the two
packages compute the same map on the JAX package's parameters. The tests
hold both facts.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.models.deca import deca as jd
from stylegan_directions_face_reenactment_tpu.models.deca import flame as jf
from stylegan_directions_face_reenactment_tpu.weights import flame_loader as j_loader
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import convert_deca

from stylegan_directions_face_reenactment_tpu_torch.models.deca import deca as pd
from stylegan_directions_face_reenactment_tpu_torch.models.deca import flame as pf
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    deca_from_jax, detail_generator_from_jax, init_deca, load_flame_tex)
from stylegan_directions_face_reenactment_tpu_torch.weights.from_jax import detail_l1_from_jax

from torch_face_zoo import to_np
from torch_render_world import jax_detail_params, smooth_texture_space
from torch_threads import _threads  # noqa: F401

B = 2
N_LATENT = pd.N_DETAIL + pd.N_COND


def close(got, want, rtol=1e-5, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


def jit_static_leaves(fn, tree):
    """``fn(tree, *args)`` compiled once, the tree's arrays traced and its
    other leaves (the ResNet blocks' strides) kept static."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    static = {i: v for i, v in enumerate(leaves) if not isinstance(v, np.ndarray)}
    arrays = [v for i, v in enumerate(leaves) if i not in static]

    @jax.jit
    def run(arrays, *args):
        it = iter(arrays)
        full = [static[i] if i in static else next(it) for i in range(len(leaves))]
        return fn(jax.tree_util.tree_unflatten(treedef, full), *args)
    return lambda *args: run(arrays, *args)


def noise(seed):
    return np.random.RandomState(seed).randn(B, N_LATENT).astype(np.float32)


@pytest.fixture(scope="module")
def decoder():
    params = jax_detail_params(np.random.RandomState(0))
    return params, detail_generator_from_jax(params, device="cpu")


def test_detail_generator_matches_jax(decoder):
    params, port = decoder
    z = noise(1)
    want = jax.jit(jd.detail_generator_forward)(params, z)
    got = pd.detail_generator_forward(port, torch.from_numpy(z))
    assert got.shape == (B, 256, 256, 1)
    close(got, want)


def test_detail_generator_is_the_reference_module(decoder):
    """The port's function against its module's own layers run as the
    reference's ``Generator.forward``: l1, view (B, 128, 8, 8), conv_blocks
    (BatchNorm2d(c, 0.8), bilinear ``nn.Upsample``, LeakyReLU, Tanh) at
    their running statistics, × 0.01. Both in float32 against that forward
    in float64: the port (batch norms folded) lies within twice the float32
    module's own distance (unfolded; the decoder's convolutions cancel, so
    either reads some 5e-5 of max)."""
    _, port = decoder
    z = torch.from_numpy(noise(2))

    def reference(m, z):
        with torch.no_grad():
            return (m.conv_blocks(m.l1(z).view(B, 128, 8, 8)) * 0.01).permute(0, 2, 3, 1)

    ref = copy.deepcopy(port).eval()
    exact = reference(copy.deepcopy(ref).double(), z.double()).numpy()
    ref32 = reference(ref, z).numpy()
    got = pd.detail_generator_forward(port, z).detach().numpy()
    limit = max(2 * np.abs(ref32 - exact).max(), 1e-6 * np.abs(exact).max())
    assert np.abs(got - exact).max() <= limit


@pytest.fixture(scope="module")
def seeded():
    """The port's seeded DECA with the detail branch, its state dict in the
    reference's layout, and the JAX bundle ``convert_deca`` makes of it
    (FLAME from the JAX package's synthetic arrays)."""
    deca = init_deca(4, device="cpu", with_detail=True)
    with torch.no_grad():            # statistics away from identity
        rs = torch.Generator().manual_seed(4)
        for m in deca.D_detail.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=rs))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=rs))
    ckpt = {name: {k: v.numpy() for k, v in getattr(deca, name).state_dict().items()}
            for name in ("E_flame", "E_detail", "D_detail")}
    flame = to_np(jax.jit(jf.synthetic_flame_params)(jax.random.PRNGKey(5)))
    return deca, ckpt, to_np(convert_deca(ckpt, flame))


def test_jax_reads_the_reference_rows_otherwise(seeded):
    """A reference-layout ``D_detail`` through ``convert_deca`` decodes in
    JAX as the port does with the linear rows reordered by
    ``detail_l1_from_jax``: the JAX package's layout, not the reference's
    (the port loads the same state dict with a plain ``load_state_dict``
    and computes the reference's map, above)."""
    deca, ckpt, params = seeded
    z = noise(3)
    want = np.asarray(jax.jit(jd.detail_generator_forward)(params["d_detail"], z))
    moved = copy.deepcopy(deca.D_detail)
    with torch.no_grad():
        for k in ("weight", "bias"):
            getattr(moved.l1[0], k).copy_(torch.from_numpy(
                detail_l1_from_jax(ckpt["D_detail"][f"l1.0.{k}"])))
    close(pd.detail_generator_forward(moved, torch.from_numpy(z)), want)
    same = pd.detail_generator_forward(deca.D_detail, torch.from_numpy(z)).detach().numpy()
    assert np.abs(same - want).max() > 1e-2 * np.abs(want).max()


def test_state_dict_round_trips_through_convert_deca(seeded):
    """state dict → ``convert_deca`` → ``deca_from_jax`` → the same state
    dict, but for the decoder's linear rows, which come back reordered
    exactly as the JAX package reads them (above)."""
    deca, ckpt, params = seeded
    back = deca_from_jax(params, device="cpu")
    assert back.E_detail is not None and back.D_detail is not None
    sd, sd_back = deca.state_dict(), back.state_dict()
    assert set(sd) == set(sd_back)
    assert any(k.startswith("E_detail.encoder.layer4") for k in sd)
    assert {k for k in sd if k.startswith("D_detail.") and k.endswith(".weight")} == {
        "D_detail.l1.0.weight"} | {f"D_detail.conv_blocks.{i}.weight"
                                   for i in (0, 2, 3, 6, 7, 10, 11, 14, 15, 18, 19, 21)}
    for k in sd:
        want = sd[k]
        if k.startswith("D_detail.l1.0."):
            want = torch.from_numpy(detail_l1_from_jax(ckpt["D_detail"][k[len("D_detail."):]]))
        assert torch.equal(sd_back[k], want), k


def test_e_detail_encode_matches_jax(seeded):
    deca, _, params = seeded
    images = np.random.RandomState(6).rand(B, 32, 32, 3).astype(np.float32)
    want = jit_static_leaves(jd.resnet_encoder_forward, params["e_detail"])(images)
    port = deca_from_jax(params, device="cpu")
    got = pd.deca_encode(port, torch.from_numpy(images), with_detail=True)
    close(got["detail"], want, rtol=1e-3, atol=1e-3)
    plain = pd.deca_encode(port, torch.from_numpy(images))
    assert "detail" not in plain and set(got) == set(plain) | {"detail"}
    for k in plain:
        assert torch.equal(got[k], plain[k]), k
    # a DECA without the branch returns no detail code even when asked
    assert "detail" not in pd.deca_encode(pd.DECA(), torch.from_numpy(images), with_detail=True)


def test_init_deca_detail_switch():
    """Off by default; on, the encoder's weights stay as they were (the
    branch is drawn after them) and the decoder's batch norms sit at
    identity statistics."""
    plain, full = init_deca(7, device="cpu"), init_deca(7, device="cpu", with_detail=True)
    assert plain.E_detail is None and plain.D_detail is None
    assert all(k.startswith("E_flame.") for k in plain.state_dict())
    for k, v in plain.state_dict().items():
        assert torch.equal(full.state_dict()[k], v), k
    assert float(full.D_detail.conv_blocks[21].weight.detach().abs().max()) > 0
    assert torch.equal(full.D_detail.conv_blocks[3].running_var, torch.ones(128))
    assert full.D_detail.conv_blocks[3].eps == 0.8 and full.D_detail.conv_blocks[0].eps == 1e-5


def test_entry_points_build_deca_without_detail():
    from stylegan_directions_face_reenactment_tpu_torch.cli.model_loading import load_deca
    deca = load_deca(random_init=True, device="cpu")
    assert deca.E_detail is None and deca.D_detail is None and deca.flametex is None
    assert all(k.startswith("E_flame.") for k in deca.state_dict())


def test_flametex_matches_jax():
    tex = smooth_texture_space(np.random.RandomState(8))
    code = np.random.RandomState(9).randn(B, 50).astype(np.float32)
    want = jax.jit(jf.flametex_forward)(tex, code)
    got = pf.flametex_forward(pf.FLAMETex(**tex), torch.from_numpy(code))
    assert got.shape == (B, 256, 256, 3) and got.is_contiguous()
    close(got, want)


@pytest.mark.parametrize("tex_type", ["BFM", "FLAME"])
def test_load_flame_tex_matches_jax(tmp_path, tex_type):
    rs = np.random.RandomState(10)
    path = str(tmp_path / f"{tex_type}.npz")
    if tex_type == "BFM":        # 3-D components: reshaped to the 199 columns
        np.savez(path, MU=rs.rand(30) * 255, PC=rs.randn(10, 3, 199))
    else:                        # a 2-D basis keeps its own width
        np.savez(path, mean=rs.rand(30) * 255, tex_dir=rs.randn(30, 60))
    want = j_loader.load_flame_tex(path, tex_type=tex_type)
    got = load_flame_tex(path, tex_type=tex_type)
    for k in ("texture_mean", "texture_basis"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(want[k]))
    assert got.texture_basis.shape == (30, 50) and got.texture_mean.shape == (1, 30)
    assert load_flame_tex(path, tex_type=tex_type, n_tex=7).texture_basis.shape == (30, 7)
    with pytest.raises(ValueError, match="tex_type"):
        load_flame_tex(path, tex_type="nope")
