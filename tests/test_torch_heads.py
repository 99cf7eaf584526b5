"""The port's model heads off the serving path against the JAX package on
the CPU: the StyleGAN2 discriminator and W+ encoder, the two pSp heads,
FAN's depth net with ``draw_gaussians`` and ``predict_depth``,
``estimate_landmarks_3d`` (with its two gradient stops against
``jax.grad``) and PTI's space regulariser. Each head's weights come from
the JAX package's ``init_*`` pytree (biases and batch-norm statistics
randomized where the init leaves them at zero or identity) through the
port's ``*_from_jax`` converter; inputs are made with numpy from a seed.

Tolerances (max |diff| against atol·max|JAX output| plus rtol·|JAX|):
the discriminator (its ``conv_layer`` and ``res_block`` too) and W+
encoder rtol 1e-4, atol 1e-5·max (equalized
3×3 convs of up to 4608 terms through eight layers); the pSp heads rtol
1e-5, atol 5e-6·max (e4e's bound, ``test_torch_e4e.py``); the depth net
rtol 1e-4, atol 1e-5·max (a bottleneck ResNet on a 71-channel 256² input);
``estimate_landmarks_3d``'s landmarks exactly, its depths rtol 1e-4, atol
1e-5·max; its gradient in float64 on both sides rtol 1e-3, atol
2e-3·max (``test_torch_grad_stops.py``'s bound); the regulariser rtol
1e-5 (one MSE and one LPIPS of two generated images).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.losses.lpips import convert_lpips_alex
from stylegan_directions_face_reenactment_tpu.losses.pti import (
    PTIHyperparams as JPTIHyperparams, space_regularizer_loss as j_space_regularizer_loss)
from stylegan_directions_face_reenactment_tpu.models import e4e as j_e4e
from stylegan_directions_face_reenactment_tpu.models import stylegan2 as j_sg
from stylegan_directions_face_reenactment_tpu.models.face import fan as j_fan
from stylegan_directions_face_reenactment_tpu.models.face.landmarks import (
    estimate_landmarks_3d as j_estimate_landmarks_3d)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_e4e_encoder, convert_stylegan2_generator)

from stylegan_directions_face_reenactment_tpu_torch.losses import pti as pti_mod
from stylegan_directions_face_reenactment_tpu_torch.losses.pti import (
    PTIHyperparams, get_morphed_w_code, space_regularizer_loss)
from stylegan_directions_face_reenactment_tpu_torch.models import stylegan2 as sg
from stylegan_directions_face_reenactment_tpu_torch.models.e4e import (
    backbone_encoder_into_w_forward, gradual_style_encoder_forward)
from stylegan_directions_face_reenactment_tpu_torch.models.face import fan as fan_mod
from stylegan_directions_face_reenactment_tpu_torch.models.face.landmarks import (
    estimate_landmarks_3d)
from stylegan_directions_face_reenactment_tpu_torch.weights import (
    backbone_encoder_into_w_from_jax, discriminator_from_jax, generator_from_jax,
    gradual_style_encoder_from_jax, init_generator, init_lpips, lpips_from_jax,
    resnet_depth_from_jax,
    wplus_encoder_from_jax)

from torch_face_zoo import damped_e4e, fan_pair, s3fd_pair, statics_jit, to_np
from torch_threads import _threads  # noqa: F401

BOOST = "conv5_3_norm_mbox_conf"


def close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def randomize(tree, seed, keys=("bias", "act_bias")):
    """The tree with every leaf under ``keys`` drawn N(0, 0.1)."""
    rs = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: ((0.1 * rs.randn(*v.shape)).astype(np.float32)
                        if k in keys and isinstance(v, np.ndarray) else walk(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(to_np(tree))


def nhwc(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


# --- discriminator, W+ encoder -------------------------------------------------

@pytest.fixture(scope="module")
def disc():
    j = randomize(j_sg.init_discriminator(jax.random.PRNGKey(0), 32, channel_multiplier=2), 1)
    return j, discriminator_from_jax(j, channel_multiplier=2, device="cpu")


@pytest.fixture(scope="module")
def wplus():
    j = randomize(j_sg.init_wplus_encoder(jax.random.PRNGKey(2), 32), 3)
    return j, wplus_encoder_from_jax(j, device="cpu")


def test_discriminator_matches_jax(disc):
    j, d = disc
    x = nhwc(4, 4, 32, 32, 3)
    want = statics_jit(j_sg.discriminator_forward, j)(jnp.asarray(x))
    with torch.no_grad():
        got = d(torch.from_numpy(x))
    assert got.shape == (4, 1)
    close(got.numpy(), want, 1e-4, 1e-5)


@pytest.mark.parametrize("block", [0, 1, 2])
def test_conv_layer_and_res_block_match_jax(disc, block):
    """``conv_layer`` and ``res_block`` against the JAX functions on the
    discriminator's weights: block 0 the unstrided 1×1 layer, blocks 1-2
    ResBlocks and, inside them, the unstrided 3×3 layer, the strided 3×3
    layer and the strided 1×1 skip without activation; the modules'
    ``forward`` is the same call."""
    j, d = disc
    jp, m = j["blocks"][block], d.convs[block]
    cin = m[-1].bias.shape[0] if block == 0 else m.conv1[0].weight.shape[1]
    x = nhwc(10 + block, 2, 32 >> max(block - 1, 0), 32 >> max(block - 1, 0),
             3 if block == 0 else cin)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    if block == 0:
        pairs = [(j_sg.conv_layer, jp, sg.conv_layer, m)]
    else:
        pairs = [(j_sg.res_block, jp, sg.res_block, m)] + [
            (j_sg.conv_layer, jp[k], sg.conv_layer, getattr(m, k))
            for k in ("conv1", "conv2", "skip")]
    for j_fn, j_p, fn, mod in pairs:
        want = statics_jit(j_fn, j_p)(jnp.asarray(x))
        with torch.no_grad():
            got = fn(mod, tx)
            torch.testing.assert_close(mod(tx), got, rtol=0, atol=0)
        close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4, 1e-5)


def test_minibatch_stddev_matches_jax():
    x = nhwc(5, 4, 4, 4, 8) * 3
    want = j_sg.minibatch_stddev(jnp.asarray(x))
    got = sg.minibatch_stddev(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6, 1e-6)


def test_wplus_encoder_matches_jax(wplus):
    j, e = wplus
    x = nhwc(6, 4, 32, 32, 3)
    want = statics_jit(j_sg.wplus_encoder_forward, j)(jnp.asarray(x))
    with torch.no_grad():
        got = e(torch.from_numpy(x))
    assert got.shape == (4, sg.n_latent_for(32), 512)
    close(got.numpy(), want, 1e-4, 1e-5)


def test_heads_go_through_k1_and_k2(disc, monkeypatch):
    """The blurs before the stride-2 convs are K1 at pads (2, 2) and (1, 1),
    the activations K2, the final linear's at rank 2: the operators."""
    from stylegan_directions_face_reenactment_tpu_torch.ops import fused_act, upfirdn2d_kernel
    pads, ranks = [], []
    k1, k2 = upfirdn2d_kernel.upfirdn2d_op, fused_act.fused_bias_act_op
    monkeypatch.setattr(upfirdn2d_kernel, "upfirdn2d_op",
                        lambda x, t, s, up, pad: (pads.append((up, tuple(pad))),
                                                  k1(x, t, s, up, pad))[1])
    monkeypatch.setattr(fused_act, "fused_bias_act_op",
                        lambda x, *a: (ranks.append(x.dim()), k2(x, *a))[1])
    with torch.no_grad():
        disc[1](torch.from_numpy(nhwc(7, 2, 32, 32, 3)))
    assert sorted(set(pads)) == [(1, (1, 1)), (1, (2, 2))] and len(pads) == 6
    assert 2 in ranks and ranks.count(4) == 1 + 3 * 2 + 1


# --- pSp heads -------------------------------------------------------------------

@pytest.fixture(scope="module")
def psp():
    e = damped_e4e(3, 64)
    j = to_np(convert_e4e_encoder(e.state_dict(), image_resolution=64))
    return j, gradual_style_encoder_from_jax(j, device="cpu")


def test_gradual_style_encoder_matches_jax(psp):
    j, e = psp
    x = nhwc(8, 1, 64, 64, 3)
    want = statics_jit(j_e4e.gradual_style_encoder_forward, j)(jnp.asarray(x))
    with torch.no_grad():
        got = gradual_style_encoder_forward(e, torch.from_numpy(x))
    assert got.shape == (1, 10, 512)
    close(got.numpy(), want, 1e-5, 5e-6)


def test_backbone_encoder_into_w_matches_jax(psp):
    j_e4e_params = psp[0]
    rs = np.random.RandomState(9)
    j = {"input": j_e4e_params["input"], "body": j_e4e_params["body"],
         "linear": {"weight": rs.randn(512, 512).astype(np.float32),
                    "bias": (0.1 * rs.randn(512)).astype(np.float32)}}
    e = backbone_encoder_into_w_from_jax(j, device="cpu")
    x = nhwc(10, 2, 64, 64, 3)
    want = statics_jit(j_e4e.backbone_encoder_into_w_forward, j)(jnp.asarray(x))
    with torch.no_grad():
        got = backbone_encoder_into_w_forward(e, torch.from_numpy(x))
    assert got.shape == (2, 512)
    close(got.numpy(), want, 1e-5, 5e-6)


# --- the depth net and the 3D landmarks ------------------------------------------

def randomize_bn_tree(tree, seed):
    """Batch-norm leaves ({scale, offset, mean, var}) drawn as the face zoo's."""
    rs = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "offset", "mean", "var"}:
                c = np.shape(t["scale"])[0]
                return {"scale": (1 + 0.1 * rs.randn(c)).astype(np.float32),
                        "offset": (0.1 * rs.randn(c)).astype(np.float32),
                        "mean": (0.1 * rs.randn(c)).astype(np.float32),
                        "var": (0.5 + rs.rand(c)).astype(np.float32)}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(to_np(tree))


@pytest.fixture(scope="module")
def depth():
    j = randomize_bn_tree(j_fan.init_resnet_depth(jax.random.PRNGKey(5), layers=(1, 1, 1, 1)), 6)
    j["fc"]["bias"] = (0.1 * np.random.RandomState(7).randn(68)).astype(np.float32)
    return j, resnet_depth_from_jax(j, device="cpu")


def test_draw_gaussians_matches_jax():
    pts = np.random.RandomState(11).uniform(-10, 70, (2, 68, 2)).astype(np.float32)
    want = j_fan.draw_gaussians(jnp.asarray(pts), size=64)
    got = fan_mod.draw_gaussians(torch.from_numpy(pts), size=64)
    assert got.shape == (2, 64, 64, 68) and float(got.max()) <= 1.0
    close(got.numpy(), want, 1e-6, 1e-7)


def test_resnet_depth_and_predict_depth_match_jax(depth):
    j, m = depth
    rs = np.random.RandomState(12)
    crops = rs.rand(2, 256, 256, 3).astype(np.float32)
    pts = rs.uniform(1, 64, (2, 68, 2)).astype(np.float32)
    scale = np.float32([1.3, 0.9])
    want = statics_jit(j_fan.predict_depth, j)(*map(jnp.asarray, (crops, pts, scale)))
    with torch.no_grad():
        got = fan_mod.predict_depth(m, *map(torch.from_numpy, (crops, pts, scale)))
    assert got.shape == (2, 68)
    close(got.numpy(), want, 1e-4, 1e-5)


@pytest.fixture(scope="module")
def zoo(depth):
    return {"fan": fan_pair(seed=51, num_modules=1),
            "sfd": s3fd_pair(seed=52, boost_head=BOOST), "depth": depth}


def test_estimate_landmarks_3d_matches_jax(zoo):
    (jf, pf), (js, ps), (jd, pd) = zoo["fan"], zoo["sfd"], zoo["depth"]
    imgs = np.random.RandomState(13).uniform(0, 255, (2, 128, 160, 3)).astype(np.float32)
    want, want_ok = statics_jit(j_estimate_landmarks_3d, js, jf, jd)(jnp.asarray(imgs))
    with torch.no_grad():
        got, ok = estimate_landmarks_3d(ps, pf, pd, torch.from_numpy(imgs))
    assert got.shape == (2, 68, 3) and bool(ok.all())
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    want = np.asarray(want)
    np.testing.assert_array_equal(got[..., :2].numpy(), want[..., :2])
    close(got[..., 2].numpy(), want[..., 2], 1e-4, 1e-5)


def test_estimate_landmarks_3d_gradient_matches_jax(zoo, monkeypatch):
    """A projection of the (B, 68, 3) output differentiated with respect to
    the frames against ``jax.grad``, in float64 on both sides. The gradient
    reaches the frames through the crops (into FAN and the depth net); S3FD
    sees a detached input and the box is stopped, so S3FD's weights get no
    ``.grad``; the depth net's get theirs."""
    from stylegan_directions_face_reenactment_tpu_torch.models.face import landmarks
    (jf, pf), (js, ps), (jd, pd) = zoo["fan"], zoo["sfd"], zoo["depth"]
    pf, ps, pd = (copy.deepcopy(m).double() for m in (pf, ps, pd))
    rs = np.random.RandomState(14)
    imgs = 255 * rs.rand(2, 128, 128, 3)
    proj = rs.randn(2, 68, 3)

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: a.astype(np.float64) if getattr(a, "dtype", None) == np.float32 else a,
            tree)

    def jax_grad(s, f, d, im, w):
        return jax.grad(lambda x: jnp.sum(j_estimate_landmarks_3d(s, f, d, x)[0] * w))(im)

    with jax.enable_x64(True):
        want = np.asarray(statics_jit(jax_grad, f64(js), f64(jf), f64(jd))(
            jnp.asarray(imgs), jnp.asarray(proj)))
    assert want.dtype == np.float64
    seen = []
    detect = landmarks.detect_faces
    monkeypatch.setattr(landmarks, "detect_faces",
                        lambda s, x, **kw: (seen.append(x.requires_grad), detect(s, x, **kw))[1])
    x = torch.from_numpy(imgs).requires_grad_()
    out, ok = estimate_landmarks_3d(ps, pf, pd, x)
    assert bool(ok.all()) and seen == [False]
    (out * torch.from_numpy(proj)).sum().backward()
    close(x.grad.numpy(), want, 1e-3, 2e-3)
    assert all(p.grad is None for p in ps.parameters())
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0 for p in pd.parameters())


# --- PTI's space regulariser -------------------------------------------------------

def test_space_regularizer_matches_jax(monkeypatch):
    """Both sides fed the same normal draws (the JAX key's, handed to the
    port in place of its ``torch.Generator``'s)."""
    size = 32
    sd = {k: (v[None] if k.endswith("conv.weight") else v) for k, v in
          init_generator(1, size=size, channel_multiplier=1, device="cpu")
          .state_dict().items()}
    jg = to_np(convert_stylegan2_generator(sd, size=size, channel_multiplier=1))
    rs = np.random.RandomState(17)
    jg_new = jax.tree_util.tree_map(     # the tuned generator: every weight moved 10 %
        lambda a: (a * (1 + 0.1 * rs.randn(*a.shape))).astype(np.float32)
        if isinstance(a, np.ndarray) and a.dtype == np.float32 else a, jg)
    lp0 = init_lpips(3, device="cpu")
    jl = to_np(convert_lpips_alex(lp0.net.layers.state_dict(), lp0.lin.state_dict()))
    hp = PTIHyperparams(latent_ball_num_of_samples=2)
    w = rs.randn(1, 512).astype(np.float32)
    rng = jax.random.PRNGKey(16)
    draws = np.stack([np.asarray(jax.random.normal(k, (1, 512)))
                      for k in jax.random.split(rng, 2)])

    def j_fwd(g, code):
        return j_sg.generator_forward(g, [code], input_is_latent=True)[0]

    want = statics_jit(lambda g0, g1, lp, wb: j_space_regularizer_loss(
        j_fwd, g1, g0, lp, wb, rng, JPTIHyperparams(latent_ball_num_of_samples=2)),
        jg, jg_new, jl)(jnp.asarray(w))
    monkeypatch.setattr(pti_mod, "latent_ball_draws",
                        lambda gen, n, dim: torch.from_numpy(draws))
    g0, g1 = generator_from_jax(jg, device="cpu"), generator_from_jax(jg_new, device="cpu")
    lp = lpips_from_jax(jl, device="cpu")

    def fwd(g, code):
        return sg.generator_forward(g, [code], input_is_latent=True)[0]

    got = space_regularizer_loss(fwd, g1, g0, lp, torch.from_numpy(w),
                                 torch.Generator().manual_seed(0), hp)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    z = torch.from_numpy(draws[0])
    morphed = get_morphed_w_code(z, torch.from_numpy(w), 10.0)
    assert abs(float(torch.linalg.vector_norm(morphed - torch.from_numpy(w))) - 10.0) < 1e-4
    got.backward()
    assert any(p.grad is not None for p in g1.parameters())
    assert all(p.grad is None for p in g0.parameters())


# --- key names ------------------------------------------------------------------------

def test_state_dict_keys_are_the_reference_layout(disc, wplus, psp, depth):
    d, e, p, r = disc[1].state_dict(), wplus[1].state_dict(), psp[1].state_dict(), \
        depth[1].state_dict()
    assert {"convs.0.0.weight", "convs.0.1.bias", "convs.1.conv1.0.weight",
            "convs.1.conv2.0.kernel", "convs.1.conv2.1.weight", "convs.1.conv2.2.bias",
            "convs.1.skip.0.kernel", "convs.1.skip.1.weight", "final_conv.0.weight",
            "final_conv.1.bias", "final_linear.0.weight", "final_linear.1.bias"} <= set(d)
    assert "convs.1.skip.1.bias" not in d
    assert f"convs.{len(wplus[0]['blocks'])}.weight" in e
    assert {"styles.9.convs.6.weight", "latlayer1.weight", "input_layer.0.weight"} <= set(p)
    assert {"conv1.weight", "bn1.running_var", "layer3.0.downsample.0.weight",
            "layer4.0.conv3.weight", "fc.weight", "fc.bias"} <= set(r)
    assert r["conv1.weight"].shape == (64, 71, 7, 7)
