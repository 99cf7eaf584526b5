"""The port's checkpoint loaders (``cli/model_loading.py``) against the JAX
package's on the same files: reference-layout files written from seeded
port modules (``tests/torch_cli_files.py``), each loaded by both packages
and held by one forward pass on inputs made from a seed with numpy.

Tolerance: rtol 1e-5, atol 1e-5·max|output|, for every net.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.cli import model_loading as jml
from stylegan_directions_face_reenactment_tpu.losses.lpips import lpips as j_lpips
from stylegan_directions_face_reenactment_tpu.models.deca.deca import deca_encode as j_deca_encode
from stylegan_directions_face_reenactment_tpu.models.direction_matrix import (
    direction_matrix_forward as j_direction_matrix_forward)
from stylegan_directions_face_reenactment_tpu.models.e4e import e4e_forward as j_e4e_forward
from stylegan_directions_face_reenactment_tpu.models.face.fan import fan_forward as j_fan_forward
from stylegan_directions_face_reenactment_tpu.models.face.s3fd import (
    s3fd_forward as j_s3fd_forward)
from stylegan_directions_face_reenactment_tpu.models.stylegan2 import synthesis as j_synthesis
from stylegan_directions_face_reenactment_tpu.weights import torch_convert

from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading as ml
from stylegan_directions_face_reenactment_tpu_torch.losses import lpips
from stylegan_directions_face_reenactment_tpu_torch.models import (
    direction_matrix_forward, n_latent_for, synthesis)
from stylegan_directions_face_reenactment_tpu_torch.models.deca import deca_encode
from stylegan_directions_face_reenactment_tpu_torch.models.e4e import e4e_forward
from stylegan_directions_face_reenactment_tpu_torch.models.face import fan_forward, s3fd_forward
from stylegan_directions_face_reenactment_tpu_torch.weights import init_generator

from torch_cli_files import (FAN_MODULES, SIZE, reference_generator_sd, seeded_modules,
                             write_pretrained)
from torch_face_zoo import statics_jit
from torch_threads import _threads  # noqa: F401

RS = np.random.RandomState(11)
IMG256 = RS.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrained")
    write_pretrained(str(d), seeded_modules())
    return str(d)


def f(root, name):
    return os.path.join(root, name)


def close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_generator_file(root):
    """``g_ema`` without noise buffers: they stay zero in both packages."""
    g = ml.load_generator(path=f(root, "stylegan-voxceleb.pt"), resolution=SIZE, device="cpu")
    jg = jml.load_generator("voxceleb", path=f(root, "stylegan-voxceleb.pt"), resolution=SIZE)
    assert all(not n.any() for n in g.noises.as_list())
    w = RS.randn(2, n_latent_for(SIZE), 512).astype(np.float32)
    want = statics_jit(j_synthesis, jg)(jnp.asarray(w))
    with torch.no_grad():
        got = synthesis(g, torch.from_numpy(w))
    assert got.shape == (2, SIZE, SIZE, 3)
    close(got.numpy(), want)


def test_e4e_file(root):
    e = ml.load_e4e(path=f(root, "e4e-voxceleb.pt"), resolution=SIZE, device="cpu")
    je = jml.load_e4e("voxceleb", path=f(root, "e4e-voxceleb.pt"), resolution=SIZE)
    want = statics_jit(j_e4e_forward, je)(jnp.asarray(IMG256))
    with torch.no_grad():
        got = e4e_forward(e, torch.from_numpy(IMG256))
    assert got.shape == (1, n_latent_for(SIZE), 512)
    close(got.numpy(), want)


@pytest.mark.parametrize("name", ["A_matrix_voxceleb.pt", "A_matrix_voxceleb.npz"])
def test_direction_matrix_files(root, name):
    """The reference's torch bundle and the JAX package's ``.npz``."""
    a = ml.load_direction_matrix(path=f(root, name), device="cpu")
    ja = jml.load_direction_matrix("voxceleb", path=f(root, name))
    dp = RS.randn(3, 15).astype(np.float32)
    with torch.no_grad():
        got = direction_matrix_forward(a, torch.from_numpy(dp))
    assert got.shape == (3, 8, 512) and a.linear.bias is not None
    close(got.numpy(), j_direction_matrix_forward(ja, jnp.asarray(dp)))


def test_deca_file(root):
    """``E_flame`` from the DECA file and FLAME from its pickle and landmark
    embedding, in both packages: the same coefficients, the same FLAME
    arrays."""
    flame_files = dict(flame_path=f(root, "generic_model.pkl"),
                       flame_lmk_path=f(root, "landmark_embedding.npy"))
    d = ml.load_deca(path=f(root, "deca_model.tar"), device="cpu", **flame_files)
    jd = jml.load_deca(path=f(root, "deca_model.tar"), **flame_files)
    x = (IMG256[:, 16:240, 16:240] + 1) / 2
    want = statics_jit(j_deca_encode, {"e_flame": jd["e_flame"]})(jnp.asarray(x))
    with torch.no_grad():
        got = deca_encode(d, torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), want[k])
    assert set(jd["flame"]) == {k for k, _ in d.flame.named_buffers()}
    for k, v in jd["flame"].items():
        np.testing.assert_array_equal(getattr(d.flame, k).numpy(), np.asarray(v), err_msg=k)


def test_face_model_files(root, monkeypatch):
    """S3FD's raw state dict and ``{"state_dict": FAN}``; the port reads
    FAN's module count from the file, the JAX loader is told it."""
    monkeypatch.setattr(torch_convert, "convert_fan",
                        functools.partial(torch_convert.convert_fan, num_modules=FAN_MODULES))
    sfd, fan = ml.load_face_models(sfd_path=f(root, "s3fd-619a316812.pth"),
                                   fan_path=f(root, "2DFAN4-11f355bf06.pth.tar"), device="cpu")
    jsfd, jfan = jml.load_face_models(sfd_path=f(root, "s3fd-619a316812.pth"),
                                      fan_path=f(root, "2DFAN4-11f355bf06.pth.tar"))
    assert fan.num_modules == FAN_MODULES
    x = RS.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    want = statics_jit(j_s3fd_forward, jsfd)(jnp.asarray(x))
    with torch.no_grad():
        got = s3fd_forward(sfd, torch.from_numpy(x))
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        close(a.numpy(), b)
    crops = (IMG256 + 1) / 2
    want = statics_jit(j_fan_forward, jfan)(jnp.asarray(crops))[-1]
    with torch.no_grad():
        got = fan_forward(fan, torch.from_numpy(crops))[-1]
    close(got.numpy(), want)


def test_lpips_file(root):
    lp = ml.load_lpips(f(root, "lpips_alex_v0.1.pth"), device="cpu")
    jl = jml.load_lpips(f(root, "lpips_alex_v0.1.pth"))
    y = RS.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    x = IMG256[:, :64, :64]
    want = jax.jit(j_lpips)(jl, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = lpips(lp, torch.from_numpy(x), torch.from_numpy(y))
    close(got.numpy(), want)


@pytest.mark.parametrize("drop,extra", [("style.1.weight", None), ("to_rgb1.bias", None),
                                        (None, "convs.0.conv.scale")])
def test_generator_file_with_other_keys_raises(tmp_path, drop, extra):
    """Only ``noises.*`` may be missing; any other missing or unexpected key
    raises."""
    sd = reference_generator_sd(init_generator(1, SIZE, channel_multiplier=1, device="cpu"))
    if drop:
        del sd[drop]
    if extra:
        sd[extra] = torch.ones(1)
    torch.save({"g_ema": sd}, tmp_path / "g.pt")
    with pytest.raises(KeyError, match=drop or extra):
        ml.load_generator(path=str(tmp_path / "g.pt"), resolution=SIZE, device="cpu")


def test_fan_file_with_a_missing_key_raises(root, tmp_path):
    sd = torch.load(f(root, "2DFAN4-11f355bf06.pth.tar"))["state_dict"]
    del sd["m0.b1_4.conv1.weight"]
    torch.save({"state_dict": sd}, tmp_path / "fan.pth.tar")
    with pytest.raises(KeyError, match="b1_4"):
        ml.load_face_models(f(root, "s3fd-619a316812.pth"), str(tmp_path / "fan.pth.tar"),
                            device="cpu")


def test_random_init_and_mean_latent():
    """``random_init`` gives the seeded modules; the mean latent is drawn
    from its seed."""
    g = ml.load_generator(random_init=True, resolution=SIZE, device="cpu")
    want = init_generator(0, SIZE, channel_multiplier=1, device="cpu").state_dict()
    assert all(torch.equal(v, want[k]) for k, v in g.state_dict().items())
    t = ml.compute_trunc(g, n=64)
    assert t.shape == (1, 512) and torch.equal(t, ml.compute_trunc(g, n=64))
    sfd, fan = ml.load_face_models(random_init=True, device="cpu")
    assert fan.num_modules == 4


def test_registry_reads_the_environment(tmp_path):
    code = ("from stylegan_directions_face_reenactment_tpu_torch.configs import "
            "AUX_MODELS, MODELS; print(MODELS['voxceleb']['generator_path']); "
            "print(AUX_MODELS['fan_2d'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "REENACT_PRETRAINED_ROOT": str(tmp_path)},
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         check=True).stdout.split()
    assert out == [str(tmp_path / "stylegan-voxceleb.pt"),
                   str(tmp_path / "2DFAN4-11f355bf06.pth.tar")]
