"""The port's ``cli/extract_statistics.py`` against the JAX package's on the
CPU: the per-batch program (generate → DECA, aligned as ``align_for``
says) on the same numpy z against the JAX composition of the same calls,
``filter_detected_rows`` against the JAX function, and ``main --device
cpu`` end to end.

World: ``tests/torch_reenact_world.py`` (a 64² generator, the DECA
ResNet-50 at 224, a 2-module FAN and the boosted S3FD, every face past its
gate). Tolerances: the rows' angles atol 1e-2 degrees, the jaw and the
expressions rtol 1e-3 and atol 1e-3·max|coefficient| (the DECA encoder
bound of ``tests/test_torch_reenact.py``); the filter exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.cli import extract_statistics as jstats
from stylegan_directions_face_reenactment_tpu.models.deca import (
    calculate_shapemodel as j_calculate_shapemodel)
from stylegan_directions_face_reenactment_tpu.pipeline.reenactment import align_for as j_align_for
from stylegan_directions_face_reenactment_tpu.pipeline.synthesis import (
    generate_image as j_generate_image)

from stylegan_directions_face_reenactment_tpu_torch.cli import extract_statistics as stats

from torch_face_zoo import statics_jit
from torch_reenact_world import build_world, close_scaled

B = 2


@pytest.fixture(scope="module")
def world():
    return build_world()


def jax_rows(world, z, with_sfd):
    g, _, deca, jf, js = world["jax"]
    trunc = jnp.asarray(world["trunc"])

    def rows(g, deca, f, s, z):
        imgs = j_generate_image(g, z, truncation=0.7, truncation_latent=trunc)
        params, angles = j_calculate_shapemodel(deca, imgs, align_fn=j_align_for(f, s))
        return jnp.concatenate([angles, params["pose"][:, 3:4], params["alpha_exp"]], axis=1)

    return np.asarray(statics_jit(rows, g, deca, jf, js if with_sfd else None)(z))


@pytest.mark.parametrize("alignment", ["fan", "fan_frame"])
def test_batch_rows_match_jax(world, alignment):
    z = np.random.RandomState(3).randn(B, 512).astype(np.float32)
    g, _, deca, pf, ps = world["port"]
    got = stats.batch_rows(g, deca, torch.from_numpy(z), truncation=0.7,
                           truncation_latent=torch.from_numpy(world["trunc"]), fan=pf,
                           s3fd=ps if alignment == "fan" else None).numpy()
    want = jax_rows(world, z, alignment == "fan")
    assert got.shape == want.shape == (B, 54)
    assert (got[:, :3] != -180.0).all()      # every face passed the boosted gate
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=1e-2)
    close_scaled(got[:, 3:], want[:, 3:], 1e-3, 1e-3)


def test_filter_detected_rows_matches_jax(capsys):
    rows = np.random.RandomState(0).randn(6, 54)
    rows[[1, 4], :3] = -180.0
    rows[2, 0] = -180.0                      # one angle alone is not the sentinel
    got = stats.filter_detected_rows(rows)
    np.testing.assert_array_equal(got, jstats.filter_detected_rows(rows))
    assert got.shape == (4, 54)
    assert capsys.readouterr().out.count("dropping 2/6 samples") == 2
    rows[:, :3] = -180.0
    for fn in (stats.filter_detected_rows, jstats.filter_detected_rows):
        with pytest.raises(RuntimeError, match="every sample"):
            fn(rows)


def test_main_on_the_cpu(tmp_path):
    """Random-init nets at 64², the resize alignment, 5 samples in batches
    of 2: the (54, 2) float64 ranges of the z's drawn from the seed's CPU
    generator (the last batch's extra row cut), min ≤ max."""
    ranges = stats.main(["--random_init", "--device", "cpu", "--image_resolution", "64",
                         "--num_samples", "5", "--batch_size", "2", "--deca_alignment",
                         "resize", "--output_path", str(tmp_path / "out"), "--seed", "4"])
    saved = np.load(tmp_path / "out" / "ranges_voxceleb.npy")
    assert saved.shape == (54, 2) and saved.dtype == np.float64
    np.testing.assert_array_equal(saved, ranges)
    assert (saved[:, 0] <= saved[:, 1]).all() and np.isfinite(saved).all()
    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading as ml
    g = ml.load_generator(random_init=True, resolution=64, device="cpu")
    deca = ml.load_deca(random_init=True, device="cpu")
    gen = torch.Generator().manual_seed(4)
    z = torch.cat([torch.randn((2, 512), generator=gen) for _ in range(3)])[:5]
    rows = stats.batch_rows(g, deca, z, truncation=0.7,
                            truncation_latent=ml.compute_trunc(g)).double().numpy()
    np.testing.assert_allclose(saved, np.stack([rows.min(0), rows.max(0)], 1), rtol=1e-5,
                               atol=1e-6)
