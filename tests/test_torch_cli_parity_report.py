"""The port's ``cli/parity_report.py`` against the JAX package's on the CPU:
``_gate`` on the seven cases of ``tests/test_parity_gate.py``, and the two
``main``s on the same checkpoint files (``tests/torch_cli_files.py``, plus
a damped IR-SE-50 file of ``tests/torch_face_zoo.py``) and the same 256²
crops, self-reenactment at ``--image_resolution 64 --no-optimize_generator
--skip_preprocess --deca_alignment resize`` (no detection: the CLI
inference tests hold that path), each main run once in a module fixture.

Both packages draw the truncation's mean latent from their own random z,
so the JAX run's is handed to the port (``hand_over_trunc``).

Tolerances: the gate exactly; the report's keys and every non-metric
value equal; CSIM and its spread atol 1e-4 (unit embeddings of images
within rtol 1e-3, atol 2e-4·max of each other); pose error atol 2e-2
degrees (each side's angles within 1e-2); expression error atol 1e-3 (its
coefficients within 1e-3·max|coefficient| over ranges of order 1).
"""

import numpy as np
import pytest
import torch

from stylegan_directions_face_reenactment_tpu.cli import parity_report as jreport
from stylegan_directions_face_reenactment_tpu.utils import jax_cache

from stylegan_directions_face_reenactment_tpu_torch.cli import parity_report as report

from torch_cli_files import hand_over_trunc, point_registries, seeded_modules, write_pretrained
from torch_face_zoo import damped_backbone
from torch_threads import _threads  # noqa: F401

REF = {"csim": 0.80, "pose": 2.0, "exp": 0.10}


def _ours(csim=0.80, pose=2.0, exp=0.10):
    return {"csim": csim, "pose_error_deg": pose, "expression_error": exp}


GATE_CASES = {   # tests/test_parity_gate.py's seven cases: (ours, tolerance)
    "exact": (_ours(), 0.01),
    "better": (_ours(csim=0.95, pose=1.0, exp=0.01), 0.01),
    "within": (_ours(csim=0.80 * 0.995, pose=2.0 * 1.005, exp=0.10 * 1.005), 0.01),
    "csim_short": (_ours(csim=0.80 * 0.98), 0.01),
    "pose_excess": (_ours(pose=2.0 * 1.02), 0.01),
    "exp_excess": (_ours(exp=0.10 * 1.02), 0.01),
    "wider": (_ours(pose=2.0 * 1.04), 0.05),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_matches_jax(case):
    ours, tol = GATE_CASES[case]
    got = report._gate(ours, REF, tol)
    assert got == jreport._gate(ours, REF, tol)
    assert got["pass"] == (case in ("exact", "better", "within", "wider"))


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    root = tmp_path_factory.mktemp("report")
    write_pretrained(str(root), seeded_modules())
    torch.save(damped_backbone(4).state_dict(), root / "model_ir_se50.pth")
    from PIL import Image
    rs = np.random.RandomState(5)
    (root / "crops").mkdir()
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (256, 256, 3)).astype(np.uint8)).save(
            root / "crops" / f"{i:03d}.png")
    argv = ["--target_path", str(root / "crops"), "--image_resolution", "64",
            "--no-optimize_generator", "--skip_preprocess", "--deca_alignment", "resize",
            "--frame_batch", "2"]
    with pytest.MonkeyPatch.context() as mp:
        point_registries(mp, str(root))
        mp.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)
        hand_over_trunc(mp)
        want = jreport.main(argv + ["--output_path", str(root / "jax")])
        got = report.main(argv + ["--output_path", str(root / "port"), "--device", "cpu"])
    return got, want, root


def test_report_keys_and_values_match_jax(reports):
    got, want, root = reports
    assert set(got) == set(want)
    assert (root / "port" / "PARITY_REPORT.json").exists()
    for k in want:
        if k not in ("metrics", "per_frame_std"):
            assert got[k] == want[k], k
    # checkpoint files, not --random_init: "real" and verified, as in JAX
    assert got["n_frames"] == 3 and got["self_reenactment"] and got["verified"]


def test_report_metrics_match_jax(reports):
    got, want, _ = reports
    for part in ("metrics", "per_frame_std"):
        assert set(got[part]) == set(want[part])
        np.testing.assert_allclose(got[part]["csim"], want[part]["csim"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[part]["pose_error_deg"], want[part]["pose_error_deg"],
                                   rtol=0, atol=2e-2)
        np.testing.assert_allclose(got[part]["expression_error"],
                                   want[part]["expression_error"], rtol=0, atol=1e-3)
