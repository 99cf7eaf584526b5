"""The port's ``cli/run_facial_editing.py::main`` (``--device cpu``)
against the JAX package's on the CPU: the same checkpoint files
(``tests/torch_cli_files.py``: generator, e4e, A, DECA and FLAME), the same
inputs and flags, at ``--image_resolution 64``, two directions (yaw and the
first expression) at ``--shifts_count 1`` (3 steps each).

Three sources, all with ``--deca_alignment resize``: a ``.npy`` W+ code
(``--save_gif``), a random z (the JAX z handed to the port, whose own z is
drawn from a ``torch.Generator``) and a 256² image (``--skip_preprocess``,
e4e inversion). No JAX main here runs S3FD or FAN: the JAX package's first
detection compiles op by op for 25-35 s, which would take this file over
its minute; ``make_prep_fn`` and the aligners are held against the JAX
package in ``test_torch_host_prep.py``, ``test_torch_fan_align.py`` and
``test_torch_cli_inference.py``, and ``chip_smoke.py`` [edit] runs the
CLI's detection and ``fan`` alignment on the card.

The one substitution besides the z: both packages draw the truncation's
mean latent from their own random z, so the JAX run's is handed to the
port's ``compute_trunc``.

Tolerance: the two write the same files; every PNG and GIF frame within 1
intensity unit. Each JAX main runs once, in a module fixture; most of the
file's time is their op-by-op compiles (the synthesis at batch 1 and 3,
DECA's ResNet-50, e4e).
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_directions_face_reenactment_tpu.cli.run_facial_editing import main as j_edit_main
from stylegan_directions_face_reenactment_tpu.utils import jax_cache

from stylegan_directions_face_reenactment_tpu_torch.cli import run_facial_editing

from torch_cli_files import hand_over_trunc, point_registries, seeded_modules, write_pretrained
from torch_threads import _threads  # noqa: F401

SEED = 3
COMMON = ["--image_resolution", "64", "--shifts_count", "1", "--directions", "0", "4"]
CASES = {
    "npy": (["--deca_alignment", "resize", "--save_gif"], "code.npy"),
    "random_z": (["--deca_alignment", "resize", "--seed", str(SEED)], None),
    "image": (["--skip_preprocess", "--deca_alignment", "resize"], "source.png"),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("edit")
    write_pretrained(str(root), seeded_modules(("g", "e4e", "a", "deca")))
    np.save(root / "code.npy",
            (0.5 * np.random.RandomState(1).randn(10, 512)).astype(np.float32))
    rs = np.random.RandomState(2)
    Image.fromarray(rs.randint(0, 256, (256, 256, 3)).astype(np.uint8)).save(root / "source.png")
    return root


@pytest.fixture(scope="module")
def mp(files):
    """Both registries at the files; the JAX run's mean latent and z kept
    for the port; no persistent XLA cache."""
    with pytest.MonkeyPatch.context() as m:
        point_registries(m, str(files))
        m.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)
        hand_over_trunc(m)
        z = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED), (1, 512)))
        m.setattr(run_facial_editing, "random_z",
                  lambda seed, device: torch.tensor(z).to(device))
        yield m


@pytest.fixture(scope="module")
def edits(files, mp, tmp_path_factory):
    """``edits(case)`` → (JAX output folder, port output folder, the port's
    return): both mains run once per case and module."""
    done = {}

    def run(case):
        if case not in done:
            flags, source = CASES[case]
            out = tmp_path_factory.mktemp(case)
            argv = COMMON + flags
            if source is not None:
                argv += ["--source_path", str(files / source)]
            j_edit_main(argv + ["--output_path", str(out / "jax")])
            res = run_facial_editing.main(argv + ["--output_path", str(out / "port"),
                                                  "--device", "cpu"])
            done[case] = (out / "jax", out / "port", res)
        return done[case]

    return run


def listing(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs)


def frames_of(path):
    im = Image.open(path)
    out = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        out.append(np.asarray(im.convert("RGB")).astype(int))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_editing_main_matches_jax(edits, case):
    jax_dir, port_dir, res = edits(case)
    files = listing(port_dir)
    assert files == listing(jax_dir)
    assert set(res["sweeps"]) == {"yaw", "exp_00"}
    for name, values in res["sweeps"].items():
        assert files.count(name + ".gif") == ("--save_gif" in CASES[case][0])
        assert [f for f in files if f.startswith(name + "/")] == [
            f"{name}/{name}_{i:03d}.png" for i in range(len(values))]
    for f in files:
        got, want = frames_of(port_dir / f), frames_of(jax_dir / f)
        assert len(got) == len(want) and got[0].shape == (64, 64, 3), f
        assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= 1, f


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_facial_editing.main(["--directions", "0", "--output_path", str(tmp_path)])
