"""The plain reference agrees with the port at small sizes on the CPU, on
the same seeded weights and inputs."""

import copy
import importlib

import pytest
import torch

from harness import common, nets, traffic
from reference import reenact

DEV = torch.device("cpu")
SEED = 2**31 + 21


def _cfg():
    cfg = copy.deepcopy(common.config("vox256"))
    cfg["generator"].update(resolution=32, channel_multiplier=1)
    cfg["fan"]["num_modules"] = 1
    return cfg


@pytest.fixture(scope="module")
def both():
    cfg = _cfg()
    names = ("g", "a", "deca", "sfd", "fan")
    return (cfg, nets.port_nets(common.PORT, cfg, names, SEED, DEV),
            nets.reference_nets(cfg, names, SEED, DEV))


def _port(mod):
    return importlib.import_module(f"{common.PORT}.{mod}")


def test_same_weights(both):
    _, port, ref = both
    for name in port:
        ps, rs = port[name].state_dict(), ref[name].state_dict()
        assert ps.keys() == rs.keys()
        assert all(torch.equal(ps[k], rs[k]) for k in ps), name


def test_synthesis(both):
    cfg, port, ref = both
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(1))
    sg = _port("models.stylegan2")
    with torch.no_grad():
        code = sg.style_to_wplus(port["g"], [sg.mapping(port["g"], z)])
        want = reenact.images(ref["g"], code)
        got = sg.synthesis(port["g"], code)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_preprocessing_and_deca_shift(both):
    cfg, port, ref = both
    tr = dict(common.traffic("video"), frame_hw=[160, 1000], patch=48, margins=[30, 30, 60, 60])
    frames = traffic.frames(tr, SEED, 2, DEV)
    pipe = _port("pipeline")
    with torch.no_grad():
        crops_p, ok_p, _, pts_p = pipe.preprocess_batch_device(port["sfd"], port["fan"], frames)
        crops_r, ok_r, _, pts_r = reenact.preprocess(ref, frames)
        assert torch.equal(ok_p, ok_r) and torch.equal(pts_p, pts_r)
        torch.testing.assert_close(crops_p, crops_r)
        torch.testing.assert_close(reenact.crops_from(frames, pts_p), crops_p)
        spec = reenact.spec_of(cfg)
        src = reenact.source(ref, torch.randn(1, 512, generator=torch.Generator().manual_seed(2)))
        shift_r = reenact.shift(ref, spec, src, crops_r)
        pt, at = pipe.source_shape(port["deca"], crops_p, port["fan"], port["sfd"])
        geo = _port("geometry")
        dm = _port("models.direction_matrix")
        ps = {k: v.expand((2,) + tuple(v.shape[1:])) for k, v in src[1].items()}
        shift_p = dm.direction_matrix_forward(
            port["a"], geo.make_shift_vector(spec, ps, pt, src[2].expand(2, 3), at))
    torch.testing.assert_close(shift_p, shift_r, rtol=1e-5, atol=1e-5)


def test_deca_alignment_lands_on_content(both):
    """The seeded detector's face in the FFHQ crop lies on the frame's
    content, so that DECA reads each frame's own texture."""
    cfg, _, ref = both
    from reference.model.pipeline.reenactment import align_for
    tr = dict(common.traffic("video"), frame_hw=[160, 1000], patch=48, margins=[30, 30, 60, 60])
    frames = traffic.frames(tr, SEED, 2, DEV)
    with torch.no_grad():
        crops, ok, _, _ = reenact.preprocess(ref, frames)
        aligned, ok_a = align_for(ref["fan"], ref["sfd"])((crops + 1.0) / 2.0)
    assert bool(ok.all()) and bool(ok_a.all())
    assert float(aligned.flatten(1).std(dim=1).min()) > 0.004
    assert float((aligned[0] - aligned[1]).abs().mean()) > 0.02
