"""Checkpoint files in the reference's on-disk layouts, made from seeded port
modules, for the CLI tests of both packages (``tests/test_torch_cli_*.py``):

* ``stylegan-voxceleb.pt``: ``{"g_ema": state dict, "latent_avg"}`` without
  the ``noises.*`` buffers, as the voxceleb file; modulated-conv weights with
  the reference's leading axis of 1;
* ``e4e-voxceleb.pt``: ``{"e": state dict, "latent_avg", "opts"}``;
* ``A_matrix_voxceleb.pt`` (the training bundle, ``utils_train.py:592-603``)
  and ``A_matrix_voxceleb.npz`` (the JAX package's ``save_a_matrix``);
* ``deca_model.tar``: ``{"E_flame": state dict}``, with the FLAME pickle and
  landmark embedding that both packages' loaders read (:func:`write_flame`,
  the layout of ``tests/test_checkpoint_files.py``'s);
* ``s3fd-619a316812.pth``: the raw state dict of a seeded S3FD whose
  stride-4 face score is gated on content (:func:`gate_s3fd_on_content`);
* ``2DFAN4-11f355bf06.pth.tar``: ``{"state_dict": FAN}``, ``FAN_MODULES``
  modules with random batch-norm statistics;
* ``lpips_alex_v0.1.pth``: ``{"alex_features", "lin"}``.

The generator is 64² (channel multiplier 1) and e4e is the damped one of
``tests/torch_face_zoo.py`` for it (10 styles on the 256 crop).

The test frames are black with a textured patch (:func:`patch_frame`).
With the S3FD of ``torch_face_zoo.s3fd_pair(boost_head=...)`` every anchor
of a head scores 1.0, and the face the reference keeps (the last of the 32
kept by NMS, in anchor order) lies on the frame's top edge, so every FFHQ
box leaves the frame. Gated on content, faces pass only near the patch,
and the patch's place decides whether the box stays in the frame.
"""

import os

import numpy as np
import torch

from stylegan_directions_face_reenactment_tpu_torch.weights import (
    init_deca, init_direction_matrix, init_fan, init_generator, init_lpips, init_s3fd,
    write_flame_files)

from torch_face_zoo import damped_e4e, randomize_bn

SIZE = 64
FAN_MODULES = 1
N_VERTS, N_FACES = 128, 200


def gate_s3fd_on_content(sfd) -> None:
    """Set S3FD's stride-4 head so that its face logit is the sum of the
    L2-normed conv3_3 features in its 3×3 window less 10: where the frame
    is black (every trunk bias is 0) the score is about 5e-5, near content
    it is 1.0."""
    conv = sfd.conv3_3_norm_mbox_conf
    with torch.no_grad():
        conv.weight.zero_()
        conv.bias.zero_()
        conv.weight[3] = 1.0
        conv.bias[3] = -10.0


def patch_frame(h, w, top, left, side, seed) -> np.ndarray:
    """A black (h, w, 3) uint8 frame with a ``side``² patch of uniform noise
    at (top, left)."""
    f = np.zeros((h, w, 3), np.uint8)
    f[top:top + side, left:left + side] = np.random.RandomState(seed).randint(
        0, 256, (side, side, 3))
    return f


def _direction_matrix():
    a = init_direction_matrix(3, 512, 15, w_plus=True, num_layers=8, device="cpu")
    with torch.no_grad():
        a.linear.bias.copy_(0.01 * torch.randn(a.linear.bias.shape,
                                               generator=torch.Generator().manual_seed(4)))
    return a


def _gated_s3fd():
    sfd = init_s3fd(32, device="cpu")
    gate_s3fd_on_content(sfd)
    return sfd


MODULE_INITS = {
    "g": lambda: init_generator(1, SIZE, channel_multiplier=1, device="cpu"),
    "e4e": lambda: damped_e4e(7, SIZE),
    "a": _direction_matrix,
    "deca": lambda: init_deca(2, device="cpu"),
    "sfd": _gated_s3fd,
    "fan": lambda: randomize_bn(init_fan(31, FAN_MODULES, device="cpu"), 32),
    "lpips": lambda: init_lpips(8, device="cpu"),
}


def seeded_modules(names=tuple(MODULE_INITS)):
    """The port modules the files are written from, on the CPU: those
    ``names`` (every one by default)."""
    return {k: MODULE_INITS[k]() for k in names}


def reference_generator_sd(g):
    """The reference's ``g_ema`` layout of a port generator, noises left out."""
    return {k: (v[None] if k.endswith("conv.weight") else v)
            for k, v in g.state_dict().items() if not k.startswith("noises.")}


def write_pretrained(root, mods) -> None:
    """Write the registry files of the modules in ``mods`` into ``root``,
    with the FLAME files beside DECA's."""
    def path(name):
        return os.path.join(root, name)

    if "g" in mods:
        torch.save({"g_ema": reference_generator_sd(mods["g"]), "latent_avg": torch.randn(512)},
                   path("stylegan-voxceleb.pt"))
    if "e4e" in mods:
        torch.save({"e": mods["e4e"].state_dict(), "latent_avg": torch.randn(512),
                    "opts": {"dataset_type": "voxceleb"}}, path("e4e-voxceleb.pt"))
    if "a" in mods:
        a_sd = mods["a"].state_dict()
        torch.save({"step": 32000, "A_matrix": a_sd, "learned_directions": 15,
                    "shift_scale": 6.0, "w_plus": True, "num_layers_shift": 8},
                   path("A_matrix_voxceleb.pt"))
        np.savez(path("A_matrix_voxceleb.npz"), step=32000,
                 weight=a_sd["linear.weight"].numpy(), bias=a_sd["linear.bias"].numpy(),
                 learned_directions=15, shift_scale=6.0, w_plus=True, num_layers_shift=8)
    if "deca" in mods:
        torch.save({"E_flame": mods["deca"].E_flame.state_dict()}, path("deca_model.tar"))
        write_flame(root)
    if "sfd" in mods:
        torch.save(mods["sfd"].state_dict(), path("s3fd-619a316812.pth"))
    if "fan" in mods:
        torch.save({"state_dict": mods["fan"].state_dict()}, path("2DFAN4-11f355bf06.pth.tar"))
    if "lpips" in mods:
        lp = mods["lpips"]
        torch.save({"alex_features": lp.net.layers.state_dict(), "lin": lp.lin.state_dict()},
                   path("lpips_alex_v0.1.pth"))


def write_flame(root, n_verts=N_VERTS, n_faces=N_FACES) -> None:
    """A FLAME ``generic_model.pkl`` and ``landmark_embedding.npy`` in the
    real files' layouts, at a small mesh (``weights/flame_loader.py``)."""
    write_flame_files(os.path.join(root, "generic_model.pkl"),
                      os.path.join(root, "landmark_embedding.npy"), n_verts, n_faces)


def point_registries(monkeypatch, root) -> None:
    """Point both packages' checkpoint registries at ``root``, and tell the
    JAX package's FAN loader the module count (it assumes the 4 of
    2DFAN4; the port reads the count from the file)."""
    import functools

    from stylegan_directions_face_reenactment_tpu.configs import models_config as jcfg
    from stylegan_directions_face_reenactment_tpu.weights import torch_convert
    from stylegan_directions_face_reenactment_tpu_torch.configs import models_config as pcfg
    for cfg in (jcfg, pcfg):
        row = cfg.MODELS["voxceleb"]
        for key, name in (("generator_path", "stylegan-voxceleb.pt"),
                          ("e4e_path", "e4e-voxceleb.pt"),
                          ("directions_path", "A_matrix_voxceleb.pt")):
            monkeypatch.setitem(row, key, os.path.join(root, name))
        for key, path in list(cfg.AUX_MODELS.items()):
            monkeypatch.setitem(cfg.AUX_MODELS, key,
                                os.path.join(root, os.path.basename(path)))
    monkeypatch.setattr(torch_convert, "convert_fan",
                        functools.partial(torch_convert.convert_fan, num_modules=FAN_MODULES))


def hand_over_trunc(monkeypatch) -> None:
    """Both packages draw the truncation's mean latent from their own random
    z: keep the JAX ``compute_trunc``'s and hand it to the port's (the JAX
    main runs first)."""
    from stylegan_directions_face_reenactment_tpu.cli import model_loading as jml
    from stylegan_directions_face_reenactment_tpu_torch.cli import model_loading as pml
    kept = {}
    j_compute_trunc = jml.compute_trunc

    def keep_trunc(g, *args, **kwargs):
        kept["trunc"] = np.asarray(j_compute_trunc(g, *args, **kwargs))
        return kept["trunc"]

    monkeypatch.setattr(jml, "compute_trunc", keep_trunc)
    monkeypatch.setattr(pml, "compute_trunc",
                        lambda g, *args, **kwargs: torch.tensor(kept["trunc"]))
