"""Generator configurations the port supports and the checkpoint registry:
the voxceleb and ffhq rows of the reference's model registry
(``libs/configs/config_models.py``) with the files of its README download
table, and ``ffhq_sg3t``, NVlabs' published StyleGAN3-T at FFHQ 1024
(``models/stylegan3.py``; ``arch`` names the generator kind, StyleGAN2 where
a row has none). The reenactment path runs it; the CLI does not yet (no
e4e or PTI for it), and no A is published for it. The loaders of
``cli/model_loading.py`` read these files with ``torch.load``; ``weights/``
makes seeded weights instead (``--random_init``).

``PRETRAINED_ROOT`` is read from ``REENACT_PRETRAINED_ROOT`` when this
module is first imported.
"""

from __future__ import annotations

import os

PRETRAINED_ROOT = os.environ.get("REENACT_PRETRAINED_ROOT", "./pretrained_models")

MODELS = {
    "voxceleb": {"resolution": 256, "channel_multiplier": 1,
                 "style_dim": 512, "n_mlp": 8,
                 "generator_path": os.path.join(PRETRAINED_ROOT, "stylegan-voxceleb.pt"),
                 "e4e_path": os.path.join(PRETRAINED_ROOT, "e4e-voxceleb.pt"),
                 "directions_path": os.path.join(PRETRAINED_ROOT, "A_matrix_voxceleb.pt")},
    "ffhq": {"resolution": 1024, "channel_multiplier": 2,
             "style_dim": 512, "n_mlp": 8,
             "generator_path": os.path.join(PRETRAINED_ROOT, "stylegan2-ffhq-config-f.pt"),
             "e4e_path": os.path.join(PRETRAINED_ROOT, "e4e_ffhq_encode.pt"),
             "directions_path": os.path.join(PRETRAINED_ROOT, "A_matrix_ffhq.pt")},
    "ffhq_sg3t": {"arch": "stylegan3-t", "resolution": 1024, "style_dim": 512,
                  "mapping_layers": 2, "channel_base": 32768, "channel_max": 512,
                  "num_layers": 14, "num_critical": 2, "first_cutoff": 2.0,
                  "first_stopband": 2 ** 2.1, "last_stopband_rel": 2 ** 0.3,
                  "margin_size": 10, "conv_kernel": 3, "filter_size": 6,
                  "lrelu_upsampling": 2, "conv_clamp": 256,
                  # NVlabs' stylegan3-t-ffhq-1024x1024 G_ema as a state dict
                  "generator_path": os.path.join(PRETRAINED_ROOT,
                                                 "stylegan3-t-ffhq-1024x1024.pt")},
}

AUX_MODELS = {
    "sfd": os.path.join(PRETRAINED_ROOT, "s3fd-619a316812.pth"),
    "fan_2d": os.path.join(PRETRAINED_ROOT, "2DFAN4-11f355bf06.pth.tar"),
    "ir_se50": os.path.join(PRETRAINED_ROOT, "model_ir_se50.pth"),
    "deca": os.path.join(PRETRAINED_ROOT, "deca_model.tar"),
    "flame": os.path.join(PRETRAINED_ROOT, "generic_model.pkl"),
    "flame_landmarks": os.path.join(PRETRAINED_ROOT, "landmark_embedding.npy"),
    "lpips_alex": os.path.join(PRETRAINED_ROOT, "lpips_alex_v0.1.pth"),
}
