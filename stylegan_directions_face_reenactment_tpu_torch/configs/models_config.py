"""Generator configurations the port supports: the voxceleb and ffhq rows of
the reference's model registry. Only the architecture is kept; the port
makes its weights from a seed or imports them (``weights/from_jax.py``)."""

from __future__ import annotations

MODELS = {
    "voxceleb": {"resolution": 256, "channel_multiplier": 1,
                 "style_dim": 512, "n_mlp": 8},
    "ffhq": {"resolution": 1024, "channel_multiplier": 2,
             "style_dim": 512, "n_mlp": 8},
}
