from .direction_matrix import DirectionMatrix, direction_matrix_forward
from .e4e import (backbone_encoder_into_w_forward, e4e_forward,
                  gradual_style_encoder_forward)
from .irse import backbone_forward
from .stylegan2 import (Generator, channel_map, discriminator_forward, generator_forward,
                        mapping, mean_latent, n_latent_for, style_to_wplus, synthesis,
                        wplus_encoder_forward)

__all__ = ["DirectionMatrix", "direction_matrix_forward", "backbone_encoder_into_w_forward",
           "e4e_forward", "gradual_style_encoder_forward", "backbone_forward", "Generator",
           "channel_map", "discriminator_forward", "generator_forward", "mapping",
           "mean_latent", "n_latent_for", "style_to_wplus", "synthesis",
           "wplus_encoder_forward"]
