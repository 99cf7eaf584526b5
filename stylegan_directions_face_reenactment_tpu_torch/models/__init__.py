from .direction_matrix import DirectionMatrix, direction_matrix_forward
from .stylegan2 import (Generator, channel_map, generator_forward, mapping,
                        mean_latent, n_latent_for, style_to_wplus, synthesis)

__all__ = ["DirectionMatrix", "direction_matrix_forward", "Generator",
           "channel_map", "generator_forward", "mapping", "mean_latent",
           "n_latent_for", "style_to_wplus", "synthesis"]
