from .a_matrix import load_a_matrix, save_a_matrix
from .flame_loader import load_flame_params, load_flame_tex, write_flame_files
from .from_jax import (backbone_encoder_into_w_from_jax, deca_from_jax,
                       detail_generator_from_jax, direction_matrix_from_jax,
                       discriminator_from_jax, e4e_from_jax, fan_from_jax, flame_from_jax, generator_from_jax,
                       gradual_style_encoder_from_jax, id_backbone_from_jax, init_deca,
                       init_direction_matrix, init_discriminator, init_e4e, init_fan,
                       init_generator, init_id_backbone, init_lpips, init_resnet_depth,
                       init_s3fd, init_wplus_encoder, lpips_from_jax, resnet_depth_from_jax,
                       s3fd_from_jax, wplus_encoder_from_jax)

__all__ = ["backbone_encoder_into_w_from_jax", "discriminator_from_jax",
           "gradual_style_encoder_from_jax", "init_discriminator", "init_resnet_depth",
           "init_wplus_encoder", "resnet_depth_from_jax", "wplus_encoder_from_jax",
           "deca_from_jax", "detail_generator_from_jax", "direction_matrix_from_jax",
           "e4e_from_jax", "fan_from_jax", "flame_from_jax", "generator_from_jax",
           "id_backbone_from_jax", "init_deca", "init_direction_matrix", "init_e4e",
           "init_fan", "init_generator", "init_id_backbone", "init_lpips", "init_s3fd",
           "load_a_matrix", "load_flame_params", "load_flame_tex", "lpips_from_jax",
           "s3fd_from_jax", "save_a_matrix", "write_flame_files"]
