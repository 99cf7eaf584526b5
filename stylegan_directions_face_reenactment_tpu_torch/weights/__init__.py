from .from_jax import (deca_from_jax, direction_matrix_from_jax, e4e_from_jax,
                       fan_from_jax, generator_from_jax, init_deca,
                       init_direction_matrix, init_e4e, init_fan, init_generator,
                       init_lpips, init_s3fd, lpips_from_jax, s3fd_from_jax)

__all__ = ["deca_from_jax", "direction_matrix_from_jax", "e4e_from_jax",
           "fan_from_jax", "generator_from_jax", "init_deca",
           "init_direction_matrix", "init_e4e", "init_fan", "init_generator",
           "init_lpips", "init_s3fd", "lpips_from_jax", "s3fd_from_jax"]
