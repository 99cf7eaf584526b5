from .from_jax import (deca_from_jax, direction_matrix_from_jax, fan_from_jax,
                       generator_from_jax, init_deca, init_direction_matrix,
                       init_fan, init_generator, init_s3fd, s3fd_from_jax)

__all__ = ["deca_from_jax", "direction_matrix_from_jax", "fan_from_jax",
           "generator_from_jax", "init_deca", "init_direction_matrix",
           "init_fan", "init_generator", "init_s3fd", "s3fd_from_jax"]
