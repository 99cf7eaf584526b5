from .directions import (DATASET_DICTS, DirectionsSpec, draw_disentanglement_50,
                         get_direction_info, get_direction_ranges, get_params_gt_reenacted,
                         initialize_directions, make_shift_vector, make_shift_vector_50,
                         make_shift_vector_50_from, start_positions)
from .rotations import (angle_axis_to_quaternion, batch_axis2euler, batch_axis2matrix,
                        batch_euler2axis, batch_euler2matrix, batch_matrix2axis,
                        batch_matrix2euler, batch_orth_proj, batch_rodrigues, deg2rad,
                        euler_to_quaternion, quaternion_to_angle_axis,
                        quaternion_to_rotation_matrix, rad2deg,
                        rotation_matrix_to_quaternion)

__all__ = ["DATASET_DICTS", "DirectionsSpec", "draw_disentanglement_50", "get_direction_info",
           "get_direction_ranges", "get_params_gt_reenacted", "initialize_directions",
           "make_shift_vector", "make_shift_vector_50", "make_shift_vector_50_from",
           "start_positions", "angle_axis_to_quaternion", "batch_axis2euler",
           "batch_axis2matrix", "batch_euler2axis", "batch_euler2matrix", "batch_matrix2axis",
           "batch_matrix2euler", "batch_orth_proj", "batch_rodrigues", "deg2rad",
           "euler_to_quaternion", "quaternion_to_angle_axis", "quaternion_to_rotation_matrix",
           "rad2deg", "rotation_matrix_to_quaternion"]
