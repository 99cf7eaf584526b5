from .directions import (DirectionsSpec, draw_disentanglement_50, get_direction_info,
                         get_params_gt_reenacted, initialize_directions, make_shift_vector,
                         make_shift_vector_50, make_shift_vector_50_from, start_positions)

__all__ = ["DirectionsSpec", "draw_disentanglement_50", "get_direction_info",
           "get_params_gt_reenacted", "initialize_directions", "make_shift_vector",
           "make_shift_vector_50", "make_shift_vector_50_from", "start_positions"]
