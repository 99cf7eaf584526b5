from .directions import (DirectionsSpec, get_direction_info, initialize_directions,
                         make_shift_vector, start_positions)

__all__ = ["DirectionsSpec", "get_direction_info", "initialize_directions",
           "make_shift_vector", "start_positions"]
