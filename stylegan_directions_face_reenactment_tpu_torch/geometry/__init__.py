from .directions import (DirectionsSpec, initialize_directions,
                         make_shift_vector, start_positions)

__all__ = ["DirectionsSpec", "initialize_directions", "make_shift_vector",
           "start_positions"]
