from .common import get_image_files, make_noise, make_path, one_hot, save_arguments_json
from .device import resolve_device
from .image_utils import (add_border, generate_grid_image, image_to_tensor, load_image,
                          save_image, tensor_to_image, torch_range_1_to_255,
                          torch_range_255_to_1)
from .profiling import StepTimer, trace
from .visualization import make_interpolation_chart, save_gif

__all__ = ["get_image_files", "make_noise", "make_path", "one_hot", "save_arguments_json",
           "resolve_device", "add_border", "generate_grid_image", "image_to_tensor",
           "load_image", "save_image", "tensor_to_image", "torch_range_1_to_255",
           "torch_range_255_to_1", "StepTimer", "trace", "make_interpolation_chart",
           "save_gif"]
