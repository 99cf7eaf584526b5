"""The plain arithmetic of the port's operators: every kernel of the port is
replaced here by the plain PyTorch version it is held against."""

from .equalized import equal_conv2d, equal_linear, pixel_norm
from .fused_act import fused_leaky_relu, scaled_leaky_relu
from .modulated_conv import modulated_conv2d, modulation_demod
from .upfirdn2d import blur, downsample2d, make_kernel, upfirdn2d, upsample2d
