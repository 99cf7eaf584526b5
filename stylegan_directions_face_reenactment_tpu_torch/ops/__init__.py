"""Compute primitives: plain PyTorch ops and the hand-written CUDA kernels
(K1 upfirdn2d, K2 fused bias-act) that replace the JAX package's Pallas
kernels. Nothing is compiled at import time."""

from .upfirdn2d import (upfirdn2d, upfirdn2d_output_shape, make_kernel,
                        upsample2d, downsample2d, blur)
from .fused_act import fused_leaky_relu, scaled_leaky_relu
from .equalized import equal_linear, equal_conv2d, pixel_norm
from .modulated_conv import modulated_conv2d, modulation_demod

__all__ = [
    "upfirdn2d", "upfirdn2d_output_shape", "make_kernel", "upsample2d",
    "downsample2d", "blur", "fused_leaky_relu", "scaled_leaky_relu",
    "equal_linear", "equal_conv2d", "pixel_norm", "modulated_conv2d",
    "modulation_demod",
]
