from .alignment import (kpt68_center_size, landmark_align, make_fan_align,
                        warp_to_224)
from .editing import one_hot_shift, sweep_direction
from .inversion import invert_image, make_invert_fn
from .preprocess import (DETECT_WIDTH, preprocess_batch_device, preprocess_images,
                         resize_width, to_gan_range)
from .pti import TUNED_CONV_RANGE, optimize_g, split_tunable
from .reenactment import (align_for, make_fused_reenact_fn, make_reenact_fn,
                          reenact_batch, reenact_raw_batch, source_shape)
from .source_setup import CROP_SIZE, make_prep_fn, pad_batch, setup_source
from .synthesis import generate_image, get_shifted_latent_code

__all__ = ["kpt68_center_size", "landmark_align", "make_fan_align",
           "warp_to_224", "DETECT_WIDTH", "preprocess_batch_device",
           "preprocess_images", "resize_width", "to_gan_range",
           "align_for", "make_fused_reenact_fn", "make_reenact_fn",
           "reenact_batch", "reenact_raw_batch", "source_shape",
           "generate_image", "get_shifted_latent_code", "invert_image",
           "make_invert_fn", "TUNED_CONV_RANGE", "optimize_g", "split_tunable",
           "CROP_SIZE", "make_prep_fn", "pad_batch", "setup_source", "one_hot_shift",
           "sweep_direction"]
