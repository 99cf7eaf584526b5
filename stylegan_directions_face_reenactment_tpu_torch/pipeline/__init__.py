from .reenactment import make_reenact_fn, reenact_batch
from .synthesis import generate_image, get_shifted_latent_code

__all__ = ["make_reenact_fn", "reenact_batch",
           "generate_image", "get_shifted_latent_code"]
