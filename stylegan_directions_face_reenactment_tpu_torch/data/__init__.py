from .datasets import DatasetInversion, Loader, load_image_gan_range

__all__ = ["DatasetInversion", "Loader", "load_image_gan_range"]
