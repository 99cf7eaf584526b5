from .datasets import (CustomDataset, CustomDatasetPaired, CustomDatasetPairedValidation,
                       CustomDatasetTestsetReal, CustomDatasetTestsetSynthetic,
                       DatasetInversion, Loader, load_image_gan_range)

__all__ = ["CustomDataset", "CustomDatasetPaired", "CustomDatasetPairedValidation",
           "CustomDatasetTestsetReal", "CustomDatasetTestsetSynthetic",
           "DatasetInversion", "Loader", "load_image_gan_range"]
