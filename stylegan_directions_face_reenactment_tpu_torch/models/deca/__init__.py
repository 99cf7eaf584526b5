from .deca import (DECA, ResnetEncoder, calculate_shapemodel, decompose_code,
                   deca_encode, extract_deca_params, resnet_encoder_forward)
from .resnet import ResNet50, resnet50_features

__all__ = ["DECA", "ResnetEncoder", "ResNet50", "calculate_shapemodel",
           "decompose_code", "deca_encode", "extract_deca_params",
           "resnet_encoder_forward", "resnet50_features"]
