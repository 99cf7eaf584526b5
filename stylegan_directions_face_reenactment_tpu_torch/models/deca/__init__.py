from .deca import (DECA, ResnetEncoder, calculate_shape, calculate_shapemodel,
                   decompose_code, deca_decode, deca_encode, extract_deca_params,
                   resnet_encoder_forward)
from .flame import FLAME, flame_forward, synthetic_flame_params
from .resnet import ResNet50, resnet50_features

__all__ = ["DECA", "FLAME", "ResnetEncoder", "ResNet50", "calculate_shape",
           "calculate_shapemodel", "decompose_code", "deca_decode", "deca_encode",
           "extract_deca_params", "flame_forward", "resnet_encoder_forward",
           "resnet50_features", "synthetic_flame_params"]
