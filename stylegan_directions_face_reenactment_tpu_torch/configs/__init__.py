from .models_config import AUX_MODELS, MODELS, PRETRAINED_ROOT

__all__ = ["AUX_MODELS", "MODELS", "PRETRAINED_ROOT"]
