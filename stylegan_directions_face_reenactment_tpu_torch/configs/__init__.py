from .models_config import MODELS

__all__ = ["MODELS"]
