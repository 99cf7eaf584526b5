from .device import resolve_device
from .profiling import StepTimer, trace

__all__ = ["resolve_device", "StepTimer", "trace"]
