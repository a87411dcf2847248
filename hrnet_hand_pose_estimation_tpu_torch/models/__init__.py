"""Model zoo (PyTorch) behind a string registry."""
from .registry import build_model, get_builder, register, registered_models  # noqa: F401
