"""Models and their registry (port of datr_tpu/models/__init__.py)."""

from .registry import MODEL_REGISTRY, build_model, register_model
from . import dino  # noqa: F401,E402  (registers "dino")
