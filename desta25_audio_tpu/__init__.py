"""desta25_audio_tpu — DeSTA2.5-Audio in JAX.

Public surface mirrors the reference package export
(``from desta import DeSTA25AudioModel``, desta/__init__.py:1-3).
"""

from .config import DeSTA25Config, LLMConfig, WhisperConfig
from .models.desta import DeSTA25AudioModel, GenerationOutput

__all__ = [
    "DeSTA25AudioModel",
    "DeSTA25Config",
    "GenerationOutput",
    "LLMConfig",
    "WhisperConfig",
]

__version__ = "0.1.0"
