"""Host-side utilities: logging, configuration, provenance, timing."""

from .logger import AstroLogger, get_logger, logger
from .config import AttrDict, YamlConfig, config
from .timing import StageTimer, device_trace

__all__ = [
    "AstroLogger",
    "get_logger",
    "logger",
    "AttrDict",
    "YamlConfig",
    "config",
    "StageTimer",
    "device_trace",
]
