"""The port's pipelines (the JAX package's ``models``)."""

from .config import (PipelineConfig, from_jax_config, similarity_to_numpy,
                     stars_to_numpy)
from .pipeline import (calibrate_register_stack,
                       calibrate_register_stack_lean, frame_noise_stats,
                       register_frames)

__all__ = [
    "PipelineConfig",
    "calibrate_register_stack",
    "calibrate_register_stack_lean",
    "frame_noise_stats",
    "from_jax_config",
    "register_frames",
    "similarity_to_numpy",
    "stars_to_numpy",
]
