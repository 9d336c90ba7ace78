"""The method-search experiment layer (counterpart of the JAX package's
``experiments/``): the step cache, the experiment and sweep classes, the
configurations and the three experiments (FLOP count, analytic and
empirical training time)."""

from .base_classes import Experiment, Sweep
from .cache import MemoryWorkspace, StepCall, StepFailure, Workspace, get_workspace, set_workspace, step
from .config import BaseConfig, TrainingConfig

__all__ = [
    "step",
    "StepCall",
    "StepFailure",
    "Workspace",
    "MemoryWorkspace",
    "get_workspace",
    "set_workspace",
    "BaseConfig",
    "TrainingConfig",
    "Experiment",
    "Sweep",
]
