"""The sweeps (counterpart of ``experiments/sweeps.py``): cartesian search
spaces over ``TrainingConfig`` / ``BaseConfig`` fields, optionally loaded
from a JSON file."""

import json

from .base_classes import Experiment, Sweep
from .config import BaseConfig, TrainingConfig
from .count_flops import CountFlopsExperiment
from .training_time_analytic import TrainingTimeAnalytic
from .training_time_empirical import TrainingTimeEmpirical


def load_search_space(path: str) -> dict[str, list]:
    with open(path) as f:
        return json.load(f)


class TrainingTimeEmpiricalSweep(Sweep):
    def build_experiment(self, **a) -> Experiment:
        trial = a.pop("trial", 0)
        benchmarking_steps = a.pop("benchmarking_steps", 3)
        return TrainingTimeEmpirical(config=TrainingConfig(**a), benchmarking_steps=benchmarking_steps, trial=trial)


class TrainingTimeAnalyticSweep(Sweep):
    def build_experiment(self, **a) -> Experiment:
        assumed_mfu = a.pop("assumed_mfu", 1.0)
        return TrainingTimeAnalytic(config=TrainingConfig(**a), assumed_mfu=assumed_mfu)


class CountFlopsSweep(Sweep):
    def build_experiment(self, **a) -> Experiment:
        keys = {"num_hosts", "chips_per_host", "gpu_type", "model"}
        return CountFlopsExperiment(config=BaseConfig(**{k: v for k, v in a.items() if k in keys}))
