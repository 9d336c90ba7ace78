"""Analytic training time (counterpart of
``experiments/training_time_analytic.py``).

training_days = total_flops / (num_chips x peak_flops x assumed_mfu x 86400)

The peak is the card's data-sheet rate for the model's products
(``gpus.analytic_peak_tflops``): bf16 for bf16 and fp16 models, TF32 for
f32 models under the free lunch, f32 outside the tensor cores otherwise.
At the default ``assumed_mfu`` of 1.0 it is a lower bound, as in the
reference; a realistic MFU turns it into an estimate.

    python -m multimodal_llm_pretraining_tpu_torch.experiments.training_time_analytic \\
        --config '{"num_hosts": 1, "chips_per_host": 1, "gpu_type": "h100-sxm", "model": "pythia-1b"}'
"""

from dataclasses import dataclass
from typing import Any

from ..gpus import analytic_peak_tflops
from .base_classes import Experiment
from .cache import step
from .config import BaseConfig, TrainingConfig
from .count_flops import CountFlopsExperiment, training_flops


@step(cacheable=True, version="001")
def estimate_training_days_from_flops(total_flops: float, config: TrainingConfig, assumed_mfu: float = 1.0) -> float:
    model_class = config.model_class()
    peak = analytic_peak_tflops(config.gpu_type, model_class.mixed_precision, config.free_lunch)
    flops_per_day = config.num_chips * peak * 1e12 * assumed_mfu * 86400
    return total_flops / flops_per_day


@dataclass
class TrainingTimeAnalytic(Experiment):
    config: TrainingConfig = None  # type: ignore[assignment]
    assumed_mfu: float = 1.0

    def to_dict(self) -> dict[str, Any]:
        return {**self.config.__dict__, "assumed_mfu": self.assumed_mfu}

    def _base(self) -> BaseConfig:
        c = self.config
        return BaseConfig(num_hosts=c.num_hosts, chips_per_host=c.chips_per_host, gpu_type=c.gpu_type, model=c.model)

    @property
    def dependencies(self):
        return [CountFlopsExperiment(config=self._base())]

    @property
    def step_dict(self):
        flops = training_flops(config=self._base())
        return {
            "training_days": estimate_training_days_from_flops(
                total_flops=flops, config=self.config, assumed_mfu=self.assumed_mfu
            )
        }

    def results(self):
        return {"training_days": self.step_result("training_days")}


if __name__ == "__main__":
    TrainingTimeAnalytic.cli()
