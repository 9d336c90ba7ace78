"""Total training FLOPs (counterpart of ``experiments/count_flops.py``).

total_training_flops = flops_per_example x batch_size x training_steps,
with one example's forward and backward counted as they run on the card
(``benchmarking/flops.py``'s ``count_flops_per_example``); the token count
is examples x sequence_length for models that have one.

    python -m multimodal_llm_pretraining_tpu_torch.experiments.count_flops \\
        --config '{"num_hosts": 1, "chips_per_host": 1, "gpu_type": "h100-sxm", "model": "pythia-1b"}'
"""

from dataclasses import dataclass
from typing import Any

from ..benchmarking.flops import count_flops_per_example
from .base_classes import Experiment
from .cache import step
from .config import BaseConfig


@step(cacheable=True, version="001")
def training_flops(config: BaseConfig, device: str = "cuda") -> float:
    """``device``: where the counted step runs (the card unless the caller
    asks for the CPU, as the tests do)."""
    model_class = config.model_class()
    per_example = count_flops_per_example(model_class, device=device)
    return per_example * model_class.batch_size * model_class.training_steps


@step(cacheable=True, version="001")
def training_examples(config: BaseConfig) -> int:
    model_class = config.model_class()
    return model_class.batch_size * model_class.training_steps


@step(cacheable=True, version="001")
def training_tokens(config: BaseConfig) -> int | None:
    model_class = config.model_class()
    seq = getattr(model_class, "sequence_length", None)
    if seq is None:
        return None
    return model_class.batch_size * model_class.training_steps * seq


@dataclass
class CountFlopsExperiment(Experiment):
    config: BaseConfig = None  # type: ignore[assignment]

    def to_dict(self) -> dict[str, Any]:
        return dict(self.config.__dict__)

    @property
    def step_dict(self):
        return {
            "training_flops": training_flops(config=self.config),
            "training_examples": training_examples(config=self.config),
            "training_tokens": training_tokens(config=self.config),
        }


if __name__ == "__main__":
    CountFlopsExperiment.cli()
