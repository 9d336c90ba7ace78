"""Model zoo contract (counterpart of ``models/__init__.py:81-220,275``).

Same model-type literals, in the same order, and per-model recipe
properties as the JAX package; ``build_model`` returns a :class:`ModelBundle`
holding a ``torch.nn.Module`` and its loss function. Every family of the
JAX package is ported: RoBERTa, Pythia, Mamba, ConvNeXt, ViT, LLaVA and
ViLT (the CLIP-g trunk and the original B/32 one). ``MODEL_TYPES`` stays the
JAX package's; ``PORT_ONLY_MODEL_TYPES`` holds what the port adds beside it
(AI21-Jamba2-3B, ``models/jamba.py``; IBM granite-4.0-h-micro,
``models/granite.py``).
"""

import enum
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Generic, Literal, TypeVar, get_args

import torch

from ..benchmarking.data import (
    DummyDataset,
    DummyImageClassificationDataset,
    DummyMultimodalLanguageModelingDataset,
    DummyMultimodalLanguageModelingForViltDataset,
    DummyTextModelingDataset,
)

RobertaT = Literal["roberta"]

PythiaT = Literal[
    "pythia-14m",
    "pythia-31m",
    "pythia-70m",
    "pythia-160m",
    "pythia-410m",
    "pythia-1b",
    "pythia-1.4b",
    "pythia-2.8b",
    "pythia-6.9b",
    "pythia-12b",
]

MambaT = Literal["mamba"]

ConvNextT = Literal["convnext-large-1k", "convnext-large-22k", "convnext-xlarge-22k"]

ViTT = Literal["vit"]

LlavaT = Literal["llava-pretrain", "llava-finetune"]

ViltT = Literal["vilt-pretrain", "vilt-finetune", "vilt-original-pretrain", "vilt-original-finetune"]

ModelT = str

# the JAX package's MODEL_TYPES, in its order
MODEL_TYPES: tuple[str, ...] = tuple(
    t for family in (RobertaT, PythiaT, MambaT, ConvNextT, ViTT, LlavaT, ViltT) for t in get_args(family)
)

JambaT = Literal["jamba2-3b"]

GraniteT = Literal["granite-4.0-h-micro"]

# the port's own model types, which the JAX package does not have
PORT_ONLY_MODEL_TYPES: tuple[str, ...] = get_args(JambaT) + get_args(GraniteT)


class SchedulerType(str, enum.Enum):
    """LR schedules used by the zoo: linear, cosine, cosine_with_min_lr."""

    LINEAR = "linear"
    COSINE = "cosine"
    COSINE_WITH_MIN_LR = "cosine_with_min_lr"


OptimizerT = Literal["adam", "adamw"]  # torch.optim.{Adam,AdamW} semantics


@dataclass
class ModelBundle:
    """What ``build_model`` returns.

    ``module`` holds the parameters (uninitialised until the session's
    ``init_state`` fills them from a generator or a converted state dict).
    ``loss_fn(module, batch, generator=None)`` returns ``(scalar_loss,
    metrics_dict)``; a model with dropout (ViT, RoBERTa) draws its masks from
    ``generator`` and is deterministic without one, the others ignore it.
    ``init_fn(module, generator)`` draws fresh parameters in place.
    ``trainable_mask`` maps each of the module's parameter names to whether
    it trains (LLaVA's frozen tower and LM); None means every parameter
    trains.
    """

    module: torch.nn.Module
    loss_fn: Callable
    init_fn: Callable
    trainable_mask: dict[str, bool] | None = None


T = TypeVar("T", bound=ModelT)


class BaseModelClass(ABC, Generic[T]):
    """Defines a model and its pretraining recipe."""

    def __init__(self, model_type: T) -> None:
        self.model_type: T = model_type

    @abstractmethod
    def build_model(
        self,
        use_custom_kernels: bool = True,
        activation_checkpointing: bool = False,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str = "cuda",
    ) -> ModelBundle:
        """``use_custom_kernels`` selects the hand-written kernels (flash
        attention, selective scan) over their plain eager paths."""
        raise NotImplementedError

    @property
    def supports_activation_checkpointing(self) -> bool:
        return True

    @property
    def supports_compilation(self) -> bool:
        return True

    @property
    @abstractmethod
    def batch_size(self) -> int:
        raise NotImplementedError

    @property
    @abstractmethod
    def training_steps(self) -> int:
        raise NotImplementedError

    @property
    @abstractmethod
    def mixed_precision(self) -> Literal[None, "bf16", "fp16"]:
        """None = fp32 compute; "bf16" and "fp16" both run as bf16 compute,
        as in the JAX package."""
        raise NotImplementedError

    @property
    @abstractmethod
    def optimizer(self) -> OptimizerT:
        raise NotImplementedError

    @property
    @abstractmethod
    def optimizer_kwargs(self) -> dict[str, Any]:
        """lr / betas / eps / weight_decay. "adam" applies weight decay as L2
        into the gradient; "adamw" decouples it."""
        raise NotImplementedError

    @property
    @abstractmethod
    def scheduler_type(self) -> SchedulerType:
        raise NotImplementedError

    @property
    @abstractmethod
    def scheduler_kwargs(self) -> dict[str, Any]:
        raise NotImplementedError

    @property
    @abstractmethod
    def max_grad_norm(self) -> float:
        """0.0 disables clipping."""
        raise NotImplementedError

    @property
    def extra_training_args(self) -> dict[str, Any]:
        return {}

    @property
    def fsdp_layers_to_wrap(self) -> list[str]:
        return []

    @abstractmethod
    def load_dummy_dataset(self) -> DummyDataset:
        raise NotImplementedError


class LanguageModelClass(Generic[T], BaseModelClass[T]):
    @property
    @abstractmethod
    def vocab_size(self) -> int:
        raise NotImplementedError

    @property
    @abstractmethod
    def sequence_length(self) -> int:
        raise NotImplementedError

    def load_dummy_dataset(self) -> DummyDataset:
        return DummyTextModelingDataset(vocab_size=self.vocab_size, sequence_length=self.sequence_length)


class VisionModelClass(Generic[T], BaseModelClass[T]):
    @property
    @abstractmethod
    def image_size(self) -> int:
        raise NotImplementedError

    @property
    @abstractmethod
    def num_classes(self) -> int:
        raise NotImplementedError

    def load_dummy_dataset(self) -> DummyDataset:
        return DummyImageClassificationDataset(image_size=self.image_size, num_classes=self.num_classes)


class MultimodalModelClass(Generic[T], BaseModelClass[T]):
    @property
    @abstractmethod
    def vocab_size(self) -> int:
        raise NotImplementedError

    @property
    @abstractmethod
    def sequence_length(self) -> int:
        raise NotImplementedError

    @property
    @abstractmethod
    def image_size(self) -> int:
        raise NotImplementedError

    def load_dummy_dataset(self, sequence_length: int = 512) -> DummyDataset:
        # multimodal models are benchmarked at seq 512 whatever their
        # declared max sequence length, as in the JAX package
        if self.model_type.startswith("vilt"):
            return DummyMultimodalLanguageModelingForViltDataset(
                vocab_size=self.vocab_size,
                sequence_length=sequence_length,
                image_size=self.image_size,
                # the Llama mask token 128255, clamped into the 30522-row
                # vocab of the original ViLT
                mask_token=min(128255, self.vocab_size - 1),
            )
        return DummyMultimodalLanguageModelingDataset(
            vocab_size=self.vocab_size,
            sequence_length=sequence_length,
            image_size=self.image_size,
            image_token_id=getattr(self, "image_token_index", 32000),
        )


def get_model_class(model_type: ModelT) -> BaseModelClass:
    if model_type == "roberta":
        from .roberta import RobertaModelClass

        return RobertaModelClass(model_type)
    if model_type.startswith("pythia"):
        from .pythia import PYTHIA_SIZES, PythiaModelClass

        if model_type not in PYTHIA_SIZES:
            raise ValueError(f"unknown model type: {model_type}")
        return PythiaModelClass(model_type)
    if model_type == "mamba":
        from .mamba import MambaModelClass

        return MambaModelClass(model_type)
    if model_type == "llava-pretrain":
        from .llava import LlavaPretrainModelClass

        return LlavaPretrainModelClass(model_type)
    if model_type == "llava-finetune":
        from .llava import LlavaFinetuneModelClass

        return LlavaFinetuneModelClass(model_type)
    if model_type in get_args(ConvNextT):
        from .convnext import ConvNextModelClass

        return ConvNextModelClass(model_type)
    if model_type == "vit":
        from .vit import ViTModelClass

        return ViTModelClass(model_type)
    if model_type == "vilt-pretrain":
        from .vilt import ViltPretrainModelClass

        return ViltPretrainModelClass(model_type)
    if model_type == "vilt-finetune":
        from .vilt import ViltFinetuneModelClass

        return ViltFinetuneModelClass(model_type)
    if model_type == "vilt-original-pretrain":
        from .vilt_original import ViltOriginalPretrainModelClass

        return ViltOriginalPretrainModelClass(model_type)
    if model_type == "vilt-original-finetune":
        from .vilt_original import ViltOriginalFinetuneModelClass

        return ViltOriginalFinetuneModelClass(model_type)
    if model_type == "jamba2-3b":
        from .jamba import JambaModelClass

        return JambaModelClass(model_type)
    if model_type == "granite-4.0-h-micro":
        from .granite import GraniteModelClass

        return GraniteModelClass(model_type)
    raise ValueError(f"unknown model type: {model_type}")


__all__ = [
    "ModelT",
    "MODEL_TYPES",
    "PORT_ONLY_MODEL_TYPES",
    "RobertaT",
    "PythiaT",
    "MambaT",
    "ConvNextT",
    "ViTT",
    "LlavaT",
    "ViltT",
    "JambaT",
    "GraniteT",
    "ModelBundle",
    "SchedulerType",
    "OptimizerT",
    "BaseModelClass",
    "LanguageModelClass",
    "VisionModelClass",
    "MultimodalModelClass",
    "get_model_class",
]
