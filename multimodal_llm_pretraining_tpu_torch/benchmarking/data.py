"""Synthetic benchmark datasets (counterpart of ``benchmarking/data.py:13-92``).

Batches are made on demand from a seeded numpy Generator, with the formula the
JAX package uses when its C++ library is absent
(``native/__init__.py:81``): ``default_rng(seed).integers(0, vocab, ...)``.
"""

import numpy as np


class DummyDataset:
    """Map-style dataset of dict[str, np.ndarray] examples with fast batch
    synthesis (``sample_batch``)."""

    num_samples: int = 50_000

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        batch = self.sample_batch(1, seed=index)
        return {k: v[0] for k, v in batch.items()}

    def sample_batch(self, batch_size: int, seed: int = 0) -> dict[str, np.ndarray]:
        raise NotImplementedError


class DummyTextModelingDataset(DummyDataset):
    """Causal/masked LM fixture: labels == input_ids."""

    def __init__(self, vocab_size: int, sequence_length: int, num_samples: int = 50_000):
        self.vocab_size = vocab_size
        self.sequence_length = sequence_length
        self.num_samples = num_samples

    def sample_batch(self, batch_size: int, seed: int = 0) -> dict[str, np.ndarray]:
        ids = np.random.default_rng(seed).integers(0, self.vocab_size, (batch_size, self.sequence_length), dtype=np.int32)
        return {"input_ids": ids, "labels": ids.copy()}


class DummyImageClassificationDataset(DummyDataset):
    """Image-classification fixture: float32 NHWC pixels in [0, 1) and int32
    labels in [0, num_classes), drawn from ``default_rng(seed)`` in the JAX
    package's order (pixels, then labels)."""

    def __init__(self, image_size: int, num_classes: int, num_samples: int = 20_000):
        self.image_size = image_size
        self.num_classes = num_classes
        self.num_samples = num_samples

    def sample_batch(self, batch_size: int, seed: int = 0) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        return {
            "pixel_values": rng.random((batch_size, self.image_size, self.image_size, 3), dtype=np.float32),
            "labels": rng.integers(0, self.num_classes, (batch_size,), dtype=np.int32),
        }


class DummyMultimodalLanguageModelingDataset(DummyDataset):
    """LLaVA-style fixture: a leading ``<image>`` token then random text, an
    all-ones attention mask and float32 NHWC pixels in [0, 1), drawn from
    ``default_rng(seed)`` in the JAX package's order (text, then pixels)."""

    def __init__(self, vocab_size: int, sequence_length: int, image_size: int, num_samples: int = 20_000,
                 image_token_id: int = 32000):
        self.vocab_size = vocab_size
        self.sequence_length = sequence_length
        self.image_size = image_size
        self.num_samples = num_samples
        self.image_token_id = image_token_id

    def sample_batch(self, batch_size: int, seed: int = 0) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        text = rng.integers(0, self.vocab_size, (batch_size, self.sequence_length - 1), dtype=np.int32)
        ids = np.concatenate([np.full((batch_size, 1), self.image_token_id, np.int32), text], axis=1)
        return {
            "attention_mask": np.ones_like(ids),
            "pixel_values": rng.random((batch_size, self.image_size, self.image_size, 3), dtype=np.float32),
            "input_ids": ids,
            "labels": ids.copy(),
        }
