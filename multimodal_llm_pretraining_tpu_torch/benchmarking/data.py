"""Synthetic benchmark datasets (counterpart of ``benchmarking/data.py:13-52``).

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
