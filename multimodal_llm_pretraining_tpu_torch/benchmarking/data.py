"""Synthetic benchmark datasets (counterpart of ``benchmarking/data.py:13-145``):
text (pythia, mamba, roberta), image classification (vit, convnext),
LLaVA's image-and-text batch and ViLT's multi-task batch.

Batches are made on demand from a seeded numpy Generator, with the formulas
the JAX package uses when its C++ library is absent
(``native/__init__.py:78-97``), copied here as ``random_lm_batch`` and
``mlm_corrupt``. Where the JAX package loads its library it draws other
numbers from the same seed, so a test across the packages shares the batch,
or the seed with the JAX library made unavailable.
"""

import numpy as np


def random_lm_batch(seed: int, vocab: int, batch: int, seq_len: int) -> np.ndarray:
    """int32 ids [batch, seq_len] uniform in [0, vocab)."""
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq_len), dtype=np.int32)


def mlm_corrupt(ids: np.ndarray, prob: float, mask_token: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Each position masked with probability ``prob``: the corrupted ids
    (``mask_token`` there) and the labels (the original id there, -100
    elsewhere), both int32."""
    m = np.random.default_rng(seed).random(ids.shape) < prob
    return np.where(m, mask_token, ids).astype(np.int32), np.where(m, ids, -100).astype(np.int32)


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
        ids = random_lm_batch(seed, self.vocab_size, batch_size, self.sequence_length)
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


class DummyMultimodalLanguageModelingForViltDataset(DummyDataset):
    """ViLT multi-task fixture: the plain, ``mlm_`` and ``itm_`` input
    triples over one image batch, 15% of the MLM ids corrupted, and random
    ITM labels. Drawn in the JAX package's order: ids from ``seed``, then
    pixels and the ITM labels from ``default_rng(seed)``, the corruption
    from ``seed + 1``."""

    def __init__(
        self,
        vocab_size: int,
        sequence_length: int,
        image_size: int,
        num_samples: int = 20_000,
        percentage_masked: float = 0.15,
        mask_token: int = 128255,
    ):
        self.vocab_size = vocab_size
        self.sequence_length = sequence_length
        self.image_size = image_size
        self.num_samples = num_samples
        self.percentage_masked = percentage_masked
        self.mask_token = mask_token

    def sample_batch(self, batch_size: int, seed: int = 0) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        ids = random_lm_batch(seed, self.vocab_size, batch_size, self.sequence_length)
        images = rng.random((batch_size, self.image_size, self.image_size, 3), dtype=np.float32)
        mlm_ids, mlm_labels = mlm_corrupt(ids, self.percentage_masked, self.mask_token, seed + 1)
        ones = np.ones_like(ids)
        zeros = np.zeros_like(ids)
        pixel_mask = np.ones((batch_size, self.image_size, self.image_size), np.int32)
        return {
            "input_ids": ids,
            "attention_mask": ones,
            "token_type_ids": zeros,
            "pixel_values": images,
            "pixel_mask": pixel_mask,
            "labels": ids.copy(),
            "mlm_input_ids": mlm_ids,
            "mlm_attention_mask": ones,
            "mlm_token_type_ids": zeros,
            "mlm_pixel_values": images,
            "mlm_pixel_mask": pixel_mask,
            "mlm_labels": mlm_labels,
            "itm_input_ids": ids,
            "itm_attention_mask": ones,
            "itm_token_type_ids": zeros,
            "itm_pixel_values": images,
            "itm_pixel_mask": pixel_mask,
            "itm_labels": (rng.random(batch_size) < 0.5).astype(np.int32),
        }
