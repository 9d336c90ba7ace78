"""The traffic of a causal-LM pretraining cell: full-length sequences of
token ids, drawn uniformly from the vocabulary, labels equal to the ids (the
model shifts them), no padding and no mask: the packed sequences of
pretraining on the Pile.

A copy of the port's ``benchmarking/data.py`` ``random_lm_batch``, except
for the seed: micro-batch ``index`` of a run with seed ``seed`` draws from
``SeedSequence([seed, index])``, so every micro-batch of a run, and every
run's, holds other rows, and one seed always gives the same batches.
"""

import numpy as np

SEED_MASK = (1 << 64) - 1  # a seed of any size or sign, folded into 64 bits


def token_batch(seed: int, index: int, rows: int, seq_len: int, vocab: int) -> np.ndarray:
    """int32 ids [rows, seq_len], uniform in [0, vocab)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed & SEED_MASK, index]))
    return rng.integers(0, vocab, (rows, seq_len), dtype=np.int32)
