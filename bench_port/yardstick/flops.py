"""Closed-form FLOPs of one sequence's forward and backward, from a
configuration file's sizes.

Products only, 2 FLOPs a multiply-add, the backward twice the forward, and
no recompute (remat's replay and the chunked LM head's recomputed logits are
overhead, not model work). Each family's form is
``flops_per_sequence(cfg)`` in ``flops_<family>.py`` beside this file,
found by the configuration's ``family``.
"""

import importlib

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor-core rate (NVIDIA data sheet, 700 W)


def flops_per_sequence(cfg: dict) -> float:
    """One sequence of the configuration's length, forward and backward."""
    return importlib.import_module(f"{__package__}.flops_{cfg['family']}").flops_per_sequence(cfg)
