"""Logger, device sync and the CUDA guard.

Counterpart of ``multimodal_llm_pretraining_tpu/utils``: the named logger is
the same ``"mlpt"`` logger, and ``block_on`` -- a workaround there for a TPU
transport whose ``block_until_ready`` did nothing -- becomes a plain
``torch.cuda.synchronize``.
"""

import logging
import os
import sys

import torch

LOGGER_NAME = "mlpt"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        logger.setLevel(os.environ.get("MLPT_LOG_LEVEL", "INFO"))
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[%(name)s %(asctime)s] %(message)s", datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def block_on(device: torch.device | str | None = None) -> None:
    """Wait until every kernel queued on ``device`` has finished (no-op for
    the CPU, whose ops run synchronously)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError when no GPU is visible. Paths that
    measure or launch kernels call this instead of falling back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())
