"""The plain reference's training steps: the same weights and batches as
the program's first steps, each made anew from the seed, the gradient of
each micro-batch taken in blocks of rows, then the configuration's
optimizer. Imports nothing of the measured program.
"""

import importlib

import torch

from ..yardstick.data import token_batch
from ..yardstick.weights import make_weights, weight_seed
from .common import AdamSR, no_tf32

SR_SEED_SALT = 0x5EED  # the reference's rounding bits are its own, not the program's


def model_of(cfg: dict):
    """The plain model of the configuration's family: ``reference/<family>.py``."""
    return importlib.import_module(f"{__package__}.{cfg['family']}")


def init_spec(cfg: dict):
    return model_of(cfg).init_spec(cfg)


def train_steps(cfg: dict, wl: dict, seed: int, device, precision: str, steps: int, log=None) -> dict:
    """Run ``steps`` updates of ``wl``'s micro-batches x compared
    accumulation from the seeded weights. Returns the mean loss of each step, the leaf norms of
    the first update's gradient (clipped, with L2 decay where the optimizer
    adds it, as the optimizer takes it) and of each leaf's change over the
    steps."""
    model = model_of(cfg)
    mbs, acc, rows = wl["micro_batch_size"], wl["compared_accumulation"], cfg["reference_rows"]
    seq, vocab = cfg["sequence_length"], cfg["data_vocab_size"]
    with no_tf32():
        params = {n: w.float().requires_grad_(True) for n, w in make_weights(init_spec(cfg), seed, device).items()}
        gen = torch.Generator(device=device).manual_seed(weight_seed(seed) ^ SR_SEED_SALT)
        opt = AdamSR(cfg["optimizer"], cfg["num_training_steps"], params, gen)
        losses = []
        for k in range(steps):
            total = 0.0
            for j in range(acc):
                ids = torch.from_numpy(token_batch(seed, k * acc + j, mbs, seq, vocab)).to(device)
                for r0 in range(0, mbs, rows):
                    part = model.loss(params, ids[r0:r0 + rows], cfg, precision)
                    weight = ids[r0:r0 + rows].shape[0] / (mbs * acc)
                    (part * weight).backward()
                    total += float(part.detach()) * ids[r0:r0 + rows].shape[0] / mbs
            losses.append(total / acc)
            grads = {n: p.grad for n, p in params.items()}
            for p in params.values():
                p.grad = None
            opt.step({n: p.data for n, p in params.items()}, grads)
            if log:
                log(f"reference ({precision}) step {k}: loss {losses[-1]:.6f}")
        start = make_weights(init_spec(cfg), seed, device)
        change = {n: float(torch.linalg.vector_norm(params[n].detach() - start[n].float())) for n in params}
    return {"losses": losses, "first_grads": opt.first_grads, "change": change}
