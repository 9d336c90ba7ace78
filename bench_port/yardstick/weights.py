"""Seeded weights, made on the device in one draw.

Every leaf that starts random takes its slice of one of two buffers drawn in
one call each: standard normals in the type the weights are served in,
scaled in place by the leaf's standard deviation, or float32 uniforms in
[0, 1), mapped to the leaf's interval or law; the others are constants. The program and the
plain reference both start from these tensors, each making them itself
from the seed, so nothing passes from one to the other.
"""

import math

import torch

from .data import SEED_MASK


def weight_seed(seed: int) -> int:
    """The generator seed of a run's weights: the run's seed in 63 bits."""
    return (seed & SEED_MASK) % (1 << 63)


def make_weights(spec: list[tuple[str, tuple, tuple]], seed: int, device, dtype=torch.bfloat16) -> dict:
    """``spec``: (name, shape, init) per leaf, init one of ("normal", std),
    ("uniform", bound) (uniform in [-bound, bound)), ("inv_softplus_loguniform",
    lo, hi) (the inverse softplus of a draw log-uniform in [lo, hi], as
    mamba_ssm starts its dt bias), ("const", value) or ("log_arange",) (row i
    of [R, N] holds log(1..N)). Returns name -> tensor; the normal leaves are
    views into one buffer."""
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    count = sum(math.prod(shape) for _, shape, init in spec if init[0] == "normal")
    buf = torch.randn(count, generator=gen, device=device, dtype=dtype)
    ucount = sum(math.prod(shape) for _, shape, init in spec if init[0] in ("uniform", "inv_softplus_loguniform"))
    ubuf = torch.rand(ucount, generator=gen, device=device, dtype=torch.float32)
    out, offset, uoffset = {}, 0, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init[0] == "normal":
            out[name] = buf[offset:offset + n].view(shape).mul_(init[1])
            offset += n
        elif init[0] in ("uniform", "inv_softplus_loguniform"):
            u = ubuf[uoffset:uoffset + n].view(shape)
            uoffset += n
            if init[0] == "uniform":
                out[name] = (u * (2 * init[1]) - init[1]).to(dtype)
            else:
                lo, hi = math.log(init[1]), math.log(init[2])
                dt = torch.exp(u * (hi - lo) + lo).clamp_min(1e-4)
                out[name] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        elif init[0] == "const":
            out[name] = torch.full(shape, float(init[1]), dtype=dtype, device=device)
        elif init[0] == "log_arange":
            row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device))
            out[name] = row.expand(shape).to(dtype).contiguous()
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out
