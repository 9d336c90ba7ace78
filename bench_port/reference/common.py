"""What the plain references share: products at a stated precision, the
norms, the LM loss, and the optimizer of the ``bf16_sr`` state layout.

Everything runs in float32 except the operands of the products, which are
rounded to the precision the reference is asked for:

- "f32": float32 operands (TF32 must be off: ``no_tf32``).
- "bf16": bfloat16 operands, float32 accumulation and output, which is what
  a configuration that computes in bf16 asks of a tensor core.
- "fp8": float8 e4m3 operands, each tensor scaled by a power of two that
  puts its largest magnitude at or under e4m3's 448, then the bf16 path
  (e4m3 values times a power of two are exact in bf16). This is the
  control: the precision below bf16.

The backward of a product rounds its incoming gradient and operands the
same way before its two products.
"""

import contextlib
import math

import torch

PRECISIONS = ("f32", "bf16", "fp8")
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32, not TF32, inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return t.float()
    if precision == "bf16":
        return t.to(torch.bfloat16)
    if precision == "fp8":
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = torch.exp2(torch.ceil(torch.log2(amax / FP8_MAX)))
        return ((t.float() / scale).to(torch.float8_e4m3fn).to(torch.bfloat16) * scale.to(torch.bfloat16))
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b (2-D, or batched 3-D) in float32, from operands rounded to
    ``precision``."""
    a, b = round_operand(a, precision), round_operand(b, precision)
    if precision == "f32":
        return a @ b
    if a.is_cuda:
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()  # a product of two bf16 values is exact in f32


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _product(a, b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        da = _product(g, b.transpose(-1, -2), p) if ctx.needs_input_grad[0] else None
        db = _product(a.transpose(-1, -2), g, p) if ctx.needs_input_grad[1] else None
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """[..., M, K] @ [K, N] (a weight), or batched [..., M, K] @ [..., K, N]
    with the same leading dims; float32 out."""
    if b.dim() == 2:
        lead = a.shape[:-1]
        return _Matmul.apply(a.reshape(-1, a.shape[-1]), b, precision).reshape(*lead, b.shape[1])
    lead = a.shape[:-2]
    out = _Matmul.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]), precision)
    return out.reshape(*lead, *out.shape[-2:])


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, precision: str) -> torch.Tensor:
    """x @ weight.T + bias, weight [out, in]."""
    y = matmul(x, weight.t(), precision)
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def shifted_lm_loss(hidden: torch.Tensor, head: torch.Tensor, ids: torch.Tensor, precision: str):
    """Mean cross entropy of predicting token t + 1 from position t, over
    every position of every row. ``head`` is [H, V], every column in the
    softmax (a padded vocabulary's too, as the model's own)."""
    logits = matmul(hidden[:, :-1], head, precision)
    labels = ids[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


# ------------------------------------------------------------------ optimizer


def learning_rate(opt: dict, num_training_steps: int, count: int) -> float:
    """The configuration's schedule at ``count`` (1 at the first update):
    linear warmup from 0 over ``warmup`` steps, capped at
    ``num_training_steps - 1`` as a run of that many steps caps it, then a
    cosine from the peak to ``min_lr`` (or ``min_lr_rate`` x peak) over the
    remaining steps, held at its end after them."""
    peak = opt["lr"]
    warmup = min(int(opt["warmup_steps"]), max(num_training_steps - 1, 0))
    end = opt["min_lr"] if "min_lr" in opt else peak * opt.get("min_lr_rate", 0.0)
    if count < warmup:
        return peak * count / max(warmup, 1)
    decay = num_training_steps - warmup
    c = min(count - warmup, decay)
    alpha = end / peak if peak else 0.0
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)


class AdamSR:
    """Adam of the ``bf16_sr`` layout, as the configuration states it: the
    gradient clipped to a global norm, weight decay into the gradient
    ("adam") or decoupled ("adamw"), moments computed in float32 and stored
    rounded to bf16, and each parameter, stored in bf16, set to its float32
    update rounded stochastically to bf16 (16 random bits added to the bit
    pattern, the low 16 dropped). The bits come from the reference's own
    generator."""

    def __init__(self, opt: dict, num_training_steps: int, params: dict[str, torch.Tensor], generator: torch.Generator):
        self.opt, self.num_training_steps = opt, num_training_steps
        self.mu = {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.bfloat16) for n, p in params.items()}
        self.count = 0
        self.generator = generator
        self.first_grads: dict[str, float] | None = None  # leaf norms of the first update's gradient

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        """``params`` hold bf16 values in float32 tensors and are updated in
        place; ``grads`` are the float32 mean gradients and are consumed."""
        opt = self.opt
        b1, b2 = opt["betas"]
        eps, wd = opt.get("eps", 1e-8), opt.get("weight_decay", 0.0)
        decoupled = opt["kind"] == "adamw"
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(opt["max_grad_norm"] / (norm + 1e-16), max=1.0)
        self.count += 1
        lr = learning_rate(opt, self.num_training_steps, self.count)
        bc1, bc2 = 1 - b1**self.count, 1 - b2**self.count
        first = {} if self.first_grads is None else None
        for name, p in params.items():
            g = grads.pop(name) * scale
            if wd and not decoupled:
                g = g + wd * p
            m = b1 * self.mu[name].float() + (1 - b1) * g
            v = b2 * self.nu[name].float() + (1 - b2) * g.square()
            if first is not None:
                first[name] = float(torch.linalg.vector_norm(m)) / (1 - b1)
            d = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd and decoupled:
                d = d + wd * p
            self.mu[name].copy_(m)
            self.nu[name].copy_(v)
            p.copy_(stochastic_round(p - lr * d, self.generator))
        if first is not None:
            self.first_grads = first


def stochastic_round(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """float32 -> a bf16 value (returned in float32), rounded up with the
    probability of the dropped fraction."""
    bits = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device, dtype=torch.int32)
    return ((x.float().contiguous().view(torch.int32) + bits) & -65536).view(torch.float32)
