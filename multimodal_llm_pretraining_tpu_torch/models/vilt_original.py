"""ViLT on the stock ViLT-B/32 trunk (counterpart of ``models/vilt_original.py``).

The multi-task model of ``vilt.py`` (MLM + ITM + WPA; finetune MLM only) on
dandelin/vilt-b32-mlm's widths: hidden 768, 12 layers, 12 heads of 64, ffn
3072, patch 32 (49 patches and the class token at 224 px), vocab 30,522,
BERT-width text embeddings (768, projected 768 -> 768). Recipe: batch 128,
6,540 steps (pretrain) / 5,197 (finetune), f32, AdamW 1e-4 with weight decay
0.01, linear schedule with 10% warmup.
"""

from .vilt import _ViltBase

_ORIGINAL_KWARGS = dict(
    hidden=768,
    num_layers=12,
    num_heads=12,
    intermediate=3072,
    patch=32,
    vocab_size=30522,
    token_embed_dim=768,
)


class ViltOriginalPretrainModelClass(_ViltBase):
    module_kwargs = _ORIGINAL_KWARGS

    @property
    def training_steps(self) -> int:
        return 6540

    @property
    def vocab_size(self) -> int:
        return 30522


class ViltOriginalFinetuneModelClass(_ViltBase):
    module_kwargs = _ORIGINAL_KWARGS
    target_tasks = ("mlm",)

    @property
    def training_steps(self) -> int:
        return 5197

    @property
    def vocab_size(self) -> int:
        return 30522
