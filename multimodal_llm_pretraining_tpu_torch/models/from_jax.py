"""JAX param trees -> the port's state dicts: GPTNeoX (``params_from_jax``),
Mamba (``mamba_params_from_jax``), LLaVA (``llava_params_from_jax``), ViT
(``vit_params_from_jax``), ViLT (``vilt_params_from_jax``), RoBERTa
(``roberta_params_from_jax``) and ConvNeXt (``convnext_params_from_jax``).

The JAX model scans its blocks, so every block leaf carries a leading layer
axis ``L``; the port holds one module per block. Dense kernels are [in, out]
in flax and [out, in] in ``nn.Linear``, so they are transposed. ``embed_out``
keeps the JAX [H, V] layout. The qkv output layout, [q (h*d) | k | v]
head-major, is the same on both sides and needs no permutation.

Mamba's leaves follow the same rules: stacked ``layers/...`` leaves split
per block, Dense kernels transposed, and ``conv_weight`` [L, d_conv, d_inner]
kept in the JAX layout the port's block stores.

LLaVA's tree has two stacks, ``vision_tower/layers/...`` and
``language_model/layers/...``, each split per block; every other leaf keeps
its path with ``/`` as ``.``. RMSNorm and LayerNorm ``scale`` become
``.weight``, Dense kernels are transposed into ``.weight``, and
``language_model_embed_tokens``, ``class_embedding`` and
``position_embeddings`` keep their layout. ViT's tree follows the same
rules with one stack, ``layers/...``; ``cls_token`` and
``position_embeddings`` keep their layout.

ViLT's and RoBERTa's trees follow them too: ViLT's trunk stack is
``vilt/layers/...``, its ``patch_embed`` is a Dense with a bias (CLIP's has
none), and ``mlm_decoder`` keeps its JAX [H, V] layout, as ``embed_out``
does; RoBERTa's decoder is tied to ``word_embeddings`` and has no leaf of
its own. ConvNeXt's stacks are ``stage_i/...``, split into ``stage_i.j``,
and a flax ``Conv`` kernel [kh, kw, in / groups, out] becomes PyTorch's
[out, in / groups, kh, kw].

The functions take numpy arrays (``np.asarray`` of each JAX leaf) and never
import JAX. They map any tree of that structure, so they convert a
gradient tree as well as a param tree.
"""

import numpy as np
import torch

_DENSE = (("attn", "qkv"), ("attn", "out"), ("mlp", "up"), ("mlp", "down"))


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16, which torch.from_numpy cannot take
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    layers = tree["layers"]
    num_layers = np.asarray(layers["ln_attn"]["scale"]).shape[0]
    out = {"embed_in.weight": _t(tree["embed_in"]["embedding"])}
    for i in range(num_layers):
        for ln in ("ln_attn", "ln_mlp"):
            out[f"layers.{i}.{ln}.weight"] = _t(np.asarray(layers[ln]["scale"])[i])
            out[f"layers.{i}.{ln}.bias"] = _t(np.asarray(layers[ln]["bias"])[i])
        for parent, name in _DENSE:
            leaf = layers[parent][name]
            out[f"layers.{i}.{parent}.{name}.weight"] = _t(np.asarray(leaf["kernel"])[i].T)
            out[f"layers.{i}.{parent}.{name}.bias"] = _t(np.asarray(leaf["bias"])[i])
    out["final_ln.weight"] = _t(tree["final_ln"]["scale"])
    out["final_ln.bias"] = _t(tree["final_ln"]["bias"])
    out["embed_out"] = _t(tree["embed_out"])
    return out


_MAMBA_DENSE = ("in_proj", "x_proj", "dt_proj", "out_proj")
_MAMBA_LEAVES = ("conv_weight", "conv_bias", "A_log", "D")


def mamba_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    layers = tree["layers"]
    num_layers = np.asarray(layers["norm"]["scale"]).shape[0]
    out = {"embedding": _t(tree["embedding"])}
    for i in range(num_layers):
        out[f"layers.{i}.norm.weight"] = _t(np.asarray(layers["norm"]["scale"])[i])
        for name in _MAMBA_DENSE:
            out[f"layers.{i}.{name}.weight"] = _t(np.asarray(layers[name]["kernel"])[i].T)
            if "bias" in layers[name]:
                out[f"layers.{i}.{name}.bias"] = _t(np.asarray(layers[name]["bias"])[i])
        for name in _MAMBA_LEAVES:
            out[f"layers.{i}.{name}"] = _t(np.asarray(layers[name])[i])
    out["final_norm.weight"] = _t(tree["final_norm"]["scale"])
    return out


def _is_stack(key: str) -> bool:
    return key == "layers" or key.startswith("stage_")


def _split_leaves(tree: dict, prefix: str, out: dict, layer: int | None = None) -> None:
    """Every stack (``layers/...``, ConvNeXt's ``stage_i/...``) split per
    block, Dense kernels transposed and conv kernels permuted, norm scales as
    weights, every other leaf kept, paths joined by ``.``."""
    for key, val in tree.items():
        if isinstance(val, dict):
            if _is_stack(key) and layer is None:
                first = val
                while isinstance(first, dict):
                    first = next(iter(first.values()))
                for i in range(np.asarray(first).shape[0]):
                    _split_leaves(val, f"{prefix}{key}.{i}.", out, i)
            else:
                _split_leaves(val, f"{prefix}{key}.", out, layer)
            continue
        a = np.asarray(val) if layer is None else np.asarray(val)[layer]
        if key == "kernel":
            out[prefix + "weight"] = _t(a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1))
        elif key == "scale":
            out[prefix + "weight"] = _t(a)
        else:
            out[prefix + key] = _t(a)


def llava_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    _split_leaves(tree, "", out)
    return out


vit_params_from_jax = llava_params_from_jax
vilt_params_from_jax = llava_params_from_jax
roberta_params_from_jax = llava_params_from_jax
convnext_params_from_jax = llava_params_from_jax
