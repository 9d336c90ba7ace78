"""JAX GPTNeoX param tree -> the port's ``GPTNeoXLM.state_dict()``.

The JAX model scans its blocks, so every block leaf carries a leading layer
axis ``L``; the port holds one module per block. Dense kernels are [in, out]
in flax and [out, in] in ``nn.Linear``, so they are transposed. ``embed_out``
keeps the JAX [H, V] layout. The qkv output layout, [q (h*d) | k | v]
head-major, is the same on both sides and needs no permutation.

The function takes numpy arrays (``np.asarray`` of each JAX leaf) and never
imports JAX. It maps any tree of that structure, so it converts a gradient
tree as well as a param tree.
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
