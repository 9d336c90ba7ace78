"""PyTorch / CUDA port of ``multimodal_llm_pretraining_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package, so each counterpart is found by name.
The port imports ``torch`` and never ``jax``, ``flax`` or ``optax``; the JAX
package stays the reference the tests hold it against.
"""
