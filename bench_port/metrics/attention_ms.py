"""Device time of a micro-batch's attention layers, forward and backward:
the kernels, copies and sets launched inside the port's ``attn.forward``
spans (each ``SelfAttention`` call in ``models/layers.py``: its projections,
the KV heads' repeat and the flash kernels; a block's replay under remat
included) and ``attn.backward`` spans, summed over the profiled stretch and
divided by its ``compared_accumulation`` micro-batches
(``yardstick/layer_time.py``). None where the port records no such span."""

from bench_port.yardstick.layer_time import layer_ms


def read(r):
    return layer_ms(r, "attn")
