"""Device time of a micro-batch's Mamba mixers, forward and backward: the
kernels, copies and sets launched inside the port's ``mamba.forward`` spans
(each ``MambaMixer`` call in ``models/mamba.py``, in_proj through out_proj,
the scan's spans inside; a block's replay under remat included) and
``mamba.backward`` spans, summed over the profiled stretch and divided by
its ``compared_accumulation`` micro-batches (``yardstick/layer_time.py``).
None where the port records no such span."""

from bench_port.yardstick.layer_time import layer_ms


def read(r):
    return layer_ms(r, "mamba")
