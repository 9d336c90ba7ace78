"""Device time of a micro-batch's MLPs, forward and backward: the kernels,
copies and sets launched inside the port's ``mlp.forward`` spans (each
``Mlp`` or ``GatedMlp`` call in ``models/layers.py``; a block's replay under
remat included) and ``mlp.backward`` spans, summed over the profiled
stretch and divided by its ``compared_accumulation`` micro-batches
(``yardstick/layer_time.py``). None where the port records no such span."""

from bench_port.yardstick.layer_time import layer_ms


def read(r):
    return layer_ms(r, "mlp")
