"""Spans at the port's layer boundaries, on the profiler's own clock.

A span is a ``torch.profiler.record_function`` annotation: it lands in the
profiler's chrome trace beside the kernels, and a reader matches a kernel
to it by the time its launch starts, on any thread. An active profiler is
the only switch. With none active, ``span`` is a ``nullcontext`` and
``backward_span`` registers nothing, so the arithmetic and the autograd
graph are those of the code without spans.

The spans the port records:

- ``step.forward``, ``step.backward``: a micro-batch's forward and backward
  (``training/step.py``); autograd launches the backward from a thread of
  its own while the span's thread waits for it;
- ``remat.replay``: one block's recompute in the backward
  (``models/layers.py`` ``remat``);
- ``xent.forward``, ``xent.backward``: the chunked LM-head loss, its chunk
  recomputes included (``ops/xent.py``);
- ``scan.forward``, ``scan.backward``: the selective scan, its forward in
  a block's replay included (``ops/selective_scan.py``), and the backward
  op with the D skip's terms, at d_state 16 in the kernel's epilogue
  (``ops/selective_scan_fused.py``);
- ``attn.forward``, ``attn.backward``: a ``SelfAttention``, its
  projections included (``models/layers.py``);
- ``mlp.forward``, ``mlp.backward``: an ``Mlp`` or a ``GatedMlp``
  (``models/layers.py``);
- ``mamba.forward``, ``mamba.backward``: a Mamba mixer, ``in_proj``
  through ``out_proj``, with the scan's spans inside (``models/mamba.py``);
- ``ipot``: ViLT's optimal-transport iterations (``models/vilt.py``).

Under remat a block's forward spans fire again inside its
``remat.replay``, and the replay itself runs inside the backward span of
the first region whose backward reads a recomputed tensor.
"""

import contextlib
import threading

import torch
import torch.autograd.profiler as _autograd_profiler


class _Replaying(threading.local):
    """How many block recomputes this thread is inside (``replay_span``)."""

    depth = 0


_REPLAYING = _Replaying()


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler is
    recording, else a no-op."""
    return torch.profiler.record_function(name) if profiling() else contextlib.nullcontext()


@contextlib.contextmanager
def replay_span():
    """The span ``remat.replay`` around one block's recompute in the
    backward (``models/layers.py`` ``remat``). Inside it ``backward_span``
    registers nothing: the recompute's tensors only fill what the first
    pass's graph saved, and no gradient flows through them."""
    _REPLAYING.depth += 1
    try:
        with span("remat.replay"):
            yield
    finally:
        _REPLAYING.depth -= 1


def backward_span(name: str, out: torch.Tensor, inp: torch.Tensor) -> None:
    """Span ``name`` over the backward of the region that computed ``out``
    from ``inp``: a hook on ``out``'s gradient opens it, one on ``inp``'s
    closes it, both on the thread autograd runs the backward on. Only while
    a profiler is recording, outside a block's recompute, and only where
    both need a gradient; otherwise nothing is registered."""
    if not (profiling() and not _REPLAYING.depth and out.requires_grad and inp.requires_grad):
        return
    opened = []

    def open_span(grad):
        if profiling():
            opened.append(torch.profiler.record_function(name).__enter__())

    def close_span(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    out.register_hook(open_span)
    inp.register_hook(close_span)
