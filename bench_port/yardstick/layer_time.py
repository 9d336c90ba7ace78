"""Device time of one kind of the port's layers a micro-batch, from its
spans (``tracing.py``): ``<name>.forward`` around each call, a block's
replay under remat included, and ``<name>.backward`` around each call's
backward. A block's replay runs inside the backward span of the first
region whose backward reads a recomputed tensor (an MLP's, in a layer whose
MLP comes last), so the events of a ``remat.replay`` count only where a
forward span holds them: the replayed MLP in the MLP's time, the replayed
mixer in the mixer's, the replayed norms in neither."""


def layer_ms(r, name: str):
    """Milliseconds a micro-batch in the spans of ``name``; None where the
    program recorded none."""
    forward, backward = r.trace.in_span(f"{name}.forward"), r.trace.in_span(f"{name}.backward")
    if not forward and not backward:
        return None
    replayed = {id(e) for e in r.trace.in_span("remat.replay")}
    events = {id(e): e for e in forward}
    events.update((id(e), e) for e in backward if id(e) not in replayed)
    return sum(e["dur"] for e in events.values()) * 1e-3 / r.workload["compared_accumulation"]
