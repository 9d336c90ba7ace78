"""Reading a ``torch.profiler`` chrome trace: device busy time, kernel time
by kind, the kernels launched inside a host span, and where the device sat
idle.

``KINDS`` and the busy-time union are copies of the port's
``profile_step.py`` (``KINDS``, ``device_breakdown``), kept here so that a
change to the program cannot move what the benchmark counts.
"""

import bisect
import json
from dataclasses import dataclass, field

# (kind, substrings of the lower-cased kernel name), first match wins
KINDS = (
    ("flash forward", ("flash_fwd_kernel",)),
    ("flash backward dq", ("flash_bwd_dq_kernel",)),
    ("flash backward dkv", ("flash_bwd_dkv_kernel",)),
    ("flash backward", ("flash_bwd_kernel", "flash_bwd_prep_kernel")),
    ("scan forward", ("scan_fwd_kernel",)),
    ("scan backward", ("scan_bwd_kernel",)),
    ("GEMM", ("gemm", "nvjet", "xmma")),
    ("reductions", ("reduce", "softmax")),
    ("memcpy/memset, cat", ("memcpy", "memset", "catarray")),
)
OTHER = "elementwise and other"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def kind_of(name: str) -> str:
    low = name.lower()
    return next((kind for kind, keys in KINDS if any(k in low for k in keys)), OTHER)


def union_seconds(intervals) -> float:
    """Length of the union of (start, stop) intervals given in microseconds,
    in seconds."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy * 1e-6


@dataclass
class DeviceTrace:
    """The device and host events of one traced stretch (times in us)."""

    device: list[dict]  # kernels, copies and sets, each with name, cat, ts, dur, correlation
    host: list[dict]  # host ops and annotations: name, cat, tid, ts, dur
    launches: dict[int, tuple[int, float]] = field(default_factory=dict)  # correlation -> (tid, ts)

    @classmethod
    def from_events(cls, events: list[dict]) -> "DeviceTrace":
        device, host, launches = [], [], {}
        for e in events:
            cat = e.get("cat")
            if cat in DEVICE_CATS and "dur" in e:
                device.append({"name": e.get("name", ""), "cat": cat, "ts": float(e["ts"]), "dur": float(e["dur"]),
                               "correlation": e.get("args", {}).get("correlation")})
            elif cat in HOST_CATS and "dur" in e:
                host.append({"name": e.get("name", ""), "cat": cat, "tid": e.get("tid"), "ts": float(e["ts"]),
                             "dur": float(e["dur"])})
            elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
        device.sort(key=lambda e: e["ts"])
        host.sort(key=lambda e: e["ts"])
        return cls(device, host, launches)

    @classmethod
    def from_file(cls, path: str) -> "DeviceTrace":
        with open(path) as f:
            return cls.from_events(json.load(f)["traceEvents"])

    def kernels(self) -> list[dict]:
        return [e for e in self.device if e["cat"] == "kernel"]

    def busy_s(self, events: list[dict] | None = None) -> float:
        """Seconds in which one of ``events`` (default: every device event)
        ran: the union of their intervals."""
        return union_seconds((e["ts"], e["ts"] + e["dur"]) for e in (self.device if events is None else events))

    def device_s(self, events: list[dict] | None = None) -> float:
        """Summed device time of ``events`` (default: every device event;
        overlaps counted twice)."""
        return sum(e["dur"] for e in (self.device if events is None else events)) * 1e-6

    def by_kind(self, events: list[dict] | None = None) -> dict[str, float]:
        """Seconds of device time by kind; copies and sets are their own kind."""
        out: dict[str, float] = {}
        for e in self.device if events is None else events:
            kind = "memcpy/memset, cat" if e["cat"] != "kernel" else kind_of(e["name"])
            out[kind] = out.get(kind, 0.0) + e["dur"] * 1e-6
        return out

    def matching(self, *substrings: str) -> list[dict]:
        """Kernels whose lower-cased name holds one of ``substrings``."""
        return [e for e in self.kernels() if any(s in e["name"].lower() for s in substrings)]

    def in_span(self, *names: str) -> list[dict]:
        """Device events launched inside a host annotation named one of
        ``names``: their launch (the runtime call of the same correlation
        id) starts within one of the spans, on any thread, since autograd
        launches a backward's kernels from a thread of its own while the
        span's thread waits for it."""
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in self.host
                 if e["cat"] == "user_annotation" and e["name"] in names]
        out = []
        for e in self.device:
            tid_ts = self.launches.get(e["correlation"])
            if tid_ts and any(t0 <= tid_ts[1] <= t1 for t0, t1 in spans):
                out.append(e)
        return out

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time: [name, seconds]."""
        total: dict[str, float] = {}
        for e in self.device:
            total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] * 1e-6
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle gaps summed by what the host was doing: each gap
        is named by the innermost host op that launched the device event
        ending it. The ``n`` names with most idle time: [name, seconds]."""
        gaps, end = [], None
        for e in self.device:
            if end is not None and e["ts"] > end:
                gaps.append((e["ts"] - end, e))
            end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
        starts = [h["ts"] for h in self.host]
        total: dict[str, float] = {}
        for gap, e in gaps:
            name = "(no launch found)"
            tid_ts = self.launches.get(e["correlation"])
            if tid_ts:
                i = bisect.bisect_right(starts, tid_ts[1]) - 1
                while i >= 0:
                    h = self.host[i]
                    if h["tid"] == tid_ts[0] and h["ts"] + h["dur"] >= tid_ts[1]:
                        name = h["name"]
                        break
                    i -= 1
            total[name] = total.get(name, 0.0) + gap * 1e-6
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
