"""The traced window: torch.profiler (CUPTI) over the window, reduced in
memory to what the per-layer metrics read. No trace file is written.

The profiler records CUDA activity alone: the device's operations and
the host's CUDA runtime calls, and no host operation of PyTorch, whose
recording would lengthen a host-bound step. The window's bounds are the
ends of the device synchronisations that open and close it; the
benchmark's own spans (request, step) are host-clock times, shifted onto
the profiler's clock by the opening synchronisation. `Trace` gives the
busy union, the time by kernel group, the top device operations and the
idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect

import torch

from portbench.work import groups

SYNC = "DeviceSynchronize"  # the runtime call of torch.cuda.synchronize
TOP = 10


class Trace:
    """A profiled window, from `torch.profiler.profile`'s raw events.
    `spans`: (name, start, end) in host seconds (`time.perf_counter`);
    `host_lo`: the host's time when the opening synchronisation returned."""

    def __init__(self, prof, spans, host_lo: float):
        host, dev = [], []
        for e in prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            (host if e.device_type() == torch.autograd.DeviceType.CPU else dev).append(
                (s, s + d, e.name()))
        ends = sorted(e for _, e, n in host if SYNC in n)
        if len(ends) < 2:
            raise RuntimeError("the profile holds no device synchronisations around the window")
        lo, hi = ends[0], ends[-1]
        shift = lo - host_lo
        self.lo, self.hi = lo, hi
        self.window_s = hi - lo
        self.device = [(s, e, n) for s, e, n in dev if e > lo and s < hi]
        self.spans = sorted((s + shift, e + shift, n) for n, s, e in spans)
        self.host = sorted(host)
        self.busy_s = groups.busy([(s, e) for s, e, _ in self.device], lo, hi)

    def seconds_by(self, key) -> dict[str, float]:
        """Device seconds inside the window by key(name)."""
        out: dict[str, float] = {}
        for s, e, n in self.device:
            k = key(n)
            out[k] = out.get(k, 0.0) + min(e, self.hi) - max(s, self.lo)
        return out

    def group_seconds(self, group: str) -> float:
        return self.seconds_by(groups.group_of).get(group, 0.0)

    def matching_seconds(self, patterns) -> float:
        """Device seconds of the operations whose lower-cased name holds a pattern."""
        return sum(t for n, t in self.seconds_by(lambda n: n).items()
                   if any(p in n.lower() for p in patterns))

    def top_ops(self, top: int = TOP) -> list[list]:
        rows = sorted(self.seconds_by(lambda n: n).items(), key=lambda kv: -kv[1])
        return [[n[:160], t] for n, t in rows[:top]]

    def _host_at(self, t: float, events, starts) -> str | None:
        """The innermost event of `events` (sorted by start) running at t."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 400), -1):
            s, e, n = events[j]
            if e >= t:
                return n
        return None

    def idle_gaps(self, top: int = TOP) -> list[list]:
        """Seconds of device idleness in the window by what the host was
        doing at each gap's start: the benchmark's span and the CUDA
        runtime call then running, "span:call" ("python" where none ran)."""
        span_starts = [s for s, _, _ in self.spans]
        host_starts = [s for s, _, _ in self.host]
        out: dict[str, float] = {}
        for s, e in groups.gaps([(a, b) for a, b, _ in self.device], self.lo, self.hi):
            span = self._host_at(s, self.spans, span_starts) or "between"
            op = self._host_at(s, self.host, host_starts) or "python"
            key = f"{span}:{op}"
            out[key] = out.get(key, 0.0) + (e - s)
        rows = sorted(out.items(), key=lambda kv: -kv[1])
        return [[n[:160], t] for n, t in rows[:top]]


def profiler():
    """A profiler of CUDA activity alone, nothing recorded but names and
    times."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA], record_shapes=False, with_stack=False,
                   profile_memory=False)
