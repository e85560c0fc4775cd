"""The device trace of a ``--trace 1`` run, reduced to what metrics read.

``torch.profiler`` (CUPTI) records every kernel, copy and fill on the
card and the host's PyTorch operations and annotations.  The measured
window is the annotation ``benchmark.window``; device intervals are
clipped to it.  The card is busy where any device interval covers the
time (their union); the gaps are the rest of the window.
"""

from __future__ import annotations

import contextlib

# The harness's own annotations all begin so; the profiler mirrors an
# annotation on the device when kernels run inside it, and those copies
# are no device work.
MARK_PREFIX = "benchmark."
WINDOW_MARK = MARK_PREFIX + "window"


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()


class Trace:
    """Device intervals and host events of the window, in seconds from
    its start."""

    def __init__(self, window_s: float, device: list, host: list) -> None:
        self.window_s = window_s
        self.device = device        # (name, start_s, end_s), clipped
        self.host = host            # (name, start_s, end_s)
        spans = sorted((s, e) for _, s, e in device if e > s)
        self.busy = []
        for s, e in spans:
            if self.busy and s <= self.busy[-1][1]:
                self.busy[-1][1] = max(self.busy[-1][1], e)
            else:
                self.busy.append([s, e])
        self.busy_s = sum(e - s for s, e in self.busy)

    def device_seconds(self, match) -> float:
        """Seconds of the device intervals whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.device if match(name))

    def gaps(self) -> list[tuple[float, float]]:
        out, last = [], 0.0
        for s, e in self.busy:
            if s > last:
                out.append((last, s))
            last = max(last, e)
        if last < self.window_s:
            out.append((last, self.window_s))
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps, each named by the host event that overlaps it
        most (the shortest among equals: the innermost) with the share
        of the gap it covers, where that is a tenth or more."""
        by_op: dict = {}
        for name, s, e in self.device:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        named = []
        for gs, ge in gaps:
            best, best_key = "no traced host operation", None
            for name, s, e in self.host:
                overlap = min(e, ge) - max(s, gs)
                if overlap <= 0:
                    continue
                key = (overlap, -(e - s))
                if best_key is None or key > best_key:
                    best, best_key = name, key
            if best_key is not None and best_key[0] < (ge - gs) / 10:
                best = "no traced host operation"
            elif best_key is not None:
                best += f" ({best_key[0] / (ge - gs):.0%} of it)"
            named.append([best, ge - gs])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": named}


def mark(name: str, enabled: bool):
    """An annotation of the trace around a block, when tracing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


class Profiler:
    """``torch.profiler`` around a run when ``enabled``; ``window()``
    marks the measured window inside it, which ends with the mark or
    ``window_s`` after its start."""

    def __init__(self, enabled: bool, window_s: float | None = None) -> None:
        self.enabled = enabled
        self.window_s = window_s
        self._prof = None
        self.trace: Trace | None = None

    def __enter__(self) -> "Profiler":
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def window(self):
        return mark(WINDOW_MARK, self.enabled)

    def __exit__(self, *exc) -> None:
        if self._prof is None:
            return
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = self._reduce(self._prof.events(), self.window_s)

    @staticmethod
    def _reduce(events, window_s: float | None) -> Trace:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        mark = [e for e in events if e.name == WINDOW_MARK
                and e.device_type != cuda]
        if not mark:
            raise RuntimeError("the trace holds no window mark")
        w0, w1 = mark[0].time_range.start, mark[0].time_range.end
        if window_s is not None:
            w1 = w0 + window_s * 1e6
        device, host = [], []
        for e in events:
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t <= s:
                continue
            item = (e.name, (s - w0) / 1e6, (t - w0) / 1e6)
            if e.name == WINDOW_MARK:
                continue
            if e.device_type != cuda:
                host.append(item)
            elif not e.name.startswith(MARK_PREFIX):
                device.append(item)
        return Trace((w1 - w0) / 1e6, device, host)
