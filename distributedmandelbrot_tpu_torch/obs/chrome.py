"""Chrome trace-event rendering of the merged farm timeline.

Turns the coordinator's :class:`~distributedmandelbrot_tpu_torch.obs.trace
.TraceLog` lifecycle intervals plus the :class:`~distributedmandelbrot
_tpu.obs.spans.SpanStore`'s aligned worker spans into the Chrome
trace-event JSON format (the ``{"traceEvents": [...]}`` dict), loadable
at https://ui.perfetto.dev or chrome://tracing.

Layout: the coordinator is one process (pid 0) with one thread per
lifecycle phase (queue / in-flight / persist) plus a gateway row for
``served`` instants; each remote worker is its own process (pid 100+i,
named by its 64-bit id) with a prefetch row, a dispatch row, an upload
row, and one thread per device carrying the nested compute/d2h slices.
All timestamps are the coordinator's monotonic clock in microseconds —
worker spans were aligned by the store's per-worker NTP-style offset, so
their absolute placement carries that estimate's error bound (exposed in
each event's ``args.align_error_s``); durations are exact.
"""

from __future__ import annotations

from typing import Optional

from distributedmandelbrot_tpu_torch.obs import names as obs_names

# Coordinator rows (pid 0).
_PID_COORD = 0
_TID_QUEUE = 1
_TID_FLIGHT = 2
_TID_PERSIST = 3
_TID_GATEWAY = 4
# Worker rows: prefetch/dispatch/upload threads, then one per device.
_TID_W_PREFETCH = 1
_TID_W_DISPATCH = 2
_TID_W_UPLOAD = 3
_TID_W_DEVICE0 = 10

_STAGE_TID = {
    obs_names.SPAN_PREFETCH: _TID_W_PREFETCH,
    obs_names.SPAN_DISPATCH: _TID_W_DISPATCH,
    obs_names.SPAN_UPLOAD: _TID_W_UPLOAD,
}


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def _meta(name: str, pid: int, value: str, tid: int = 0) -> dict:
    return {"name": name, "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": value}}


def _slice(name: str, pid: int, tid: int, t0: float, t1: float,
           args: dict) -> dict:
    return {"name": name, "ph": "X", "ts": _us(t0),
            "dur": _us(max(0.0, t1 - t0)), "pid": pid, "tid": tid,
            "cat": "farm", "args": args}


def _key_str(key) -> str:
    return "/".join(str(int(part)) for part in key)


def render_chrome_trace(trace=None, spans=None) -> dict:
    """Render the merged timeline; both inputs optional (an idle
    coordinator yields an empty but valid trace)."""
    events: list[dict] = []

    events.append(_meta("process_name", _PID_COORD, "coordinator"))
    for tid, label in ((_TID_QUEUE, "queue (scheduled->granted)"),
                       (_TID_FLIGHT, "in flight (granted->received)"),
                       (_TID_PERSIST, "persist"),
                       (_TID_GATEWAY, "gateway serves")):
        events.append(_meta("thread_name", _PID_COORD, label, tid))

    if trace is not None:
        for span in trace.spans():
            key = _key_str(span["key"])
            args = {"key": key}
            if span.get("worker"):
                args["worker"] = span["worker"]
            marks = span.get("events", {})
            sched = marks.get("scheduled")
            granted = marks.get("granted")
            received = marks.get("result_received")
            persisted = marks.get("persisted")
            if sched is not None and granted is not None:
                events.append(_slice("queue", _PID_COORD, _TID_QUEUE,
                                     sched, granted, args))
            if granted is not None and received is not None:
                events.append(_slice("in_flight", _PID_COORD,
                                     _TID_FLIGHT, granted, received,
                                     args))
            if received is not None and persisted is not None:
                events.append(_slice("persist", _PID_COORD,
                                     _TID_PERSIST, received, persisted,
                                     args))
            served = marks.get("served")
            if served is not None:
                events.append({"name": "served", "ph": "i",
                               "ts": _us(served), "pid": _PID_COORD,
                               "tid": _TID_GATEWAY, "s": "t",
                               "cat": "farm", "args": args})

    if spans is not None:
        pids: dict[int, int] = {}
        device_tids: dict[tuple[int, int], int] = {}
        for span in spans.spans():
            wid = span["worker"]
            pid = pids.get(wid)
            if pid is None:
                pid = 100 + len(pids)
                pids[wid] = pid
                events.append(_meta("process_name", pid,
                                    f"worker {wid:016x}"))
                for tid, label in ((_TID_W_PREFETCH, "prefetch"),
                                   (_TID_W_DISPATCH, "dispatch"),
                                   (_TID_W_UPLOAD, "upload")):
                    events.append(_meta("thread_name", pid, label, tid))
            stage = span["stage"]
            tid = _STAGE_TID.get(stage)
            if tid is None:  # compute/d2h nest on the device row
                tid = _TID_W_DEVICE0 + span["device"]
                if (pid, tid) not in device_tids:
                    device_tids[(pid, tid)] = tid
                    events.append(_meta("thread_name", pid,
                                        f"device {span['device']}",
                                        tid))
            events.append(_slice(
                stage, pid, tid, span["t0"], span["t1"],
                {"key": _key_str(span["key"]), "seq": span["seq"],
                 "align_error_s": round(span["align_error_s"], 6)}))

    return {"traceEvents": events, "displayTimeUnit": "ms"}
