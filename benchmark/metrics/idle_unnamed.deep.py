"""Milliseconds a view of the window's device-idle time (the trace's
gaps) that no host event of the program's own phases (annotations named
``dmtpu.*``) covers: the idle card that the program's spans leave
unexplained, which falls only as the host code outside them gets
faster.  Nothing where the trace holds no such event (a program without
them)."""

PREFIX = "dmtpu."


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(rec):
    if rec.kind != "views" or rec.trace is None or not rec.done:
        return None
    spans = _union((s, e) for name, s, e in rec.trace.host
                   if name.startswith(PREFIX) and e > s)
    if not spans:
        return None
    uncovered = 0.0
    i = 0
    for gs, ge in rec.trace.gaps():
        uncovered += ge - gs
        while i < len(spans) and spans[i][1] <= gs:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < ge:
            uncovered -= min(spans[j][1], ge) - max(spans[j][0], gs)
            j += 1
    return uncovered / rec.done * 1e3
