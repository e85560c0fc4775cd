"""Device milliseconds of K10 (``perturb_smooth_kernel``) per view, from
the window's trace; nothing where the trace holds no K10 launch."""


def read(rec):
    if rec.kind != "views" or rec.trace is None or not rec.done:
        return None
    k10 = [e - s for name, s, e in rec.trace.device
           if "perturb_smooth_kernel" in name]
    return sum(k10) / rec.done * 1e3 if k10 else None
