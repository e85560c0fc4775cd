"""The escape kernels' share of their roofline: the least time the card
could take for the chunks completed in the window (``bound_s``: the
steps the frozen plain loop needs, from ``benchmark/data``, and the
bytes written, over the peaks of ``harness/roofline.py``) over the
device time of the ``escape_mega*`` (K2) and ``escape_tile*`` (K1)
kernels in the window's trace."""


def read(rec):
    if rec.kind != "drain" or rec.trace is None or not rec.bound_s:
        return None
    busy = rec.trace.device_seconds(
        lambda name: "escape_mega" in name or "escape_tile" in name)
    return 100.0 * rec.bound_s / busy if busy else None
