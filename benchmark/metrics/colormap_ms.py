"""The program's colormap (its phase ``render.colormap``: the
``smooth_to_rgba`` or ``value_to_rgba`` calls of ``_render_view``) per
view, host clock, in milliseconds."""

from benchmark.harness.phases import per_view_ms


def read(rec):
    return per_view_ms(rec, "render.colormap")
