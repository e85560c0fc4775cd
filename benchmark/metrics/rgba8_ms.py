"""The program's float-RGBA-to-uint8 step (its phase ``render.rgba8``:
``_save_png``'s ``imsave_bytes``) per view, host clock, in
milliseconds."""

from benchmark.harness.phases import per_view_ms


def read(rec):
    return per_view_ms(rec, "render.rgba8")
