"""The program's PNG encoding (its phase ``render.deflate``:
``_save_png``'s ``encode_png``, mostly zlib's deflate) per view, host
clock, in milliseconds."""

from benchmark.harness.phases import per_view_ms


def read(rec):
    return per_view_ms(rec, "render.deflate")
