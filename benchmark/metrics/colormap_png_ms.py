"""Host-clock milliseconds per view inside the program's colormap
(``smooth_to_rgba``) and PNG encoding (``imsave_bytes``,
``encode_png``), taken by the driver's wrappers around them."""


def read(rec):
    if rec.kind != "views" or not rec.done:
        return None
    return rec.colormap_png_s / rec.done * 1e3
