"""Read-side rendering: the colormap core and level stitching.  The
viewer's data client comes with the serving plane."""

from distributedmandelbrot_tpu_torch.viewer.render import (smooth_to_rgba,
                                                           stitch_level,
                                                           value_to_rgba)

__all__ = ["value_to_rgba", "smooth_to_rgba", "stitch_level"]
