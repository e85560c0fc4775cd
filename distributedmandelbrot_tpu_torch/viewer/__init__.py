"""Read-side client and rendering: the data client (carried), the
colormap core and level stitching, and ``show`` (needs a display)."""

from distributedmandelbrot_tpu_torch.viewer.client import (DataClient,
                                                           FetchStatus)
from distributedmandelbrot_tpu_torch.viewer.render import (show,
                                                           smooth_to_rgba,
                                                           stitch_level,
                                                           value_to_rgba)

__all__ = ["DataClient", "FetchStatus", "value_to_rgba", "smooth_to_rgba",
           "stitch_level", "show"]
