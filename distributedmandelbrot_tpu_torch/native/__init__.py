"""Optional native (C++) fast paths: RLE codec + bit-exact CPU escape kernel.

Everything here degrades gracefully to the pure-Python implementations when
g++ or the built library is unavailable (or ``DMTPU_NATIVE=0``).
"""

from distributedmandelbrot_tpu_torch.native.bindings import (escape_counts,
                                                       escape_pixels,
                                                       native_supported,
                                                       rle_decode, rle_encode,
                                                       rle_encoded_size)
from distributedmandelbrot_tpu_torch.native.build import available

__all__ = ["available", "native_supported", "rle_encode", "rle_decode",
           "rle_encoded_size", "escape_pixels", "escape_counts"]
