"""Plain reference for deep views: exact smooth values of single pixels.

It imports nothing of the program.  A deep view is a centre given as
decimal strings, a span and a side of ``definition`` pixels; pixel
(row, col) sits at ``centre + ((col - (w - 1) / 2) * pitch,
(row - (h - 1) / 2) * pitch)`` with ``pitch = span / (w - 1)``, the
offset formed in float64 and added to the centre exactly.

The orbit runs in fixed point with ``BITS`` fractional bits (Python
integers), far below the pixel pitch of any view this benchmark renders,
so the escape it finds is the exact one: z starts at c, ``z <- z^2 + c``.

- ``count``: the first k >= 1 with |z_k| >= 2 (the upstream worker's
  count), 0 when z_0 .. z_{max_iter - 1} all stay below 2 (in the set);
- ``nu``: the smooth value ``n + 1 - log2(ln |z_n|^2 / (2 ln 256))``,
  where z_n is the first iterate with |z_n| >= 256; 0 in the set.
"""

from __future__ import annotations

import math
from decimal import Decimal
from fractions import Fraction

BITS = 192
BAILOUT = 256.0


def to_fixed(value, bits: int = BITS) -> int:
    """A decimal string or a float -> an integer with ``bits`` fractional
    bits, exactly (floor)."""
    f = Fraction(Decimal(value)) if isinstance(value, str) else \
        Fraction(value)
    return math.floor(f * (1 << bits))


def pixel_c(center: tuple[str, str], span: float, definition: int,
            row: int, col: int, bits: int = BITS) -> tuple[int, int]:
    pitch = span / (definition - 1)
    d_re = float((col - (definition - 1) / 2) * pitch)
    d_im = float((row - (definition - 1) / 2) * pitch)
    return (to_fixed(center[0], bits) + to_fixed(d_re, bits),
            to_fixed(center[1], bits) + to_fixed(d_im, bits))


def _to_float(v: int, bits: int) -> float:
    return float(Fraction(v, 1 << bits))


def smooth_pixel(ca: int, cb: int, max_iter: int,
                 bits: int = BITS) -> tuple[float, int]:
    """(nu, count) of the point c = (ca, cb) / 2^bits."""
    four = 4 << (2 * bits)
    big = int(BAILOUT * BAILOUT) << (2 * bits)
    a, b = ca, cb
    count = 0
    k = 0
    while True:
        a2, b2 = a * a, b * b
        mag = a2 + b2
        if not count and mag >= four:
            if k >= max_iter:
                return 0.0, 0
            count = k
        if mag >= big:
            zr, zi = _to_float(a, bits), _to_float(b, bits)
            log_ratio = math.log(zr * zr + zi * zi) / (2.0 * math.log(BAILOUT))
            return (k + 1) - math.log2(log_ratio), count
        if not count and k + 1 >= max_iter:
            return 0.0, 0
        a, b = ((a2 - b2) >> bits) + ca, ((a * b) >> (bits - 1)) + cb
        k += 1
