"""Extended escape-time families: Multibrot (``z^d + c``) and Burning
Ship (``(|Re z| + i|Im z|)^2 + c``) — the port of the JAX package's
``ops/families.py``, on the torch loops of :mod:`escape_time`.

Count semantics are the Mandelbrot set's: z starts at c, iterations
count 1..max_iter-1, the bailout ``|z|^2 >= 4`` is tested after the
update, 0 = never escaped.  The Multibrot gets the inscribed disk of
its period-1 component as its interior shortcut (the cardioid and bulb
at degree 2); the Burning Ship has none.  The Burning Ship's folds
amplify last-ulp differences (an orbit a ulp across a fold diverges),
so f32 agreement with other implementations is looser there.
"""

from __future__ import annotations

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.ops.escape_time import (
    DEFAULT_SEGMENT, _escape_smooth, counts_from_survival, escape_loop,
    family_interior, family_step, resolve_cycle_check, scale_counts_to_uint8,
    spec_grid)

__all__ = ["family_step", "escape_counts_family", "escape_smooth_family",
           "compute_tile_family", "compute_tile_smooth_family"]


def _check_family(power: int, burning: bool) -> None:
    if power < 2:
        raise ValueError(f"multibrot degree must be >= 2, got {power}")
    if burning and power != 2:
        raise ValueError("burning ship is degree 2 only")


def escape_counts_family(c_real: torch.Tensor, c_imag: torch.Tensor, *,
                         max_iter: int, power: int = 2,
                         burning: bool = False,
                         cycle_check: bool | None = None) -> torch.Tensor:
    """Escape counts (int32) for the Multibrot / Burning Ship families."""
    _check_family(power, burning)
    total_steps = max_iter - 1
    if total_steps <= 0:
        return torch.zeros(c_real.shape, dtype=torch.int32,
                           device=c_real.device)
    n = escape_loop(c_real, c_imag, c_real, c_imag, total_steps=total_steps,
                    interior=family_interior(c_real, c_imag, power, burning),
                    cycle_check=resolve_cycle_check(cycle_check, max_iter),
                    power=power, burning=burning)
    return counts_from_survival(n, total_steps)


def escape_smooth_family(c_real: torch.Tensor, c_imag: torch.Tensor, *,
                         max_iter: int, power: int = 2,
                         burning: bool = False,
                         segment: int = DEFAULT_SEGMENT,
                         bailout: float = 256.0,
                         cycle_check: bool | None = None) -> torch.Tensor:
    """Smooth values for the extended families, with the degree-``power``
    renormalisation; 0 = in the set."""
    _check_family(power, burning)
    return _escape_smooth(c_real, c_imag, c_real, c_imag, max_iter=max_iter,
                          segment=segment, bailout=float(bailout),
                          interior_check=True,
                          cycle_check=resolve_cycle_check(cycle_check,
                                                          max_iter),
                          power=power, burning=burning)


def compute_tile_smooth_family(spec: TileSpec, max_iter: int, *,
                               power: int = 2, burning: bool = False,
                               dtype=torch.float64,
                               segment: int = DEFAULT_SEGMENT,
                               bailout: float = 256.0,
                               device="cuda") -> np.ndarray:
    """One smooth Multibrot/Burning-Ship tile -> (height, width) float
    numpy array."""
    g_real, g_imag = spec_grid(spec, dtype, device)
    return escape_smooth_family(g_real, g_imag, max_iter=max_iter,
                                power=power, burning=burning,
                                segment=segment,
                                bailout=bailout).cpu().numpy()


def compute_tile_family(spec: TileSpec, max_iter: int, *, power: int = 2,
                        burning: bool = False, dtype=torch.float32,
                        clamp: bool = False, device="cuda") -> np.ndarray:
    """One Multibrot/Burning-Ship tile end to end -> flat uint8 numpy
    array."""
    c_real, c_imag = spec_grid(spec, dtype, device)
    counts = escape_counts_family(c_real, c_imag, max_iter=max_iter,
                                  power=power, burning=burning)
    return scale_counts_to_uint8(counts, max_iter=max_iter,
                                 clamp=clamp).cpu().numpy().reshape(-1)
