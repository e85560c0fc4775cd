"""Compute: the numpy golden (``reference``), the torch escape-time
loops (``escape_time``, ``families``), the perturbation deep-zoom route
(``perturbation``, ``bla``), and the CUDA kernels with their host side
(``cuda_escape``, ``cuda_perturb``, ``compact_escape``; sources in
``csrc/``, built by ``_build``).  The package exports what the JAX
package's ``ops`` exports."""

from distributedmandelbrot_tpu_torch.ops import reference
from distributedmandelbrot_tpu_torch.ops.escape_time import (
    DEFAULT_SEGMENT, compute_tile, compute_tile_julia, compute_tile_smooth,
    escape_counts, escape_counts_julia, escape_smooth, escape_smooth_julia,
    scale_counts_to_uint8)
from distributedmandelbrot_tpu_torch.ops.families import (
    compute_tile_family, compute_tile_smooth_family, escape_counts_family,
    escape_smooth_family)
from distributedmandelbrot_tpu_torch.ops.perturbation import (
    DeepTileSpec, compute_counts_perturb, compute_smooth_perturb,
    compute_tile_perturb)

__all__ = ["reference", "DEFAULT_SEGMENT", "compute_tile",
           "compute_tile_julia", "compute_tile_smooth", "escape_counts",
           "escape_counts_julia", "escape_smooth", "escape_smooth_julia",
           "scale_counts_to_uint8", "compute_tile_family",
           "compute_tile_smooth_family", "escape_counts_family",
           "escape_smooth_family", "DeepTileSpec", "compute_counts_perturb",
           "compute_smooth_perturb", "compute_tile_perturb"]
