"""The serving side: the tile gateway in front of the store and the
worker farm (multi-tier cache, single-flight coalescing, compute-on-read,
admission control), carried from the JAX package, and the colormap core
(``render``), which the port owns: it needs no matplotlib."""

from distributedmandelbrot_tpu_torch.serve.cache import (CachedTile,
                                                         DecodedTileCache,
                                                         RenderedTileCache)
from distributedmandelbrot_tpu_torch.serve.coalesce import SingleFlight
from distributedmandelbrot_tpu_torch.serve.gateway import (TileGateway,
                                                           TokenBucket)
from distributedmandelbrot_tpu_torch.serve.ondemand import OnDemandComputer

__all__ = ["CachedTile", "DecodedTileCache", "RenderedTileCache",
           "SingleFlight", "TileGateway", "TokenBucket", "OnDemandComputer"]
