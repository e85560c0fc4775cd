"""Chunk payload codecs (Raw 0x00, RLE 0x01) and the pick-smallest registry."""

from distributedmandelbrot_tpu_torch.codecs import base
from distributedmandelbrot_tpu_torch.codecs.base import (Codec, deserialize, get,
                                                   register, serialize)
from distributedmandelbrot_tpu_torch.codecs.raw import RawCodec
from distributedmandelbrot_tpu_torch.codecs.rle import RleCodec

RAW = RawCodec()
RLE = RleCodec()

if not base.all_codecs():
    register(RAW)
    register(RLE)

__all__ = ["Codec", "RawCodec", "RleCodec", "RAW", "RLE", "register", "get",
           "serialize", "deserialize"]
