"""distributedmandelbrot_tpu_torch — the PyTorch/CUDA port of the farm.

A second package beside ``distributedmandelbrot_tpu`` (the JAX reference,
which it never imports).  Pure-Python modules of the reference are
carried with their imports renamed; modules that touch JAX are rewritten
in PyTorch, and every Pallas kernel on a ported path becomes a CUDA C++
kernel for Hopper (``ops/csrc``), built on first use.

It runs the pull-based farm end to end: the coordinator (scheduler,
append-only store, data server), the gateway and viewer client, carried
from the reference, and the worker's tile path on the GPU: grant ->
``TileSpec`` -> fused kernel launch -> device-to-host copy -> flat uint8
chunk -> upload; and local rendering (``render``, ``animate``), deep
views by perturbation included.  ``python -m
distributedmandelbrot_tpu_torch`` lists the subcommands.
"""

__version__ = "0.1.0"
