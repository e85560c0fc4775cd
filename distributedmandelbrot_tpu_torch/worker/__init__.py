"""Stateless pull-loop workers and their compute backends."""

from distributedmandelbrot_tpu_torch.worker.backends import (ComputeBackend,
                                                             CudaBackend,
                                                             MegaTileHandle,
                                                             NativeBackend,
                                                             NumpyBackend,
                                                             TileHandle,
                                                             TorchBackend,
                                                             auto_backend)
from distributedmandelbrot_tpu_torch.worker.client import DistributerClient
from distributedmandelbrot_tpu_torch.worker.pipeline import (PipelineExecutor,
                                                             as_dispatcher)
from distributedmandelbrot_tpu_torch.worker.worker import Worker

__all__ = ["ComputeBackend", "CudaBackend", "MegaTileHandle",
           "NativeBackend", "NumpyBackend",
           "TileHandle", "TorchBackend", "auto_backend", "DistributerClient",
           "Worker", "PipelineExecutor", "as_dispatcher"]
