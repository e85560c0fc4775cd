"""The benchmark of distributedmandelbrot_tpu_torch (see run.py)."""
