"""The card a run measures: its presence, name, power limit and peak
memory, and the check that no JAX module was loaded."""

from __future__ import annotations

import subprocess
import sys

# Top-level module names a run may not load: JAX, its relatives, and the
# JAX package this port was made from.  Compared whole: the port's own
# name begins with the JAX package's.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "distributedmandelbrot_tpu"})


class NoCard(RuntimeError):
    """The machine lacks the cards a cell needs; nothing is measured."""


def require_cards(count: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: this benchmark measures the card and "
                     "never falls back to the CPU")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} CUDA devices, "
                     f"{torch.cuda.device_count()} present")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why
    there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def device_record(count: int, device) -> dict:
    """The result's ``device``: the card's name and the peak of memory
    allocated on it so far in this process."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}
