#!/usr/bin/env python3
"""Writes the step table of a drain configuration: for each chunk of its
profile, the steps its pixels need by the plain reference loop
(``benchmark/reference/escape.py``) and the bytes a chunk writes.  The
escape kernels' roofline counts this work, whatever implements it.

    python3 benchmark/tools/step_table.py [--config canonical] \\
        [--out benchmark/data/canonical.steps.json]

Runs on a CUDA card (the plain loop, a few minutes for the canonical
profile); records the command and the card beside the data.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="canonical")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.drivers.drain import profile_keys
    from benchmark.harness import chip, roofline
    from benchmark.harness.spec import load_json
    from benchmark.reference import escape

    chip.require_cards(1)
    cfg = load_json(ROOT / "benchmark" / "configs" / f"{args.config}.json")
    out = Path(args.out) if args.out else ROOT / cfg["steps_table"]
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    steps = {}
    for key in profile_keys(cfg["levels"]):
        steps[":".join(map(str, key))] = escape.chunk_steps(*key,
                                                            device=dev)
    table = {
        "command": "python3 benchmark/tools/step_table.py " + " ".join(
            argv if argv is not None else sys.argv[1:]),
        "card": chip.power_limit(),
        "seconds": time.monotonic() - t0,
        "levels": cfg["levels"],
        "bytes_per_chunk": roofline.CHUNK_BYTES,
        "steps": steps,
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(table, fh, indent=0)
        fh.write("\n")
    print(f"wrote {out}: {len(steps)} chunks, "
          f"{sum(steps.values())} steps, {table['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
