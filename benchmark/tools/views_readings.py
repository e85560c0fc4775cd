#!/usr/bin/env python3
"""Reads the deep views' check over many seeds in one process, for
setting its limits: the program as a run drives it, the control (the
route's own lower precision, ``control_dtype``) and a planted fault (the
glitch repairs skipped: the scans' glitch flags dropped).  Each seed
draws its views and pixels as a run of the cell does; each view is
rendered once (``cli.main(["render", ...])``) and shared by the seeds
that draw it.  One JSON line a seed and variant (the fault's with the
share of its views' pixels it changed), and one a sound view with its
whole-view patched share.

    python3 benchmark/tools/views_readings.py \\
        [--cell deep-config4.views-1024] \\
        [--seeds 16] [--control-seeds 3] [--fault-seeds 3]

Runs on a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIRST_SEED = 2**31 + 7001


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cell", default="deep-config4.views-1024")
    parser.add_argument("--seeds", type=int, default=16)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from benchmark.drivers import views
    from benchmark.harness.common import seeded
    from benchmark.harness.spec import Cell
    from distributedmandelbrot_tpu_torch import cli
    from distributedmandelbrot_tpu_torch.ops import perturbation

    cell = Cell(args.cell, ROOT)
    cfg, traffic = cell.config, cell.traffic
    path = views.view_path(cfg, traffic["path"])
    n = min(traffic["check"]["among_first"], len(path))
    real_fetch = perturbation._fetch

    def unflagged(values, glitched):
        got, flags = real_fetch(values, glitched)
        return got, np.zeros_like(flags)

    variants = {"sound": (cfg["dtype"], args.seeds, real_fetch),
                "control": (cfg["control_dtype"], args.control_seeds,
                            real_fetch),
                "repairs_skipped": (cfg["dtype"], args.fault_seeds,
                                    unflagged)}
    renders: dict = {}
    with tempfile.TemporaryDirectory() as tmp, views.Taps(False) as taps:
        out = Path(tmp) / "view.png"
        for variant, (dtype, count, fetch) in variants.items():
            rendered = renders.setdefault(variant, {})

            def render(k):
                if k not in rendered:
                    perturbation._fetch = fetch
                    try:
                        with contextlib.redirect_stdout(io.StringIO()):
                            rc = cli.main(views.render_args(
                                cfg, traffic, path[k], out, "cuda", dtype))
                    finally:
                        perturbation._fetch = real_fetch
                    if rc != 0:
                        raise RuntimeError(f"view {k} failed ({variant})")
                    rendered[k] = (np.asarray(taps.last_nu, np.float64),
                                   out.read_bytes())
                return rendered[k]

            for i in range(count):
                seed = FIRST_SEED + 7919 * i
                rng = seeded(seed, "views")
                drawn = sorted(rng.sample(range(n),
                                          traffic["check"]["views"]))
                res = [views.check_view(cfg, traffic, path[k], *render(k),
                                        rng) for k in drawn]
                pixels = sum(r["pixels"] for r in res)
                changed = None
                if variant != "sound" and all(k in renders["sound"]
                                              for k in drawn):
                    changed = float(np.mean([
                        renders["sound"][k][0] != rendered[k][0]
                        for k in drawn]))
                print(json.dumps({
                    "variant": variant, "seed": seed, "views": drawn,
                    "png_pixels_differing": sum(r["png_bad"] for r in res),
                    "smooth_off_share": sum(len(r["off"]) for r in res)
                    / pixels,
                    "patched_share": sum(r["patched"] for r in res)
                    / sum(r["uniform"] for r in res),
                    "changed_share": changed,
                    "off": [o for r in res for o in r["off"]][:12]}),
                    flush=True)
            if variant == "sound":
                for k, (nu, _) in sorted(rendered.items()):
                    whole = (nu > 0) & (nu == np.round(nu))
                    print(json.dumps({"view": k, "patched_share_of_view":
                                      float(whole.mean())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
