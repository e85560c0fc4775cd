"""A model of K1's and K2's lane-steps on the CPU: how many lane-steps
persistent warps issue for a tile's pixels, over the steps the pixels
need, with and without the block's end-game compaction.

    python3 distributedmandelbrot_tpu_torch/tools/lane_model.py \\
        [--chunks 10,3,5 10,3,4] [--max-iter 1024] [--warps-per-sm 64]

The per-pixel steps come from K1's plain version on the CPU
(``escape_tile_plain(..., return_steps=True)``, 4096^2, a few seconds a
chunk).  Every warp steps in groups of 8 and is at the same group at
the same time (an issue-bound card); at each group boundary the lanes
that are free take the next pixels that need iterating, in order, and a
pixel holds its lane for ceil(steps / 8) groups.  When no pixel is left
a warp runs until its slowest lane ends ("no end game"), or the live
orbits of each block of ``--block-warps`` warps are compacted into its
first lanes at every group ("end game"), or all of the card's
("perfect tail").  Prints one JSON line: the
proven-interior share, the iterating pixels' mean steps, and the
issued-over-needed ratio of each model for K1 (the first chunk) and K2
(all chunks), on 132 SMs.
"""

from __future__ import annotations

import json
import sys

import numpy as np

GROUP = 8
SMS = 132


def chunk_steps(level: int, i: int, j: int, max_iter: int) -> np.ndarray:
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    spec = TileSpec.for_chunk(level, i, j)
    _, steps = ce.escape_tile_plain(
        ce._params_row(spec), max_iter, spec.height, spec.width,
        cycle_check=ce.escape_time.resolve_cycle_check(None, max_iter),
        device="cpu", return_steps=True)
    return steps.numpy().astype(np.int64).ravel()


def issued_over_needed(steps: np.ndarray, warps: int, block_warps: int,
                       seed: int = 0) -> tuple[float, float, float]:
    """(no end game, end game, perfect tail) issued lane-steps over
    needed."""
    s = steps[steps > 0]
    groups = (s + GROUP - 1) // GROUP
    lanes = warps * 32
    free = np.zeros(lanes, np.int64)
    rng = np.random.default_rng(seed)
    pos, t = 0, 0
    while pos < len(groups):
        idle = np.nonzero(free <= t)[0]
        if len(idle):
            rng.shuffle(idle)
            take = min(len(idle), len(groups) - pos)
            free[idle[:take]] = t + groups[pos:pos + take]
            pos += take
        t += 1
    spent = t
    no_end = np.maximum(free.reshape(warps, 32).max(1), spent).sum()
    tail = np.arange(spent, free.max() + 1)

    def compacted(width: int) -> float:
        total = spent * warps
        for block in free.reshape(-1, width * 32):
            ends = np.sort(block)
            live = len(ends) - np.searchsorted(ends, tail, side="right")
            total += np.ceil(live / 32).sum()
        return float(total * 32 * GROUP / s.sum())

    return (float(no_end * 32 * GROUP / s.sum()), compacted(block_warps),
            compacted(warps))


def main(argv: list[str]) -> int:
    args = {"--max-iter": "1024", "--warps-per-sm": "64",
            "--block-warps": "8"}
    chunks = ["10,3,5", "10,3,4"]
    it = iter(argv)
    for a in it:
        if a == "--chunks":
            chunks = []
            continue
        if a in args:
            args[a] = next(it)
        else:
            chunks.append(a)
    mi = int(args["--max-iter"])
    warps = SMS * int(args["--warps-per-sm"])
    bw = int(args["--block-warps"])
    steps = [chunk_steps(*(int(v) for v in c.split(",")), mi) for c in chunks]
    both = np.concatenate(steps)
    active = both[both > 0]
    k1 = issued_over_needed(steps[0], warps, bw)
    k2 = issued_over_needed(both, warps, bw)
    print(json.dumps({
        "chunks": chunks, "max_iter": mi, "warps": warps,
        "interior_share": float((both == 0).mean()),
        "iterating_mean_steps": float(active.mean()),
        "budget_share": float((both == mi - 1).mean()),
        "k1": {"no_end_game": k1[0], "end_game": k1[1],
               "perfect_tail": k1[2]},
        "k2": {"no_end_game": k2[0], "end_game": k2[1],
               "perfect_tail": k2[2]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
