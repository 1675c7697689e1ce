"""Time the two low-rank kernels built with other values of the macros of
their shared core (``kernels/csrc/lowrank_core.cuh``) against the default
build, at the shapes of the main paths, on the card.

  PYTHONPATH=src python -m repro_torch.tools.core_variants \
      --variant LRC_WGMMA_MIN=8 [--variant LRC_WGMMA_MIN=96 ...] [--out FILE]

The macro: ``LRC_WGMMA_MIN``, the token tile from which the products run
on ``wgmma`` (below it on ``mma.sync``; default 32). A ``--variant`` is a
comma-separated list of ``-D`` macros. Each variant is built beside the
default libraries and run through the wrappers, tiled by
``kernels/tiles.py`` with its own cluster occupancy; every variant is
held against a float64 product at
every shape (2e-4 of the output's max, as in ``chip_smoke.py``). Times are
CUDA-event medians of back-to-back calls over input copies that exceed the
L2 cache, taken in the order default, variants, variants reversed, default,
and averaged over the two passes, so every build sees the same clocks.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import gar_matmul as gk
from repro_torch.kernels import lowrank_matmul as lk

TOL = 2e-4                     # relative to the output's max
L2_BYTES = 50 * 2**20

# (label, kernel, T, n, r, m[, kept rank]); GAR at gemma3-27b's and
# gpt2-small's deployed ranks (DP rows 0 and 6 of PERF.md), at decode T 8
# (token tile 8) and at T 32 and 64 (token tiles 32 and 64); one low-rank
# training shape (token tile 96) as a control
SHAPES: List[Tuple] = [
    ("gemma3 mlp/gate row 0", "gar", 8, 5376, 2151, 21504),
    ("gemma3 mlp/gate row 6", "gar", 8, 5376, 5376, 21504),
    ("gemma3 mlp/down row 6", "gar", 8, 21504, 5376, 5376),
    ("gemma3 mlp/gate row 0", "gar", 32, 5376, 2151, 21504),
    ("gemma3 mlp/gate row 6", "gar", 32, 5376, 5376, 21504),
    ("gemma3 mlp/down row 6", "gar", 32, 21504, 5376, 5376),
    ("gemma3 mlp/gate row 0", "gar", 64, 5376, 2151, 21504),
    ("gemma3 mlp/gate row 6", "gar", 64, 5376, 5376, 21504),
    ("gemma3 mlp/down row 6", "gar", 64, 21504, 5376, 5376),
    ("gpt2 attn/q row 0", "gar", 8, 768, 410, 768),
    ("gpt2 mlp/gate row 0", "gar", 8, 768, 410, 3072),
    ("gpt2 mlp/down row 6", "gar", 8, 3072, 768, 768),
    ("gpt2 attn/q row 0", "gar", 32, 768, 410, 768),
    ("gpt2 mlp/gate row 0", "gar", 32, 768, 410, 3072),
    ("gpt2 mlp/down row 6", "gar", 32, 3072, 768, 768),
    ("gpt2 attn/q row 0", "gar", 64, 768, 410, 768),
    ("gpt2 mlp/gate row 0", "gar", 64, 768, 410, 3072),
    ("gpt2 mlp/down row 6", "gar", 64, 3072, 768, 768),
    ("gpt2 mlp/gate row 6", "lowrank", 1024, 768, 768, 3072, 768),
]


def _sleep_cycles(host_s: float, n: int) -> int:
    # keep the card busy while the host enqueues n calls, so the events
    # time the device work back to back and not the host's launch gaps
    return int(min(2e9 * host_s * (n + 2) * 2 + 2e6, 4e9))


def device_ms(calls: List[Callable[[], object]], reps: int = 25) -> float:
    """Median device milliseconds of one call, cycling over ``calls``."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls[0]()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(_sleep_cycles(host_s, reps))
    events[0].record()
    for i in range(reps):
        calls[i % len(calls)]()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def inputs(kind: str, t: int, n: int, r: int, m: int, seed: int, dev):
    """x, the factors (and GAR's perm_inv), float32 on the card, and the
    float64 product they should give."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(t, n, generator=g).to(dev)
    v = (torch.randn(n, r, generator=g) / math.sqrt(n)).to(dev)
    if kind == "gar":
        u = (torch.randn(m - r, r, generator=g) / math.sqrt(r)).to(dev)
        perm_inv = torch.randperm(m, generator=g).to(dev)
        z = x.double() @ v.double()
        want = torch.cat([z, z @ u.double().T], 1)[:, perm_inv]
        return (x, v, u, perm_inv), want
    u = (torch.randn(m, r, generator=g) / math.sqrt(r)).to(dev)
    return (x, v, u), x.double() @ v.double() @ u.double().T


def call(kind: str, args, rank):
    if kind == "gar":
        return gk.gar_matmul(*args)
    return lk.lowrank_matmul(*args, rank)


def use(defines: Tuple[str, ...]) -> None:
    """Route both wrappers to the libraries built with ``defines``, tiled
    with their own cluster occupancy."""
    for mod, orig in ((gk, _GAR_LIB), (lk, _LOWRANK_LIB)):
        mod._lib = (lambda o=orig: o(defines))
    lk.card_slots.cache_clear()


_GAR_LIB, _LOWRANK_LIB = gk._lib, lk._lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="comma-separated -D macros, e.g. LRC_WGMMA_MIN=8")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--out", help="write the table as JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("core_variants times the kernels on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"# card: {smi}", flush=True)
    builds: Dict[str, Tuple[str, ...]] = {"default": ()}
    for v in args.variant:
        builds[v] = tuple(d for d in v.split(",") if d)
    names = ["gar_matmul", "lowrank_matmul"]
    for label, defines in builds.items():
        t0 = time.perf_counter()
        build.build(names, defines)
        print(f"# build {label}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    for key, (_, ptx) in sorted(build.build_log.items()):
        for line in ptx.splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   {key}: {line.strip()}")
    order = list(builds) + list(builds)[::-1]
    rows = []
    for i, (label, kind, t, n, r, m, *rank) in enumerate(SHAPES):
        rank = rank[0] if rank else None
        base, want = inputs(kind, t, n, r, m, i, dev)
        nb = sum(a.numel() * a.element_size() for a in base)
        copies = min(64, max(2, math.ceil(2 * L2_BYTES / nb)))
        sets = [base] + [tuple(a.clone() for a in base)
                         for _ in range(copies - 1)]
        scale = float(want.abs().max())
        times: Dict[str, List[float]] = {b: [] for b in builds}
        err: Dict[str, float] = {}
        for b in order:
            use(builds[b])
            y = call(kind, base, rank)
            err[b] = float((y.double() - want).abs().max()) / scale
            if err[b] >= TOL:
                raise SystemExit(f"{b} at {label} T {t}: error "
                                 f"{err[b]:.2e} of the max >= {TOL}")
            times[b].append(device_ms(
                [lambda s=s: call(kind, s, rank) for s in sets], args.reps))
        use(())
        bn = (gk.tiling(t, n, r, m) if kind == "gar"
              else lk.tiling(t, n, rank, m)).stage1.bn
        row = {"shape": f"{label}, {kind}, T {t}, n {n}, r {r}, m {m}",
               "token_tile": bn,
               "ms": {b: statistics.fmean(v) for b, v in times.items()},
               "passes_ms": times, "rel_err": err}
        rows.append(row)
        d = row["ms"]["default"]
        print(f"# [{row['shape']}, BN {bn}] default {d:.4f} ms; "
              + "; ".join(f"{b} {row['ms'][b]:.4f} ms ({row['ms'][b] / d:.3f}"
                          f"x)" for b in builds if b != "default"),
              flush=True)
    out = {"card": smi, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
