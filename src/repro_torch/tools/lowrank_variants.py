"""Compare tile variants of the low-rank kernel (``csrc/lowrank_matmul.cu``)
at the shapes and ranks of the training path, on the card.

  PYTHONPATH=src python -m repro_torch.tools.lowrank_variants \
      [--variants shipped,nj4pad4] [--out FILE]

Builds each variant with its ``-D`` tile sizes (one ``nvcc`` each, all at
once), builds the FlexRank state of gpt2-small at full width as the
training launcher does (seed 0, 8 calibration batches of 8 x 129 tokens),
and times every variant and the plain version at T = 1024 tokens on each
distinct (n, m, r, kept rank) of the table's rows. A row's time is the sum
over its 84 projections, one student forward's kernel time; training draws
the rows uniformly, so the mean over the rows is what a step pays. Every
variant is held against the plain version at every shape (tolerance
relative to the output's max, as in ``chip_smoke.py``). Times are CUDA-event
medians of 25 launches over input copies that exceed the L2 cache.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import lowrank_matmul

# name -> -D tile sizes over the source's defaults (the shipped kernel:
# 2 columns a thread, unpadded z rows); nj4pad4 is the kernel's first
# version
VARIANTS: Dict[str, Dict[str, int]] = {
    "shipped": {},
    "nj4pad4": {"NJ": 4, "ZPAD": 4},
    "pad4": {"ZPAD": 4},
    "nj1": {"NJ": 1},
    "nt128tpt8": {"NT": 128, "TPT": 8},
}
TOKENS = 1024
TOL = 2e-4                     # relative to the output's max
L2_BYTES = 50 * 2**20


def build_variants(names: List[str]) -> Dict[str, ctypes.CDLL]:
    """One nvcc per variant, started together; returns the loaded
    libraries with their C signatures declared."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "lowrank_matmul.cu"
    procs = {}
    for name in names:
        defs = [f"-D{k}={v}" for k, v in sorted(VARIANTS[name].items())]
        out = build.BUILD_DIR / f"liblowrank_variant_{name}.{os.getpid()}.so"
        procs[name] = (out, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *defs, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"# variant {name} {VARIANTS[name]}: {' | '.join(ptxas)}")
        lib = ctypes.CDLL(str(out))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lowrank_matmul_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.lowrank_matmul_f32.restype = i
        lib.lowrank_matmul_smem_bytes.argtypes = [i]
        lib.lowrank_matmul_smem_bytes.restype = i
        libs[name] = lib
    return libs


def launch(lib, x, v, u, kr: int) -> torch.Tensor:
    y = torch.empty((x.shape[0], u.shape[0]), dtype=x.dtype,
                    device=x.device)
    lowrank_matmul.launch(lib, x, v, u, y, kr)
    return y


def device_ms(calls, reps: int = 25) -> float:
    """Median device ms of one call, ``calls`` cycled over distinct input
    copies; a device sleep covers the host's enqueueing."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls[0]()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(min(2e9 * host_s * (reps + 2) * 2 + 2e6, 4e9)))
    events[0].record()
    for i in range(reps):
        calls[i % len(calls)]()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def training_shapes():
    """Per budget row, a Counter of (n, m, r, kept rank) over the
    factorized projections of gpt2-small's FlexRank state."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_source
    from repro_torch.launch.train import build_flexrank_state, dense_init
    cfg = get_config("gpt2-small")
    dense = dense_init(cfg, 0, torch.device("cuda"))
    source = make_source(cfg.vocab_size, 128, 8, seed=0)
    _, table, infos = build_flexrank_state(cfg, dense, source)
    rows = []
    for row in np.asarray(table.table):
        c = Counter()
        for info in infos:
            c[(info.n, info.m, info.full_rank, int(row[info.col]))] += \
                math.prod(info.lead_dims)
        rows.append(c)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lowrank_variants times the kernel on an NVIDIA GPU;"
                         " CUDA is not available here")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = args.variants.split(",")
    libs = build_variants(names)
    rows = training_shapes()
    shapes = sorted(set().union(*rows))
    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    times: Dict[tuple, Dict[str, float]] = {}
    for n, m, r, kr in shapes:
        x = torch.as_tensor(gen.standard_normal((TOKENS, n), np.float32),
                            device=dev)
        v = torch.as_tensor(gen.standard_normal((n, r), np.float32)
                            / math.sqrt(n), device=dev)
        u = torch.as_tensor(gen.standard_normal((m, r), np.float32)
                            / math.sqrt(r), device=dev)
        copies = min(64, max(2, math.ceil(
            2 * L2_BYTES / (4 * (v.numel() + u.numel())))))
        sets = [(v.clone(), u.clone()) for _ in range(copies)]
        y_plain = ref.lowrank_matmul_ref(x, v, u, kr)
        scale = float(y_plain.abs().max()) + 1e-6
        t = {"plain": device_ms([lambda s=s: ref.lowrank_matmul_ref(
            x, s[0], s[1], kr) for s in sets])}
        for name in names:
            err = float((launch(libs[name], x, v, u, kr) - y_plain)
                        .abs().max()) / scale
            if not err < TOL:
                raise SystemExit(f"variant {name} at {(n, m, r, kr)}: "
                                 f"relative error {err:.3e}")
            t[name] = device_ms([lambda s=s, lib=libs[name]: launch(
                lib, x, s[0], s[1], kr) for s in sets])
        times[(n, m, r, kr)] = t
        print("# (n %4d, m %4d, r %3d, kr %3d): " % (n, m, r, kr) + "  ".join(
            f"{k} {ms:.4f}" for k, ms in t.items()), flush=True)
    cols = names + ["plain"]
    per_row = [{c: sum(cnt * times[s][c] for s, cnt in row.items())
                for c in cols} for row in rows]
    print("per-forward kernel ms (84 projections, T = %d)" % TOKENS)
    print("row  " + "".join(f"{c:>11}" for c in cols))
    for k, pr in enumerate(per_row):
        print(f"{k:<5}" + "".join(f"{pr[c]:11.3f}" for c in cols))
    mean = {c: statistics.fmean(pr[c] for pr in per_row) for c in cols}
    print("mean " + "".join(f"{mean[c]:11.3f}" for c in cols))
    best = min(names, key=mean.get)
    print(f"# fastest over a uniform row draw: {best} {VARIANTS[best]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# {smi}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "variants": {n: VARIANTS[n]
                                                   for n in names},
                       "shapes": [{"n": s[0], "m": s[1], "r": s[2],
                                   "kr": s[3], **times[s]} for s in shapes],
                       "per_row": per_row, "mean": mean, "best": best},
                      f, indent=1)


if __name__ == "__main__":
    main()
