"""Where a call of the SSD kernels (``kernels/csrc/ssd.cu``) spends its time,
on the card: the kernels built with ``-DSSD_PROFILE=1`` stamp the global
timer at each block's phases, and this prints the median of each phase
over the blocks.

  PYTHONPATH=src python -m repro_torch.tools.ssd_phases [--shape B,S,H,G]
      [--out FILE]

Default shape: zamba2-7b's training call (B 8, S 128, H 112, G 1). The
call runs once after a warm-up, behind a device sleep (so both launches
are queued before the first starts) and after a write that flushes the
L2 cache. Phases of a scan block (one line each, median / min / max in
microseconds): start to its first pair's x landed; then per pair of
(chunk, head): the split of x dt and the cumulative decays, (first pair
only) the wait for the scores of launch 1 (``griddepcontrol.wait``), the
products, the stores of y, and the wait for the next pair's x. The score
blocks: start, b and c landed, end.
The stamped build runs the same code as the default one plus a store a
phase from one thread; its call time is printed beside the default's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import ssd as sk

DEFINES = ("SSD_PROFILE=1",)
SCAN_BLOCKS = 2048             # stamped blocks (csrc/ssd.cu)
SCORES = 16 * SCAN_BLOCKS


def _inputs(b, s, h, g, dev):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, g, 64)).astype(np.float32)
              for _ in range(2))
    return [torch.as_tensor(t, device=dev) for t in (x, dt, a, bb, cc)]


def _one_call_ms(lib, ts, y) -> float:
    junk = torch.empty(64 * 2**20, device=y.device)
    for _ in range(3):
        sk._run(lib, *ts, y)
    junk.zero_()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(int(2e7))
    ev[0].record()
    sk._run(lib, *ts, y)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="8,128,112,1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    b, s, h, g = (int(v) for v in args.shape.split(","))
    dev = torch.device("cuda")
    ts = _inputs(b, s, h, g, dev)
    y = torch.empty_like(ts[0])
    lib = sk._lib(DEFINES)
    lib.ssd_stamps_read.argtypes = [ctypes.c_void_p]
    ms_default = _one_call_ms(sk._lib(), ts, y)
    ms = _one_call_ms(lib, ts, y)
    stamps = np.zeros(SCORES + 4 * 1024, np.uint64)
    if lib.ssd_stamps_read(stamps.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    lay = sk.layout(b, s, h, g)
    nscan = min(lay.scan_blocks, SCAN_BLOCKS)
    scan = stamps[:16 * nscan].reshape(nscan, 16).astype(np.int64)
    scores = stamps[SCORES:SCORES + 4 * min(lay.score_blocks, 1024)]
    scores = scores.reshape(-1, 4)[:, :3].astype(np.int64)
    t0 = min(int(scores[:, 0].min()), int(scan[:, 0].min()))
    # pairs each scan block ran: at most 3 stamped
    pairs = min(3, lay.chunks * min(sk.HEADS_A_BLOCK, h // g))
    names = ["start to pair 0's x landed"]
    cols = [(0, 2)]
    for q in range(pairs):
        base = 2 + 4 * q
        names.append(f"pair {q}: split x dt and cum")
        cols.append((base, base + 1))
        if q == 0:
            names += ["pair 0: wait for the scores", "pair 0: products"]
            cols += [(3, 1), (1, 4)]
        else:
            names.append(f"pair {q}: products")
            cols.append((base + 1, base + 2))
        names.append(f"pair {q}: y stored")
        cols.append((base + 2, base + 3))
        if q + 1 < pairs:
            names.append(f"pair {q}: to pair {q + 1}'s x landed")
            cols.append((base + 3, base + 4))
    names.append("block total")
    cols.append((0, 14))
    rows = []
    for name, (i, j) in zip(names, cols):
        d = (scan[:, j] - scan[:, i]) / 1e3
        rows.append(dict(phase=name, median_us=float(np.median(d)),
                         min_us=float(d.min()), max_us=float(d.max())))
    out = dict(
        card=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        shape=dict(B=b, S=s, H=h, G=g), call_ms=ms_default,
        stamped_call_ms=ms, scan_blocks=lay.scan_blocks,
        score_blocks=lay.score_blocks,
        scores_us=dict(
            start_max=float((scores[:, 0].max() - t0) / 1e3),
            landed_median=float(np.median(scores[:, 1] - t0) / 1e3),
            end_max=float((scores[:, 2].max() - t0) / 1e3)),
        scan_start_us=dict(
            first=float((scan[:, 0].min() - t0) / 1e3),
            median=float((np.median(scan[:, 0]) - t0) / 1e3),
            last=float((scan[:, 0].max() - t0) / 1e3)),
        scan_end_us=float((scan[:, 14].max() - t0) / 1e3),
        phases=rows)
    print(f"# {out['card']}; B={b} S={s} H={h} G={g}: call {ms_default:.4f} "
          f"ms, stamped build {ms:.4f} ms")
    print(f"# score blocks end by {out['scores_us']['end_max']:.2f} us; scan "
          f"blocks start {out['scan_start_us']['first']:.2f} (first), "
          f"{out['scan_start_us']['median']:.2f} (median), "
          f"{out['scan_start_us']['last']:.2f} us (last), all end by "
          f"{out['scan_end_us']:.2f} us")
    for r in rows:
        print(f"#   {r['phase']:40s} {r['median_us']:8.2f} us (min "
              f"{r['min_us']:.2f}, max {r['max_us']:.2f})")
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
