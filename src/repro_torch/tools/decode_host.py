"""The time a decode step takes on the host at full width: the drain
engine's ``decode_step`` over the contiguous cache and, for configs the
paged cache serves, the continuous engine's ``paged_decode_step``, on
seeded dense parameters cut to the first layers of each config.

  PYTHONPATH=src python src/repro_torch/tools/decode_host.py
      [--archs gpt2-small,minicpm3-4b,rwkv6-3b,zamba2-7b] [--layers 4]
      [--batch 4] [--prompt 128] [--steps 32] [--rounds 3] [--label L]

Run by its path, it times the ``repro_torch`` that PYTHONPATH names, so
one call on one card can time two trees of the repo in turn (say, a
parent commit unpacked beside the checkout: parent, change, change,
parent). At these widths a decode step's kernels take a few ms and the
Python that queues them most of the step, so the figures read the
host's cost of the code between the kernels.

Each round fills the cache with a ``--prompt`` token prefill (the paged
cache only reserves its blocks), then takes ``--steps`` steps of one
token a sequence, each timed on the host's clock twice: until the call
returns (queued), and through a synchronize (done); then one more
round under ``cProfile`` counts the Python function calls a step. One
JSON line an (arch, step): the medians over every round's steps after
the first round, the calls a step, and the card's name and power limit.
``--device cpu --smoke`` counts the calls on the CPU at the smoke widths
(they do not depend on the widths); its times are no card's.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import dense_init
from repro_torch.models import transformer as tfm
from repro_torch.serving.kv_cache import PagedKVCache


def _block_layers(seg) -> int:
    return (seg.mamba_per_unit + 1 if seg.kind == "zamba_unit"
            else seg.self_per_unit + 1 if seg.kind == "vision_unit" else 1)


def cut(cfg, layers: int):
    """``cfg`` cut to its first blocks of at least ``layers`` layers in
    all (a zamba or vision unit is whole), widths unchanged."""
    segs, left = [], layers
    for seg in cfg.segments:
        if left <= 0:
            break
        per = _block_layers(seg)
        segs.append(dataclasses.replace(seg, count=min(seg.count,
                                                       -(-left // per))))
        left -= segs[-1].count * per
    return dataclasses.replace(
        cfg, segments=tuple(segs),
        num_layers=sum(s.count * _block_layers(s) for s in segs))


def _timed(step, n: int, sync):
    """(queued, done) ms of ``n`` calls of ``step()``."""
    queued, done = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        queued.append((t1 - t0) * 1e3)
        done.append((t2 - t0) * 1e3)
    return queued, done


def _calls(step, n: int) -> float:
    """Python function calls a call of ``step()``, over ``n`` calls."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        step()
    prof.disable()
    return pstats.Stats(prof).total_calls / n


def contiguous(params, cfg, args, dev, rng):
    """A ``decode_step`` of one token a sequence, after a prefill."""
    state = tfm.init_decode_state(cfg, args.batch, args.prompt + args.steps,
                                  dtype=torch.float32, device=dev)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (args.batch, args.prompt)),
                             dtype=torch.int32, device=dev)
    _, state = tfm.prefill(params, cfg, state, prompt)
    tok = prompt[:, -1:]
    box = [state]

    def step():
        _, box[0] = tfm.decode_step(params, cfg, box[0], tok)
    return step


def paged(params, cfg, args, dev, rng):
    """A ``paged_decode_step`` of one token a sequence, the blocks of the
    prompt and the steps reserved."""
    cache = PagedKVCache(cfg, max_batch=args.batch,
                         max_len=args.prompt + args.steps, block_size=16,
                         prefix_cache=False, device=dev)
    for slot in range(args.batch):
        cache.open_slot(slot)
        cache.extend_slot(slot, args.prompt + args.steps)
    box = [{"positions": torch.full((args.batch,), args.prompt,
                                    dtype=torch.int32, device=dev),
            "block_tables": cache.device_tables(),
            "segments": cache.pools}]
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (args.batch, 1)),
                          dtype=torch.int32, device=dev)

    def step():
        _, box[0] = tfm.paged_decode_step(params, cfg, box[0], tok)
    return step


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs",
                    default="gpt2-small,minicpm3-4b,rwkv6-3b,zamba2-7b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--device", default="cuda",
                    help="cpu (with --smoke) counts the Python calls; its "
                         "times are no card's")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' smoke widths")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("decode_host: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        sync = torch.cuda.synchronize
    else:
        card, sync = "cpu", (lambda: None)
    for arch in args.archs.split(","):
        cfg = cut(get_config(arch, smoke=args.smoke), args.layers)
        params = dense_init(cfg, 0, dev)
        ways = [("decode_step", contiguous)]
        if tfm.paged_compatible(cfg):
            ways.append(("paged_decode_step", paged))
        for name, make in ways:
            rng = np.random.default_rng(0)
            rounds = [_timed(make(params, cfg, args, dev, rng), args.steps,
                             sync) for _ in range(args.rounds)]
            queued = [x for q, _ in rounds[1:] for x in q]
            done = [x for _, d in rounds[1:] for x in d]
            calls = _calls(make(params, cfg, args, dev, rng), args.steps)
            print(json.dumps({
                "label": args.label, "arch": arch, "step": name,
                "layers": cfg.num_layers, "batch": args.batch,
                "steps": len(done),
                "queued_ms": float(np.median(queued)),
                "done_ms": float(np.median(done)),
                "done_ms_min": float(np.min(done)),
                "python_calls_a_step": calls, "card": card}), flush=True)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
