"""Serving launcher on the card: build an elastic model from a seeded dense
init (calibration on the synthetic source, DataSVD and DP through
``launch.train.build_flexrank_state``, as the JAX package's launcher does),
then serve a stream of requests at mixed budgets through the GAR-deployed
submodels with the continuous-batching engine (paged KV cache, chunked
prefill fused into decode iterations with ``--prefill-chunk``; what
``auto`` picks for attention stacks, the MoE ones deepseek-moe-16b and
llama4-scout-17b-a16e among them), or with the drain engine (``--engine
drain``, and what ``auto`` picks for the recurrent families rwkv6-3b and
zamba2-7b, for minicpm3-4b's MLA and for the audio (seamless-m4t-medium)
and vision (llama-3.2-vision-11b) families: static batches through the
contiguous prefill/decode with carried recurrent states or MLA's latent
cache; the requests are text only, so the audio encoder does not run and
the cross blocks are skipped, as in the reference). ``--spec-draft-rank`` turns
on nested self-speculative decoding (a low-rank prefix row drafts up to
``--spec-len`` tokens a round, the full row verifies them in one
multi-token forward; with ``--temperature`` the rounds accept and resample
stochastically unless ``--spec-no-stochastic`` keeps the verify-only
fallback, and ``--spec-adaptive-k`` adapts each sequence's draft
length). ``--stream`` serves through the asyncio front door
(``serving.session``): open-loop arrivals (Poisson at ``--arrival-rate``),
every token echoed as it streams, every ``--cancel-nth`` request cancelled
after two tokens; ``--lookahead`` turns on the one-iteration lookahead
pipeline. The live telemetry plane: ``--trace-ring N`` flight-records
into a bounded ring, ``--metrics-out`` writes the metrics registry,
``--statusz-port`` serves ``/metrics``, ``/statusz`` and ``/debug/trace``
while the engine runs (``--status-linger`` keeps it up after),
``--watchdog`` ticks the anomaly watchdog every iteration (bundles under
``--postmortem-dir``), and ``--jax-profile DIR`` writes a
``torch.profiler`` trace of the serve (the reference's flag name, so that
one argv drives both launchers).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
      --requests 6 --budgets 0.4,1.0 --engine continuous --prefill-chunk 64 \
      --spec-draft-rank 0.7 --spec-len 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
      --prefill-chunk 64 --stream --lookahead --arrival-rate 20 \
      --cancel-nth 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --prefill-chunk 8 --trace-ring 4096 --metrics-out /tmp/m.prom \
      --statusz-port 0 --watchdog --postmortem-dir /tmp/pm
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-moe-16b --smoke --device cpu --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-11b --smoke --device cpu

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead (use ``--smoke`` there). The flags are those of
``repro.launch.serve`` that this port supports so far.
"""
from __future__ import annotations

import argparse
import asyncio
import threading
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import make_source
from repro_torch.launch.train import build_flexrank_state, dense_init
from repro_torch import obs
from repro_torch.serving import ElasticEngine, Request, SamplingParams
from repro_torch.serving.session import StreamSession
from repro_torch.spec import SpecConfig


def serving_state(cfg, dense_params, seed: int, *, timings=None):
    """The launcher's FlexRank state: calibrate (text only) on the first
    batches of a synthetic source of 4 x 65 tokens, DataSVD-decompose and
    DP-select, as the JAX package's serving launcher does. Returns
    (factorized params, table, infos); ``timings`` as for
    ``build_flexrank_state``."""
    source = make_source(cfg.vocab_size, 64, 4, seed=seed)
    return build_flexrank_state(cfg, dense_params, source, timings=timings)


def _run_stream(engine, reqs, args):
    """Asyncio front door: submit ``reqs`` open-loop (Poisson gaps when
    ``--arrival-rate`` is set), echo every token as it streams, cancel
    every ``--cancel-nth`` request after its second token. The engine
    serves on a worker thread (``serve_session`` enters ``torch.no_grad``
    there). Returns per-request Results in submission order, cancelled
    ones included."""

    async def _drive():
        session = StreamSession(stream_buffer=8)
        session.loop = asyncio.get_running_loop()
        worker = threading.Thread(target=engine.serve_session,
                                  args=(session,), daemon=True)
        worker.start()
        rng = np.random.default_rng(args.seed + 1)

        async def client(i, rq):
            cancel_after = (2 if args.cancel_nth
                            and (i + 1) % args.cancel_nth == 0 else None)
            h = session.submit(rq)
            toks = []
            async for tok in h.tokens():
                toks.append(tok)
                print(f"req {i} token[{len(toks) - 1}] = {tok}", flush=True)
                if cancel_after is not None and len(toks) >= cancel_after:
                    print(f"req {i}: cancelling mid-stream", flush=True)
                    h.cancel()
            result = await h.wait_result()
            state = "cancelled" if (result is not None
                                    and result.cancelled) else "done"
            print(f"req {i}: {state}, {len(toks)} tokens streamed",
                  flush=True)
            return result

        tasks = []
        for i, rq in enumerate(reqs):
            if args.arrival_rate > 0 and i:
                await asyncio.sleep(rng.exponential(1.0 / args.arrival_rate))
            tasks.append(asyncio.create_task(client(i, rq)))
        results = await asyncio.gather(*tasks)
        session.close()
        await session.join()
        worker.join()
        return list(results)

    return asyncio.run(_drive())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, an error without "
                         "it); cpu runs the kernels' plain versions")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--budgets", default="0.4,0.7,1.0")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "continuous", "drain"],
                    help="continuous = paged cache + mid-decode joins; "
                         "drain = static batches through the contiguous "
                         "prefill/decode; auto = continuous where the "
                         "family allows it (attention stacks, MoE "
                         "included), else drain (rwkv6, zamba2, MLA, "
                         "audio, vision)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens per chunk for mixed prefill/decode "
                         "iterations (0 = full-prompt chunks)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="total tokens per mixed or speculative iteration "
                         "(0 = max_batch + prefill_chunk)")
    ap.add_argument("--prefill-order", default="fifo",
                    choices=["fifo", "srpf"])
    ap.add_argument("--spec-draft-rank", type=float, default=0.0,
                    help="budget fraction of the speculative draft row "
                         "(0 = speculation off); drafts run on the nested "
                         "low-rank prefix submodel, the full row verifies")
    ap.add_argument("--spec-len", type=int, default=4,
                    help="max draft tokens proposed per speculative round")
    ap.add_argument("--spec-adaptive-k", action="store_true",
                    help="adapt each sequence's draft length to its "
                         "trailing acceptance-rate EWMA within "
                         "[0, --spec-len]")
    ap.add_argument("--spec-no-stochastic", action="store_true",
                    help="verify-only fallback for sampled requests "
                         "(k = 0 rounds, token-identical to the "
                         "non-speculative engine) instead of stochastic "
                         "accept/resample")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for all requests "
                         "(0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation when sampling (0 = off)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching of full prompt blocks")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the asyncio streaming front door "
                         "(open-loop arrivals, per-token streaming) instead "
                         "of the closed-batch generate() call")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="with --stream: mean Poisson request arrival rate "
                         "in req/s (0 = submit everything at once)")
    ap.add_argument("--cancel-nth", type=int, default=0,
                    help="with --stream: cancel every Nth request after 2 "
                         "streamed tokens (0 = never)")
    ap.add_argument("--lookahead", action="store_true",
                    help="one-iteration lookahead pipelining: queue "
                         "iteration i+1 from speculatively advanced state "
                         "before reading i's tokens (default follows the "
                         "REPRO_ASYNC env knob, off otherwise)")
    ap.add_argument("--no-lookahead", action="store_true",
                    help="force lookahead off regardless of REPRO_ASYNC")
    ap.add_argument("--host-sampling", action="store_true",
                    help="sample on the host (the oracle path) instead of "
                         "the default device-resident fused sampling")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run here "
                         "(a .jsonl suffix writes one event per line)")
    ap.add_argument("--metrics-out", default="",
                    help="write Prometheus text exposition of the run's "
                         "metrics registry here (a .jsonl suffix appends "
                         "a flat snapshot line instead)")
    ap.add_argument("--jax-profile", default="", metavar="DIR",
                    help="bracket the serve in a torch.profiler trace "
                         "written to DIR (a *.pt.trace.json that Perfetto "
                         "and TensorBoard load); also turns on "
                         "record_function scopes around the fused steps "
                         "(the reference launcher's flag name, where it "
                         "takes a jax.profiler trace)")
    ap.add_argument("--statusz-port", type=int, default=None, metavar="PORT",
                    help="serve the live telemetry plane on this port "
                         "(0 = ephemeral, printed at startup): GET "
                         "/metrics (Prometheus text), /statusz (live "
                         "engine JSON), /debug/trace (flight-recorder "
                         "dump as Chrome trace JSON)")
    ap.add_argument("--status-linger", type=float, default=0.0, metavar="S",
                    help="keep the status server (and process) up S "
                         "seconds after generation finishes so the "
                         "endpoints can be scraped post-run")
    ap.add_argument("--trace-ring", type=int, default=0, metavar="N",
                    help="record traces into a bounded drop-oldest ring of "
                         "N events (the always-on flight recorder) instead "
                         "of the unbounded post-hoc tracer")
    ap.add_argument("--watchdog", action="store_true",
                    help="evaluate the anomaly watchdog every engine "
                         "iteration (stall, TTFT/inter-token SLO, "
                         "fragmentation spike, spec-acceptance and "
                         "prefix-hit-rate collapse; thresholds in "
                         "repro_torch/obs/watchdog.py)")
    ap.add_argument("--postmortem-dir", default="", metavar="DIR",
                    help="where watchdog firings write their postmortem "
                         "bundles (ring dump + metrics snapshot + live "
                         "state); empty = no bundles, the firing still "
                         "traces and counts")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(args.seed)
    dense = dense_init(cfg, args.seed, device)
    setup = {}
    params_fact, table, infos = serving_state(cfg, dense, args.seed,
                                              timings=setup)
    print(f"# flexrank state: calibrate {setup['calibrate']:.2f} s, DataSVD "
          f"decompose {setup['decompose']:.2f} s, DP {setup['dp']:.2f} s "
          f"({table.table.shape[0]} rows; {setup['plain_svd']} of "
          f"{len(infos)} groups plain SVD, no moment)", flush=True)
    del dense
    spec = (SpecConfig(draft_rank=args.spec_draft_rank,
                       spec_len=args.spec_len,
                       stochastic=not args.spec_no_stochastic,
                       adaptive_k=args.spec_adaptive_k)
            if args.spec_draft_rank else None)
    live_plane = args.statusz_port is not None or args.watchdog
    if args.trace_ring:
        tracer = obs.RingTracer(args.trace_ring)
    elif args.trace_out:
        tracer = obs.make_tracer(True)
    elif live_plane:
        # a live serve must stay bounded: flight-record by default
        tracer = obs.RingTracer()
    else:
        tracer = None
    registry = (obs.MetricsRegistry()
                if args.metrics_out or live_plane else None)
    watchdog = (obs.Watchdog(postmortem_dir=args.postmortem_dir or None)
                if args.watchdog else None)
    engine = ElasticEngine(cfg, params_fact, table, infos,
                           max_batch=args.max_batch, max_len=args.max_len,
                           block_size=args.block_size,
                           prefill_chunk=args.prefill_chunk or None,
                           token_budget=args.token_budget or None,
                           prefill_order=args.prefill_order,
                           spec=spec,
                           device_sampling=not args.host_sampling,
                           prefix_cache=True if args.prefix_cache else None,
                           lookahead=(True if args.lookahead else False
                                      if args.no_lookahead else None),
                           tracer=tracer, registry=registry,
                           watchdog=watchdog,
                           costaudit=True if live_plane else None,
                           device=device)
    server = None
    if args.statusz_port is not None:
        # the ring recorder supports ?last_s=N windowed dumps; the plain
        # post-hoc tracer always dumps everything it has
        trace_fn = (tracer.dump if isinstance(tracer, obs.RingTracer)
                    else lambda last_s=None: tracer.to_chrome())
        server = obs.StatusServer(registry=registry,
                                  status_fn=engine.statusz,
                                  trace_fn=trace_fn,
                                  port=args.statusz_port)
        server.start()
        print(f"# statusz: {server.url} "
              f"(/metrics /statusz /debug/trace)", flush=True)
    budgets = [float(b) for b in args.budgets.split(",")]
    sampling = (SamplingParams(temperature=args.temperature,
                               top_k=args.top_k, seed=args.seed)
                if args.temperature > 0 else None)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32)
        reqs.append(Request(prompt=prompt, max_new_tokens=args.max_new,
                            budget=budgets[i % len(budgets)],
                            sampling=sampling))
    with obs.profiling.profile(args.jax_profile):
        if args.stream:
            results = _run_stream(engine, reqs, args)
        else:
            results = engine.generate(reqs, mode=args.engine)
    if args.trace_out:
        if args.trace_out.endswith(".jsonl"):
            engine.tracer.export_jsonl(args.trace_out)
        else:
            engine.tracer.export_chrome(args.trace_out)
        print(f"# trace: {len(engine.tracer)} events -> {args.trace_out}")
    if args.metrics_out:
        if args.metrics_out.endswith(".jsonl"):
            registry.snapshot_jsonl(args.metrics_out)
        else:
            registry.write_prometheus(args.metrics_out)
        print(f"# metrics -> {args.metrics_out}")
    for i, (rq, rs) in enumerate(zip(reqs, results)):
        print(f"req {i}: budget={rq.budget:.2f} -> row {rs.budget_row} "
              f"({rs.deployed_params:,} params) "
              f"tokens={rs.tokens[:12].tolist()}...")
    s = engine.last_metrics.summary()
    print(f"# serving: {s['tokens_per_s']:.1f} tok/s, "
          f"ttft mean {s['ttft_mean_s']*1e3:.1f} ms "
          f"(queue {s['ttft_queue_mean_s']*1e3:.1f} + "
          f"prefill {s['ttft_prefill_mean_s']*1e3:.1f} + "
          f"first-decode {s['ttft_first_decode_mean_s']*1e3:.1f}), "
          f"cache occupancy peak {s['cache_occupancy_peak']:.2f}, "
          f"preemptions {s['preemptions']}")
    if engine.last_metrics.timing_log:       # the drain engine times none
        print(f"# iteration split: dispatch {s['dispatch_ms_mean']:.2f} ms "
              f"/ host {s['host_ms_mean']:.2f} ms "
              f"({'host' if args.host_sampling else 'device'} sampling, "
              f"{device})")
    if engine.lookahead:
        print(f"# lookahead: {s['lookahead_iterations']:.0f} speculative "
              f"iterations, {s['rollbacks']:.0f} rollbacks, overlap share "
              f"{s['overlap_fraction']:.3f}")
    if args.prefill_chunk:
        print(f"# chunked prefill: chunk={args.prefill_chunk}, "
              f"budget={engine.token_budget}, "
              f"{s['mixed_iterations']:.0f} mixed iterations")
    if engine.prefix_cache:
        print(f"# prefix cache: {s['prefix_hits']:.0f} hits, "
              f"{s['prefix_hit_tokens']:.0f} prompt tokens reused")
    if args.spec_draft_rank and s["spec_rounds"]:
        mode = ("verify-only" if args.temperature > 0
                and args.spec_no_stochastic
                else "stochastic" if args.temperature > 0 else "greedy")
        k_mode = ("adaptive<=" if args.spec_adaptive_k else "") \
            + str(args.spec_len)
        print(f"# spec decode ({mode}): "
              f"draft_rank={args.spec_draft_rank}, k={k_mode}, "
              f"{s['spec_rounds']:.0f} rounds, "
              f"acceptance {s['spec_acceptance_rate']:.2f}, "
              f"mean accepted len {s['spec_mean_accepted_len']:.2f}")
    if watchdog is not None:
        for rec in watchdog.fired:
            where = f" -> {rec['bundle']}" if rec["bundle"] else ""
            print(f"# watchdog fired: {rec['rule']} — {rec['reason']}{where}")
    if server is not None:
        if args.status_linger > 0:
            print(f"# statusz lingering {args.status_linger}s at "
                  f"{server.url}", flush=True)
            time.sleep(args.status_linger)
        server.stop()
    return results


if __name__ == "__main__":
    main()
