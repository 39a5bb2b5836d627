"""Batched quantized serving entry point of the port.

Initializes a model from a seed on the target device, deploys it at the
given precision and weight layout and drives the ServeEngine three ways,
as the JAX package's CLI does:

* default — closed-loop batch: submit every synthetic request up front,
  drain, report throughput, TTFT and the kernels' launch counts;
* ``--arrival-rate R`` — open-loop: Poisson arrivals at R req/s through
  the asyncio frontend, optionally with a first-token SLO
  (``--deadline-ms`` + ``--shed``), reporting SLO attainment and goodput
  alongside the engine stats;
* ``--http-port P`` — serve: the OpenAI-style HTTP endpoint
  (``/v1/completions`` with SSE streaming, ``/v1/stats``,
  ``/v1/metrics``, ``/health``) until interrupted.

``--trace FILE`` writes the run's Chrome/Perfetto trace and
``--metrics`` prints the Prometheus text ``/v1/metrics`` serves::

    python -m repro_torch.launch.serve --full --weights w4a8
    python -m repro_torch.launch.serve --full --weights w4a8 --kv-layout paged
    python -m repro_torch.launch.serve --device cpu --sched edf \
        --arrival-rate 20 --deadline-ms 500 --shed reject --trace t.json

``--tp N`` serves on N tensor-parallel ranks (``launch.mesh.spawn_tp``;
rank r on ``cuda:{r % device_count}``), each holding its slice of the
weights and of the KV pool (an MoE's experts split over the ranks, or
every expert's d_ff where N does not divide them; the whole attention
where N does not divide the heads; an RG-LRU's width and an mLSTM's
heads split over the ranks). Rank 0 takes the requests (the closed
loop's, or the frontend's with ``--http-port`` or ``--arrival-rate``),
prints and writes ``--trace``, ``--metrics`` and ``--bench-out``; the
other ranks follow its engine's steps (``ServeEngine.follow``), and an
idle frontend's heartbeats keep them inside ``--tp-timeout``. Under
``--tp`` with ``--http-port`` the ranks serve until Ctrl-C, which they
ignore but rank 0, which stops the others before it exits.
``--tp-backend`` is ``nccl`` (one card a rank)
unless told ``gloo`` (the CPU, or ranks sharing a card, which NCCL
refuses)::

    python -m repro_torch.launch.serve --weights w4a8 --kv-layout paged \
        --tp 2 --tp-backend gloo --device cpu
    python -m repro_torch.launch.serve --weights w4a8 --tp 2 \
        --tp-backend gloo --device cpu --http-port 8000
    python -m repro_torch.launch.serve --weights bf16 --tp 2 \
        --tp-backend gloo --device cpu --arrival-rate 20

The paged layout serves with speculative decoding unless ``--no-spec``
is given (a draft of half the target's layers proposes ``--spec-k`` = 4
tokens per slot and wave), as the reference's CLI does. Runs on ``cuda``
by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels on a reduced model (``--full`` off).
"""
from __future__ import annotations

import argparse
import builtins
import json
import signal
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels.kvq_attn import ops as kvq_ops
from repro_torch.kernels.w4a8.ops import (w4a8_accumulate, w4a8_epilogue,
                                          w4a8_matmul)
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import (POLICIES, PREEMPT_POLICIES,
                                         SHED_MODES, percentile)
from repro_torch.serve.spec import SpecConfig

COUNTED = {"w4a8_matmul": w4a8_matmul,
           "w4a8_accumulate": w4a8_accumulate,
           "w4a8_epilogue": w4a8_epilogue,
           "kvq_decode_attn": kvq_ops.kvq_decode_attn,
           "kvq_paged_decode_attn": kvq_ops.kvq_paged_decode_attn,
           "kvq_spec_verify_attn": kvq_ops.kvq_spec_verify_attn,
           "gather_dequant_paged_kv": kvq_ops.gather_dequant_paged_kv,
           "pool_block_copy": kvq_ops.copy_pool_blocks_multi}


def _silent(*args, **kw) -> None:
    """``print`` on ranks other than 0."""


def build_requests(args, cfg) -> list:
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(args.requests):
        plen = args.prompt_len
        if args.vary_prompts:
            plen = int(rng.integers(max(4, plen // 2), plen + 1))
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
            top_k=args.top_k,
            seed=uid))
    return reqs


def run_open_loop(args, engine, cfg):
    """Poisson arrivals at ``--arrival-rate`` req/s through the asyncio
    frontend; returns (engine stats + SLO metrics, wall seconds).

    The arrival times are drawn up front (the cumulative exponential
    gaps from the pass's start) and each request is submitted when the
    event loop reaches its time, so a late loop delays the submission,
    not the schedule. Client TTFT counts from the scheduled arrival, and
    ``submit_lag_*`` is how late the loop submitted (the step worker
    holding the GIL, mostly): the pass stays open-loop.

    Runs the workload twice: an untimed warmup pass (the kernels' first
    use builds and loads them, and the allocator warms up; a cold pass
    would blame those one-time stalls on the SLO), then, after an engine
    reset, the identical timed pass. On a mesh this runs on rank 0 and
    the other ranks follow (the warm-up pass's frontend leaves them
    following, the reset reaches them, the timed pass's stops them)."""
    import asyncio

    from repro_torch.serve.frontend import AsyncFrontend

    deadline_ms = args.deadline_ms or None

    async def one_pass(last):
        reqs = build_requests(args, cfg)
        gaps = np.random.default_rng(1).exponential(1.0 / args.arrival_rate,
                                                     len(reqs))
        async with AsyncFrontend(engine, default_deadline_ms=deadline_ms,
                                 stop_followers=last) as fe:
            t0 = time.perf_counter()
            due = t0 + np.cumsum(gaps)
            handles = []
            for req, at in zip(reqs, due):
                await asyncio.sleep(max(0.0, at - time.perf_counter()))
                handles.append(await fe.submit(
                    req.prompt, max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    seed=req.seed))
            for h in handles:
                await h.tokens()
            stats = await fe.stats()
        return list(zip(due.tolist(), handles)), stats, \
            time.perf_counter() - t0

    async def go():
        print("warmup pass (kernel builds, allocator warm-up)...")
        await one_pass(False)
        engine.reset()
        arrivals, stats, wall = await one_pass(True)
        shed = sum(1 for _, h in arrivals if h.shed)
        ttfts = sorted(h.first_token_t - at for at, h in arrivals
                       if not h.shed and h.first_token_t is not None)
        lags = sorted(h.submit_t - at for at, h in arrivals)
        stats["arrival_rate_rps"] = args.arrival_rate
        stats["client_ttft_n"] = len(ttfts)
        stats["client_ttft_p50_s"] = percentile(ttfts, 50)
        stats["client_ttft_p95_s"] = percentile(ttfts, 95)
        stats["submit_lag_p50_s"] = percentile(lags, 50)
        stats["submit_lag_max_s"] = lags[-1] if lags else 0.0
        if deadline_ms is not None:
            met = sum(1 for t in ttfts if t <= deadline_ms / 1e3)
            stats["slo_attainment"] = met / max(len(arrivals), 1)
            stats["goodput_rps"] = met / max(wall, 1e-9)
            print(f"open loop @ {args.arrival_rate:.1f} req/s: "
                  f"{met}/{len(arrivals)} met the {deadline_ms:.0f} ms "
                  f"first-token SLO ({shed} shed), goodput "
                  f"{stats['goodput_rps']:.2f} req/s")
        else:
            print(f"open loop @ {args.arrival_rate:.1f} req/s: "
                  f"{len(arrivals)} served, {shed} shed")
        print(f"client TTFT from the scheduled arrival (n={len(ttfts)}): "
              f"p50 {stats['client_ttft_p50_s']:.3f} s, p95 "
              f"{stats['client_ttft_p95_s']:.3f} s; submissions late by "
              f"p50 {1e3 * stats['submit_lag_p50_s']:.1f} ms, max "
              f"{1e3 * stats['submit_lag_max_s']:.1f} ms")
        return stats, wall

    return asyncio.run(go())


def run_http(args, engine):
    """Serve the OpenAI-style HTTP endpoint until interrupted (on a mesh,
    on rank 0; closing its frontend stops the other ranks)."""
    import asyncio

    from repro_torch.serve.frontend import AsyncFrontend
    from repro_torch.serve.http import ServeHTTP

    async def go():
        async with AsyncFrontend(
                engine, default_deadline_ms=args.deadline_ms or None) as fe:
            async with ServeHTTP(fe, host=args.http_host,
                                 port=args.http_port) as srv:
                print(f"serving on http://{args.http_host}:{srv.port} "
                      f"(POST /v1/completions, GET /v1/stats, "
                      f"/v1/metrics, /health; Ctrl-C to stop)", flush=True)
                await srv.serve_forever()

    try:
        asyncio.run(go())
    except KeyboardInterrupt:
        print("\nshutting down")


def write_obs(args, engine, stats=None):
    """``--trace`` / ``--metrics`` epilogue shared by the three drive
    modes (closed-loop drain, open-loop arrivals, HTTP serve)."""
    if args.trace:
        from repro_torch.obs.export import write_trace
        write_trace(args.trace, engine.trace)
        n_spans = sum(1 for e in engine.trace.events()
                      if e["ph"] == "span")
        print(f"wrote {args.trace}: {len(engine.trace)} trace records "
              f"({n_spans} spans, {engine.trace.dropped} dropped); load "
              f"at ui.perfetto.dev, summarize with "
              f"repro_torch.obs.export.render_report")
    if args.metrics:
        print(engine.metrics.render(stats if stats is not None
                                    else engine.stats()), end="")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="full-width config (default: the reduced one)")
    ap.add_argument("--policy", default="A8d-C8-W4")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--vary-prompts", action="store_true",
                    help="draw prompt lengths in [prompt_len/2, prompt_len]")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--decode-block", default="8",
                    help="decode steps per chunk between host syncs; "
                         "'auto' probes decode-chunk latency at startup. "
                         "With speculative decoding on (the paged default, "
                         "see --no-spec) the draft + verify wave owns step "
                         "granularity: this knob becomes spec-k + 1 and "
                         "the probe is skipped")
    ap.add_argument("--kv-layout", default="dense",
                    choices=("dense", "paged"),
                    help="paged = block-table KV pool with free-block "
                         "admission, chunked prefill and prefix sharing")
    ap.add_argument("--block-size", type=int, default=64,
                    help="tokens per cache block (paged layout)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool size in blocks (0 = match the dense "
                         "slots*cache_len budget)")
    ap.add_argument("--max-seq-len", type=int, default=0,
                    help="per-request token cap / block-table width "
                         "(paged; 0 = match the dense cache_len)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix sharing (paged; on by default: "
                         "prompts extending a cached prefix map the same "
                         "pool blocks and prefill only their tail)")
    ap.add_argument("--admission", default="reserve",
                    choices=("reserve", "optimistic"),
                    help="paged admission: reserve worst-case blocks up "
                         "front, or admit on prompt footprint and preempt "
                         "(swap out) a resident when the pool runs dry")
    ap.add_argument("--preempt", default="last_admitted",
                    choices=PREEMPT_POLICIES,
                    help="victim policy for optimistic-admission "
                         "preemption")
    ap.add_argument("--no-spec", action="store_true",
                    help="disable speculative decoding (the paged layout "
                         "enables it by default: a truncated-layer draft "
                         "proposes k tokens per slot and the target "
                         "verifies every resident's drafts in one wave, "
                         "rolling rejected suffixes back)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per slot per verify-wave")
    ap.add_argument("--spec-draft", type=int, default=0,
                    help="draft depth in layers (0 = half the target's "
                         "layers; equal to n_layers = self-draft)")
    ap.add_argument("--spec-accept", default="exact",
                    choices=("exact", "rejection"),
                    help="acceptance rule: 'exact' commits the target's "
                         "own samples (output identical to plain decode); "
                         "'rejection' runs speculative rejection sampling "
                         "for temperature/top-k requests")
    ap.add_argument("--tail-batch", type=int, default=0,
                    help="max tail/chunked prefills advanced per batched "
                         "wave (0 = every slot, 1 = one per step)")
    ap.add_argument("--no-prefix-affinity", action="store_true",
                    help="disable chain-grouped scheduling of prefix-hit "
                         "requests")
    ap.add_argument("--sched", default="fcfs", choices=POLICIES,
                    help="admission order: arrival, shortest-prompt, or "
                         "earliest-deadline-first within priority class "
                         "(pair edf with --deadline-ms / --shed)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop mode: Poisson arrivals at this many "
                         "requests/s through the asyncio frontend "
                         "(0 = closed-loop batch, the default)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request first-token SLO in ms (open-loop / "
                         "HTTP modes; 0 = no deadline). With --shed the "
                         "engine rejects or downgrades requests predicted "
                         "to miss it")
    ap.add_argument("--shed", default="none", choices=SHED_MODES,
                    help="SLO admission control when a queued request's "
                         "predicted TTFT exceeds its deadline: drop it "
                         "(reject) or clear its deadline and demote it "
                         "behind on-time work (downgrade)")
    ap.add_argument("--http-port", type=int, default=0,
                    help="serve mode: bind the OpenAI-style HTTP endpoint "
                         "(/v1/completions with SSE streaming) on this "
                         "port and run until interrupted (0 = off)")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--weights", default="bf16", choices=("bf16", "w4a8"),
                    help="serve weight layout: bf16 fake-quant matmuls, or "
                         "w4a8 packed-int4 weights x dynamic-int8 "
                         "activations through the w4a8 kernel")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--trace", default="",
                    help="record a runtime trace and write it here as "
                         "Chrome/Perfetto trace_event JSON (open at "
                         "ui.perfetto.dev). Open-loop runs trace the timed "
                         "pass only (the warmup's records are cleared by "
                         "the engine reset)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus text /v1/metrics serves "
                         "at the end of the run")
    ap.add_argument("--bench-out", default="",
                    help="write the run's stats to this JSON file")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (processes), each holding "
                         "its slice of the weights and the KV pool; the "
                         "frontend (--http-port, --arrival-rate) lives on "
                         "rank 0")
    ap.add_argument("--tp-backend", default="nccl",
                    choices=("nccl", "gloo"),
                    help="torch.distributed backend of --tp: nccl (one "
                         "card a rank) or gloo (the CPU, or ranks sharing "
                         "a card; through host memory)")
    ap.add_argument("--tp-timeout", type=float, default=3600.0,
                    help="seconds before the --tp ranks are killed (with "
                         "--http-port they serve until Ctrl-C), and the "
                         "longest a rank waits for another in a "
                         "collective")
    args = ap.parse_args(argv)
    if args.tp > 1:
        from repro_torch.launch.mesh import spawn_tp
        # serving HTTP until Ctrl-C: the ranks start with SIGINT ignored
        # (a spawned process keeps it so) and rank 0 takes it back, so
        # Ctrl-C stops rank 0's server, which stops the other ranks
        old = (signal.signal(signal.SIGINT, signal.SIG_IGN)
               if args.http_port else None)
        try:
            return spawn_tp(serve_rank, args.tp, args, device=args.device,
                            backend=args.tp_backend,
                            timeout_s=args.tp_timeout,
                            deadline=not args.http_port)
        finally:
            if old is not None:
                signal.signal(signal.SIGINT, old)
    return serve_rank(None, args)


def serve_rank(mesh, args):
    """Build and drive one engine (one rank's, on a ``--tp`` mesh: rank 0
    takes the requests, prints and writes files; the other ranks follow
    its engine and return None). Returns the run's stats."""
    quiet = mesh is not None and mesh.rank != 0
    print = _silent if quiet else builtins.print    # noqa: A001

    device = args.device if mesh is None else mesh.device
    cfg = get_config(args.arch) if args.full else get_reduced_config(args.arch)
    params = init_params(cfg, seed=0, device=device)
    kw = {}
    if args.kv_layout == "paged":
        kw = {"kv_layout": "paged", "block_size": args.block_size,
              "num_blocks": args.num_blocks or None,
              "max_seq_len": args.max_seq_len or None,
              "prefix_cache": not args.no_prefix_cache,
              "admission": args.admission, "preempt": args.preempt,
              "tail_batch": args.tail_batch,
              "prefix_affinity": not args.no_prefix_affinity}
        if not args.no_spec:
            kw["spec"] = SpecConfig(k=args.spec_k,
                                    draft_layers=args.spec_draft or None,
                                    accept_mode=args.spec_accept)
    tracer = None
    if args.trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    decode_block = (args.decode_block if args.decode_block == "auto"
                    else int(args.decode_block))
    eng = ServeEngine(cfg, params, policy=args.policy, slots=args.slots,
                      cache_len=args.cache_len,
                      max_new_cap=max(args.max_new, 1),
                      decode_block=decode_block, sched_policy=args.sched,
                      slo_shed=args.shed, weights_layout=args.weights,
                      trace=tracer, device=device, mesh=mesh, **kw)
    del params
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"policy={args.policy} weights={args.weights} "
          f"device={eng.device} tp={eng.tp} slots={args.slots} "
          f"cache_len={args.cache_len} kv_layout={args.kv_layout} "
          f"sched={args.sched} shed={args.shed}")
    if eng.decode_block_probe is not None:
        pr = eng.decode_block_probe
        print(f"decode_block auto: {pr['pick']} (a chunk of 1 step "
              f"{pr['t1_s'] * 1e3:.2f} ms, of 8 {pr['t8_s'] * 1e3:.2f} ms: "
              f"{pr['per_step_s'] * 1e3:.2f} ms a step, "
              f"{pr['overhead_s'] * 1e3:.2f} ms fixed)")
    if quiet:
        eng.follow()        # rank 0 takes the requests and drives
        return None
    if args.http_port:
        if mesh is not None:
            signal.signal(signal.SIGINT, signal.default_int_handler)
        run_http(args, eng)
        write_obs(args, eng)
        return None
    for fn in COUNTED.values():
        fn.launches = 0
    if args.arrival_rate > 0:
        stats, wall = run_open_loop(args, eng, cfg)
        n_reqs = args.requests
    else:
        reqs = build_requests(args, cfg)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
        wall = time.perf_counter() - t0
        n_reqs = len(reqs)
    stats["wall_s"] = wall
    stats["tokens_per_s"] = stats["tokens_out"] / wall
    # every finished request's first token came from its prefill
    stats["decode_tokens_per_s"] = ((stats["tokens_out"]
                                     - stats["requests_finished"])
                                    / max(stats["decode_s"], 1e-12))
    stats["kernel_launches"] = {name: fn.launches
                                for name, fn in COUNTED.items()}
    print(f"served {n_reqs} requests, {stats['tokens_out']} tokens in "
          f"{wall:.3f} s: {stats['tokens_per_s']:.1f} tok/s "
          f"(decode {stats['decode_tokens_per_s']:.1f} tok/s), "
          f"TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms "
          f"p95 {stats['ttft_p95_s'] * 1e3:.1f} ms")
    if args.kv_layout == "paged":
        print(f"prefix cache: {stats['prefix_hit_tokens']} hit tokens / "
              f"{stats['prompt_tokens_prefilled']} prefilled, "
              f"{stats['cow_copies']} COW copies; preemption: "
              f"{stats['preemptions']} swaps, "
              f"{stats['swap_out_bytes'] + stats['swap_in_bytes']} bytes "
              f"moved in {stats['swap_s'] * 1e3:.0f} ms")
        if "spec_waves" in stats:
            print(f"speculative: {stats['spec_waves']} waves, "
                  f"{stats['spec_drafted']} drafted / "
                  f"{stats['spec_accepted']} accepted / "
                  f"{stats['spec_rolled_back']} rolled back "
                  f"(accept rate {stats['spec_accept_rate']:.2f}, "
                  f"k={stats['spec_k']}, "
                  f"draft {stats['spec_draft_layers']} layers)")
    print("kernel launches: " + json.dumps(stats["kernel_launches"]))
    if eng.tp > 1:
        stats["collectives"] = eng._comm.counts()
        print(f"tensor parallel: tp={eng.tp} ({mesh.backend}), "
              f"collectives {json.dumps(stats['collectives'])}, per-rank "
              f"pool {stats['per_device_pool_bytes']} B, weights "
              f"{stats['per_device_weight_bytes']} B, expert banks "
              f"{stats['per_device_bank_bytes']} B")
    if quiet:
        return stats
    write_obs(args, eng, stats)
    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump({"args": vars(args), "stats": stats}, f, indent=2)
        print(f"wrote {args.bench_out}")
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
