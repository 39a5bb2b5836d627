"""Batched quantized serving entry point of the port (closed-loop batch mode).

Initializes a model from a seed on the target device, deploys it at the
given precision and weight layout, submits every synthetic request up
front, drains the engine and reports throughput, TTFT and the kernels'
launch counts::

    python -m repro_torch.launch.serve --full --weights w4a8
    python -m repro_torch.launch.serve --full --weights w4a8 --kv-layout paged

The paged layout serves with speculative decoding unless ``--no-spec``
is given (a draft of half the target's layers proposes ``--spec-k`` = 4
tokens per slot and wave), as the reference's CLI does. Runs on ``cuda``
by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels on a reduced model (``--full`` off).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels.kvq_attn import ops as kvq_ops
from repro_torch.kernels.w4a8.ops import w4a8_matmul
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import PREEMPT_POLICIES
from repro_torch.serve.spec import SpecConfig


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
    ap.add_argument("--decode-block", type=int, default=8,
                    help="decode steps per chunk between host syncs")
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
    ap.add_argument("--weights", default="bf16", choices=("bf16", "w4a8"),
                    help="serve weight layout: bf16 fake-quant matmuls, or "
                         "w4a8 packed-int4 weights x dynamic-int8 "
                         "activations through the w4a8 kernel")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_reduced_config(args.arch)
    params = init_params(cfg, seed=0, device=args.device)
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
    eng = ServeEngine(cfg, params, policy=args.policy, slots=args.slots,
                      cache_len=args.cache_len,
                      max_new_cap=max(args.max_new, 1),
                      decode_block=args.decode_block,
                      weights_layout=args.weights, device=args.device, **kw)
    del params
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"policy={args.policy} weights={args.weights} "
          f"device={eng.device} slots={args.slots} "
          f"cache_len={args.cache_len} kv_layout={args.kv_layout}")
    reqs = build_requests(args, cfg)
    counted = {"w4a8_matmul": w4a8_matmul,
               "kvq_decode_attn": kvq_ops.kvq_decode_attn,
               "kvq_paged_decode_attn": kvq_ops.kvq_paged_decode_attn,
               "kvq_spec_verify_attn": kvq_ops.kvq_spec_verify_attn,
               "gather_dequant_paged_kv": kvq_ops.gather_dequant_paged_kv,
               "pool_block_copy": kvq_ops.copy_pool_blocks_multi}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    wall = time.perf_counter() - t0
    stats["wall_s"] = wall
    stats["tokens_per_s"] = stats["tokens_out"] / wall
    stats["decode_tokens_per_s"] = ((stats["tokens_out"] - len(reqs))
                                    / max(stats["decode_s"], 1e-12))
    stats["kernel_launches"] = {name: fn.launches
                                for name, fn in counted.items()}
    print(f"served {len(reqs)} requests, {stats['tokens_out']} tokens in "
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
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
