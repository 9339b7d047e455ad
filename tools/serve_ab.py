#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s 20 StarCoderBase-1B requests (64 new tokens
each, 8 slots, chunks of 8 steps) with the ``GenerationEngine`` of the
tree at ``--root`` (this checkout by default), on one CUDA card.

    python tools/serve_ab.py [--root DIR] [--runs 2]

Each run is the tree's own ``serving_phase``, which prints its
``[serving]`` line (inter-token latency p50/p99, end-to-end and decode
tokens/s, launches); the last run is also profiled, for the device's busy
time and idle share over the whole serving window (``[serve-ab]``), and
every run's time to first token is read from its requests (p50/p99, all
20 submitted at once). Then one request at a time (prompts of 200 and
1000 tokens, one new token, 5 each) gives the time to first token of a
prefill alone (``[serve-ab-ttft]``). To compare two trees, unpack one
beside the other and run both on the same card in the order A, B, B, A.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose chip_smoke.py and package to run")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab: no CUDA device visible")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.serving import TransformerDecoderLM

    for mod in (cs, _kernels):
        where = os.path.abspath(mod.__file__)
        if not where.startswith(root + os.sep):
            raise SystemExit(f"serve_ab: {mod.__name__} from {where}, not "
                             f"from {root}")
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        net = TransformerDecoderLM(**cs.STARCODERBASE_1B, seed=cs.SEED,
                                   device=dev)
    from mxnet_tpu_torch.serving import GenerationEngine

    submitted = []
    submit = GenerationEngine.submit

    def recording_submit(self, *a, **kw):
        t = time.perf_counter()
        fut = submit(self, *a, **kw)
        submitted.append((t, fut))
        return fut

    GenerationEngine.submit = recording_submit

    def ttft_ms():
        first = min(t for t, _ in submitted)
        ms = [(f.token_times()[0] - first) * 1e3 for _, f in submitted]
        submitted.clear()
        return (f"{np.percentile(ms, 50):.3f}", f"{np.percentile(ms, 99):.3f}")

    cs.say("serve-ab", root=root, device=f'"{smi}"')
    for _ in range(args.runs - 1):
        cs.serving_phase(net, dev, _kernels.LAUNCHES, smi)
        p50, p99 = ttft_ms()
        cs.say("serve-ab", root=root, ttft_p50_ms=p50, ttft_p99_ms=p99)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.serving_phase(net, dev, _kernels.LAUNCHES, smi)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    p50, p99 = ttft_ms()
    cs.say("serve-ab", root=root, profiled_window_s=f"{window_us / 1e6:.3f}",
           busy_s=f"{busy / 1e6:.3f}",
           idle_share=f"{1 - busy / window_us:.4f}", ttft_p50_ms=p50,
           ttft_p99_ms=p99)
    GenerationEngine.submit = submit
    eng = GenerationEngine(net, shapes=[256, 1024], slots=8, chunk=8,
                           cache_blocks=1024, name="starcoderbase-1b-ttft")
    try:
        rs = np.random.RandomState(cs.SEED + 9)
        for plen in (200, 1000):
            ms = []
            for _ in range(6):
                prompt = rs.randint(0, net.vocab_size, plen)
                t = time.perf_counter()
                f = eng.submit(prompt, max_new_tokens=1)
                f.result(timeout=300)
                ms.append((f.token_times()[0] - t) * 1e3)
            cs.say("serve-ab-ttft", root=root, prompt=plen,
                   ttft_ms=[f"{v:.3f}" for v in ms[1:]],
                   median_ms=f"{np.median(ms[1:]):.3f}")
    finally:
        eng.close()


if __name__ == "__main__":
    main()
