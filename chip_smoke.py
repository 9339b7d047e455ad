#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases (each prints one line of facts; any failure exits non-zero):

1. environment — card name and power limit (``nvidia-smi``), compute
   capability (must be 9.0), TF32 turned off for float32 parity;
2. build — every CUDA kernel of the port from ``mxnet_tpu_torch/csrc``;
3. kernels — each kernel against its plain PyTorch version on the card,
   in float32 and bfloat16: paged decode (K3) at the serving path's
   shapes; flash attention forward (K1) and its split backward (K2: the dq
   kernel and the dk/dv kernel) at BERT-base's training shape,
   ``bench_flash_attention``'s causal shape, llama3-8B's head layout with
   a sliding window, a ragged and a causal cross shape; then each timed
   with CUDA events beside its bound, its plain version's time and one
   PyTorch library call computing the same function;
4. serving parity — a StarCoderBase-1B-width decoder (random weights from
   a seed): prefill + 32 paged decode steps, each step's logits against
   the dense forward's logits at that position; then one full-width
   decode step, timed and profiled (device time by kernel, idle share);
5. serving — ``GenerationEngine`` answers 20 ragged requests at full
   width; the paged-decode launch count must equal layers x decode steps;
6. train parity — BERT-base at full width (bench_bert's shapes: batch 64,
   sequence 128, vocab 30522), one forward + backward through the Gluon
   loop with the kernels, and again with attention swapped (here only)
   for the plain versions: the loss and every gradient must agree;
7. train — the Gluon loop as ``bench_bert`` runs it (Normal(0.02) init,
   Adam lr 1e-4 wd 0.01): one warm-up step, 10 timed steps, one profiled
   step; the loss must be finite and fall, and K1/K2 must have launched
   once per layer per forward/backward.

Then one JSON line listing every ported kernel, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# bigcode/starcoderbase-1b config.json (GPTBigCode): vocab_size 49152,
# n_layer 24, n_embd 2048, n_head 16, multi_query (1 kv head),
# n_inner 8192, n_positions 8192
STARCODERBASE_1B = dict(vocab_size=49152, num_layers=24, d_model=2048,
                        num_heads=16, kv_heads=1, d_ff=8192, max_seq=8192)
SEED = 0
BLOCK = 16
# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs plain: fp32 differs by summation order only (outputs are
# convex mixes of V rows, |out| < ~5, so ~1e-6); bf16 rounds the output
# once on both sides, so they may differ by one bf16 step (2^-8 relative)
KERNEL_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
# flash attention kernels vs plain, relative to the largest |value|: fp32
# differs by summation order only (~3e-6 at T = 2048 measured); bf16 O and
# gradients are rounded once on both sides, so they may differ by one bf16
# step (2^-7 of the largest value); the LSE is fp32 on both sides
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# bench_bert on an accelerator: bert_base(dropout=0, no pooler/classifier)
BERT_BATCH, BERT_SEQ, BERT_VOCAB, BERT_LAYERS = 64, 128, 30522, 12
# kernels vs plain attention over a full BERT-base forward + backward in
# fp32, each parameter's gradient relative to the largest |grad| of its
# layer's group (see train_parity_phase)
TRAIN_GRAD_RTOL = 1e-4
# decode vs dense logits, relative to max |logit|: float32 reorderings
# over 24 layers stay near 1e-6; the same check in bfloat16 is off by
# ~1e-2 (printed below), so 1e-4 tells the two apart
LOGIT_RTOL = 1e-4


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def say(phase, **facts):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in facts.items()),
          flush=True)


def cuda_ms(fn, iters):
    """Mean device milliseconds of ``fn()`` over ``iters`` runs, by CUDA
    events around the whole run (after one warm-up run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: paged decode kernel against its plain version
# ---------------------------------------------------------------------------

def paged_inputs(gen, dev, *, batch, heads, kv_heads, lens, dtype,
                 layers=1, num_blocks=1024, max_blocks=512, head_dim=128):
    """q, per-layer pools, shuffled tables (each sequence's used blocks
    are distinct pool blocks in random order; unused entries are the
    null block) and context lengths, on ``dev``."""
    lens = np.asarray(lens, np.int32)
    used = -(-lens // BLOCK)
    ids = np.random.RandomState(SEED).permutation(np.arange(1, num_blocks))
    check(used.sum() <= ids.size, "pool too small for the contexts")
    tables = np.zeros((batch, max_blocks), np.int32)
    at = 0
    for b, n in enumerate(used):
        tables[b, :n] = ids[at:at + n]
        at += n

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    shape = (layers, num_blocks, BLOCK, kv_heads, head_dim)
    return (randn(batch, heads, head_dim), randn(*shape), randn(*shape),
            torch.from_numpy(tables).to(dev), torch.from_numpy(lens).to(dev))


def paged_work(q, k_pool, tables, lens):
    """Bytes the function must move (K/V rows in context, q, out, the
    table entries used, lens) and its operations, for these inputs."""
    b, h, d = q.shape
    kvh, item = k_pool.shape[-2], q.element_size()
    ctx = torch.clamp(lens.long(), 0, tables.shape[1] * BLOCK)
    n_ctx = int(ctx.sum())
    n_blocks = int((-(-ctx // BLOCK)).sum())
    nbytes = (2 * n_ctx * kvh * d * item + 2 * b * h * d * item
              + 4 * n_blocks + 4 * b)
    return nbytes, 4 * h * d * n_ctx


def kernel_phase(dev, gen):
    from mxnet_tpu_torch.ops.flash_attention import (
        _torch_paged_decode,
        paged_decode_attention,
    )

    rs = np.random.RandomState(SEED)
    slice_lens = rs.randint(1, 1100, 8)
    slice_lens[0] = 0  # an empty slot answers zeros
    cases = {
        "slice": dict(batch=8, heads=16, kv_heads=1, lens=slice_lens),
        "gqa": dict(batch=8, heads=32, kv_heads=8,
                    lens=rs.randint(1, 1100, 8)),
        "one_block": dict(batch=8, heads=16, kv_heads=1,
                          lens=np.full(8, BLOCK)),
    }
    errs = {}
    for name, kw in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tables, lens = paged_inputs(gen, dev, dtype=dtype,
                                                   **kw)
            scale = 1.0 / q.shape[-1] ** 0.5
            got = paged_decode_attention(q, kp[0], vp[0], tables, lens)
            torch.cuda.synchronize()
            want = _torch_paged_decode(q, kp[0], vp[0], tables, lens, scale)
            diff = (got.float() - want.float()).abs()
            atol, rtol = KERNEL_TOL[dtype]
            ok = bool((diff <= atol + rtol * want.float().abs()).all())
            err = float(diff.max())
            errs[(name, dtype)] = err
            say("kernel", case=name, dtype=str(dtype).split(".")[1],
                max_abs_err=f"{err:.3e}", atol=atol, rtol=rtol, ok=ok)
            check(ok, f"paged_decode {name} {dtype} disagrees with plain")
            check(bool((got[lens == 0] == 0).all()), "ctx 0 must give zeros")

    # timing at the serving shape, float32 (the engine's pool type), one
    # pool per layer of the model so every call finds L2 cold as it does
    # in a decode step (24 x 2 x 50 MB of pool > the 50 MB L2)
    layers = STARCODERBASE_1B["num_layers"]
    q, kp, vp, tables, lens = paged_inputs(
        gen, dev, dtype=torch.float32, layers=layers, **cases["slice"])
    scale = 1.0 / q.shape[-1] ** 0.5
    state = {"li": 0}

    def kernel():
        li = state["li"] = (state["li"] + 1) % layers
        paged_decode_attention(q, kp[li], vp[li], tables, lens, scale)

    def plain():
        li = state["li"] = (state["li"] + 1) % layers
        _torch_paged_decode(q, kp[li], vp[li], tables, lens, scale)

    kernel_ms = cuda_ms(kernel, 10 * layers)
    plain_ms = cuda_ms(plain, 2 * layers)
    nbytes, ops = paged_work(q, kp, tables, lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[torch.float32] * 1e3
    row = {
        "name": "paged_decode",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/paged_decode.cu",
        "replaces": "mxnet_tpu/ops/flash_attention.py:693",
        "launches": None,  # filled from the serving phase
        "max_abs_err": errs[("slice", torch.float32)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes paged decode
    }
    say("kernel-time", shape="B8_H16_KVH1_D128_bs16_fp32",
        ctx_total=int(lens.sum()), bytes=nbytes, ms=f"{kernel_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{row['bound_ms']:.5f}",
        bound_by=row["bound_by"],
        bound_share=f"{row['bound_ms'] / kernel_ms:.4f}")
    return row, (kp, vp, tables, lens)


# ---------------------------------------------------------------------------
# phase 3b: flash attention kernels (K1, K2) against their plain versions
# ---------------------------------------------------------------------------

# name: (B, H, KVH, T, S, D, causal, window, native_gqa)
FLASH_CASES = {
    "bert_base": (BERT_BATCH, 12, 12, BERT_SEQ, BERT_SEQ, 64, False, 0,
                  False),
    "bench_causal": (2, 8, 8, 4096, 4096, 64, True, 0, False),
    "llama3_8b_window": (1, 32, 8, 2048, 2048, 128, True, 1024, False),
    "llama3_8b_window_native": (1, 32, 8, 2048, 2048, 128, True, 1024,
                                True),
    "ragged": (2, 4, 4, 1000, 1000, 64, False, 0, False),
    "causal_cross": (4, 4, 4, 128, 512, 64, True, 0, False),
}


def visible_pairs(T, S, causal, window):
    """(query row, key) pairs the mask lets through, per (batch, head)."""
    if not causal:
        return T * S
    q = np.arange(T) + (S - T)
    hi = np.clip(q + 1, 0, S)
    lo = np.clip(q - window + 1, 0, S) if window > 0 else 0
    return int(np.clip(hi - lo, 0, None).sum())


def flash_work(B, H, KVH, T, S, D, causal, window, item):
    """Operations and bytes (each input read once, each output written
    once) of K1, K2's dq kernel and K2's dk/dv kernel."""
    pairs = B * H * visible_pairs(T, S, causal, window)
    q_b, kv_b, rows_b = B * H * T * D * item, B * KVH * S * D * item, \
        B * H * T * 4
    return {
        "flash_fwd": (4 * pairs * D, 2 * q_b + 2 * kv_b + rows_b),
        "flash_bwd_dq": (6 * pairs * D, 3 * q_b + 2 * kv_b + 2 * rows_b),
        "flash_bwd_dkv": (8 * pairs * D, 2 * q_b + 4 * kv_b + 2 * rows_b),
    }


def flash_inputs(gen, dev, B, H, KVH, T, S, D, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return (randn(B, H, T, D), randn(B, KVH, S, D), randn(B, KVH, S, D),
            randn(B, H, T, D))


def flash_kernel_phase(dev, gen):
    """Every case in fp32 and bf16: O and the gradients through the
    public autograd op (K1 forward, K2 backward), the LSE from K1 itself,
    all against the plain versions on the same tensors. Then, at the
    training shape in fp32, each kernel timed beside its bound, its plain
    version and scaled_dot_product_attention (never used by the port)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from mxnet_tpu_torch.ops.flash_attention import (
        _cuda_flash_bwd,
        _cuda_flash_fwd,
        _torch_flash_bwd,
        _torch_flash_fwd,
        flash_attention,
    )

    errs = {}
    for name, (B, H, KVH, T, S, D, causal, window, native) in \
            FLASH_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = flash_inputs(gen, dev, B, H, KVH, T, S, D, dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_attention(*leaves, causal=causal, window=window,
                                  native_gqa=native)
            out.backward(g)
            _, lse = _cuda_flash_fwd(q, k, v, D ** -0.5, causal, window)
            torch.cuda.synchronize()
            want_o, want_lse = _torch_flash_fwd(q, k, v, D ** -0.5, causal,
                                                window)
            want = _torch_flash_bwd(q, k, v, want_o, want_lse, g, D ** -0.5,
                                    causal, window)
            tol = FLASH_TOL[dtype]
            facts = {}
            for what, got, ref, lim in (
                    ("out", out, want_o, tol),
                    ("lse", lse, want_lse, FLASH_TOL[torch.float32]),
                    ("dq", leaves[0].grad, want[0], tol),
                    ("dk", leaves[1].grad, want[1], tol),
                    ("dv", leaves[2].grad, want[2], tol)):
                diff = float((got.detach().float() - ref.float()).abs().max())
                rel = diff / max(float(ref.float().abs().max()), 1e-30)
                check(got.dtype == ref.dtype and got.shape == ref.shape,
                      f"flash {name} {what}: {got.dtype} {tuple(got.shape)}")
                check(rel <= lim, f"flash {name} {dtype} {what} disagrees "
                      f"with plain: {rel:.3e} > {lim}")
                facts[what] = f"{rel:.2e}"
                errs[(name, dtype, what)] = diff
            say("kernel", case=f"flash_{name}",
                dtype=str(dtype).split(".")[1], shape=f"B{B}_H{H}_KVH{KVH}"
                f"_T{T}_S{S}_D{D}", causal=causal, window=window,
                native_gqa=native, rel_err=",".join(
                    f"{k}:{v}" for k, v in facts.items()),
                tol_rel=tol, ok=True)
            del q, k, v, g, leaves, out, want

    # timing at BERT-base's training shape, fp32 (the training type)
    B, H, KVH, T, S, D, causal, window, _ = FLASH_CASES["bert_base"]
    q, k, v, g = flash_inputs(gen, dev, B, H, KVH, T, S, D, torch.float32)
    scale = D ** -0.5
    out, lse = _cuda_flash_fwd(q, k, v, scale, causal, window)
    plain_o, plain_lse = _torch_flash_fwd(q, k, v, scale, causal, window)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def lib_fwd_bwd():
        o = sdpa(qs, ks, vs)
        torch.autograd.grad(o, (qs, ks, vs), g)

    from mxnet_tpu_torch.ops import flash_attention as fa

    bwd_args = fa._bwd_operands(q, k, v, out, lse, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)

    def dq_only():
        fa._launch_flash_bwd("dq", *bwd_args, (dq,), scale, causal, window)

    def dkv_only():
        fa._launch_flash_bwd("dkv", *bwd_args, (dk, dv), scale, causal,
                             window)

    times = {
        "flash_fwd": (cuda_ms(lambda: _cuda_flash_fwd(
            q, k, v, scale, causal, window), 50),
            cuda_ms(lambda: _torch_flash_fwd(q, k, v, scale, causal,
                                             window), 20),
            cuda_ms(lambda: sdpa(q, k, v), 50)),
    }
    plain_bwd = cuda_ms(lambda: _torch_flash_bwd(
        q, k, v, plain_o, plain_lse, g, scale, causal, window), 20)
    lib_bwd = cuda_ms(lib_fwd_bwd, 20)
    times["flash_bwd_dq"] = (cuda_ms(dq_only, 50), plain_bwd, lib_bwd)
    times["flash_bwd_dkv"] = (cuda_ms(dkv_only, 50), plain_bwd, lib_bwd)
    both = cuda_ms(lambda: _cuda_flash_bwd(q, k, v, out, lse, g, scale,
                                           causal, window), 50)
    work = flash_work(B, H, KVH, T, S, D, causal, window, 4)
    replaces = {"flash_fwd": "mxnet_tpu/ops/flash_attention.py:93",
                "flash_bwd_dq": "mxnet_tpu/ops/flash_attention.py:457",
                "flash_bwd_dkv": "mxnet_tpu/ops/flash_attention.py:505"}
    err_of = {"flash_fwd": ("out",), "flash_bwd_dq": ("dq",),
              "flash_bwd_dkv": ("dk", "dv")}
    rows = []
    for name, (ms, plain_ms, lib_ms) in times.items():
        ops, nbytes = work[name]
        t_ops = ops / PEAK_OPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row = {
            "name": name,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + (
                "flash_fwd.cu" if name == "flash_fwd" else "flash_bwd.cu"),
            "replaces": replaces[name],
            "launches": None,  # filled from the training phase
            "max_abs_err": max(errs[("bert_base", torch.float32, w)]
                               for w in err_of[name]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        }
        rows.append(row)
        say("kernel-time", kernel=name, shape=f"B{B}_H{H}_T{T}_D{D}_fp32",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{row['bound_ms']:.5f}",
            bound_by=row["bound_by"], tflops=f"{ops / ms / 1e9:.2f}",
            bound_share=f"{row['bound_ms'] / ms:.4f}")
    say("kernel-time", kernel="flash_bwd_dq+dkv", ms=f"{both:.4f}",
        note='"plain_ms/library_ms of each K2 row are the whole backward"')
    return rows


# ---------------------------------------------------------------------------
# phase 4: decode logits against dense logits at full width
# ---------------------------------------------------------------------------

def step_phase(net, pools, kernel_ms):
    """Where a full-width decode step's time goes at the kernel timing's
    shape (8 slots, ragged contexts up to ~1100, 24 cold layer pools):
    device time per step by CUDA events, and one profiled window that
    splits the device's busy time by kernel and gives its idle share."""
    from torch.profiler import ProfilerActivity, profile

    kp, vp, tables, lens = pools
    params, step = net.params(), net.decode_step_fn()
    active = lens > 0
    pos = torch.clamp(lens.long() - 1, min=0)  # context = lens
    token = (pos * 7919) % net.vocab_size

    def run():
        step(params, token, pos, kp, vp, tables, active)

    dev_ms = cuda_ms(run, 10)
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    n_params = sum(a.numel() for a in [params[k] for k in (
        "embed", "pos", "lnf_g", "lnf_b", "head")]
        + [a for lyr in params["layers"] for a in lyr.values()])
    say("decode-step", step_dev_ms=f"{dev_ms:.4f}",
        paged_decode_ms=f"{net.num_layers * kernel_ms:.4f}",
        paged_decode_share=f"{net.num_layers * kernel_ms / dev_ms:.4f}",
        weights_bound_ms=f"{4 * n_params / HBM_BYTES_PER_S * 1e3:.4f}",
        profiled_busy_ms=f"{busy / reps / 1e3:.4f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}")
    for name, us in top:
        say("decode-step-kernel", ms_per_step=f"{us / reps / 1e3:.4f}",
            share=f"{us / busy:.4f}", name=f'"{name[:90]}"')


def parity_phase(net, dev, launches):
    from mxnet_tpu_torch.serving import PagedKVCache

    steps, bucket = 32, 256
    rs = np.random.RandomState(SEED + 1)
    plens = [37, 100, 161, 211]
    prompts = [rs.randint(0, net.vocab_size, n) for n in plens]
    n = len(prompts) + 1  # the last slot stays inactive throughout
    cache = PagedKVCache(net.num_layers, net.kv_heads, net.head_dim,
                         max_seq=net.max_seq, num_blocks=128,
                         block_size=BLOCK, device=dev)
    tabs = [cache.allocate(p + steps) for p in plens]
    tables = np.zeros((n, cache.max_blocks_per_seq), np.int32)
    for i, t in enumerate(tabs):
        tables[i] = t.device_row(cache.max_blocks_per_seq)
    tables = torch.from_numpy(tables).to(dev)
    params = net.params()
    k, v = cache.pools()
    prefill, step = net.prefill_fn(), net.decode_step_fn()
    first = []
    for i, p in enumerate(prompts):
        padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        padded[0, :len(p)] = torch.from_numpy(p)
        logits, k, v = prefill(params, padded, k, v, tables[i:i + 1],
                               torch.tensor([len(p)], device=dev))
        first.append(logits[0])
    token = torch.stack([f.argmax() for f in first] + [first[0].argmax()])
    pos = torch.tensor(plens + [0], device=dev)
    active = torch.tensor([True] * len(prompts) + [False], device=dev)
    fed, dec = [], []
    launches.clear()
    for _ in range(steps):
        logits, k, v = step(params, token, pos, k, v, tables, active)
        fed.append(token)
        dec.append(logits)
        token = logits.argmax(-1)
        pos = pos + active.long()
    check(launches["paged_decode"] == steps * net.num_layers,
          f"parity decode launched paged_decode {launches['paged_decode']} "
          f"times, expected {steps * net.num_layers}")

    seqs = torch.zeros((len(prompts), max(plens) + steps), dtype=torch.long,
                       device=dev)
    for i, p in enumerate(prompts):
        seqs[i, :len(p)] = torch.from_numpy(p)
        seqs[i, len(p):len(p) + steps] = torch.stack([f[i] for f in fed])
    dense = net.forward_fn()(params, seqs)  # causal: right padding is inert
    worst, scale_ = 0.0, float(dense.abs().max())
    for i, p in enumerate(plens):
        want = dense[i, p - 1:p + steps]  # prefill position, then each step
        got = torch.stack([first[i]] + [d[i] for d in dec])
        worst = max(worst, float((got - want).abs().max()))
    rel = worst / scale_

    # the same check with the weights rounded to bfloat16 must fail
    bf16 = {key: ([{n_: a.bfloat16() for n_, a in lyr.items()} for lyr in val]
                  if key == "layers" else val.bfloat16())
            for key, val in params.items()}
    dense_bf16 = net.forward_fn()(bf16, seqs).float()
    bf16_rel = max(float((dense_bf16[i, p - 1:p + steps]
                          - dense[i, p - 1:p + steps]).abs().max())
                   for i, p in enumerate(plens)) / scale_
    del bf16, dense_bf16
    say("parity", seqs=len(prompts), prompt_lens=plens, steps=steps,
        max_abs_logit=f"{scale_:.4f}", max_abs_diff=f"{worst:.3e}",
        rel=f"{rel:.3e}", tol_rel=LOGIT_RTOL, bf16_rel=f"{bf16_rel:.3e}",
        batch=n)
    check(rel <= LOGIT_RTOL, "decode logits disagree with dense logits")
    check(bf16_rel > LOGIT_RTOL, "tolerance too loose to tell bf16 apart")
    for t in tabs:
        cache.release(t)


# ---------------------------------------------------------------------------
# phase 5: serving at full width
# ---------------------------------------------------------------------------

def serving_phase(net, dev, launches, device_line):
    from mxnet_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(net, shapes=[256, 1024], slots=8, chunk=8,
                           cache_blocks=1024, name="starcoderbase-1b")
    try:
        rs = np.random.RandomState(SEED + 2)
        plens = np.linspace(17, 1000, 16).astype(int)
        rs.shuffle(plens)
        reqs = [(rs.randint(0, net.vocab_size, p), dict(greedy=True))
                for p in plens]
        reqs += [(rs.randint(0, net.vocab_size, p), kw) for p, kw in (
            (60, dict(greedy=False, temperature=0.8, top_k=50, seed=1)),
            (300, dict(greedy=False, temperature=1.0, top_p=0.9, seed=2)),
            (512, dict(greedy=False, temperature=0.7, top_k=40, top_p=0.95,
                       seed=3)),
            (900, dict(greedy=False, temperature=1.2, top_k=200, seed=4)))]
        st0 = eng.stats()
        launches.clear()
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=64, **kw) for p, kw in reqs]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        st1 = eng.stats()
        main_launches = launches["paged_decode"]
    finally:
        eng.close()
    chunks = st1["decode_chunks"] - st0["decode_chunks"]
    steps = chunks * st1["chunk"]
    check(st1["requests_ok"] - st0["requests_ok"] == len(reqs),
          "not every request completed")
    for out in outs:
        check(len(out) == 64 and out.min() >= 0
              and out.max() < net.vocab_size, "bad tokens served")
    check(st1["cache"]["blocks_used"] == 0, "cache not freed")
    check(main_launches == net.num_layers * steps,
          f"paged_decode launched {main_launches} times for {steps} decode "
          f"steps x {net.num_layers} layers")
    # greedy answers: each served token's dense logit is the dense max up
    # to the float32 noise LOGIT_RTOL allows (exact ties may flip)
    fwd = net.forward_fn()
    with torch.inference_mode():
        for (p, _), out in list(zip(reqs, outs))[:4]:
            seq = torch.from_numpy(np.concatenate([p, out])).to(dev)[None]
            logits = fwd(net.params(), seq)[0, len(p) - 1:-1]
            picked = logits.gather(1, seq[0, len(p):, None])[:, 0]
            gap = float((logits.amax(-1) - picked).max())
            check(gap <= LOGIT_RTOL * float(logits.abs().max()),
                  f"served greedy token is not the dense argmax (gap {gap})")
    tokens = st1["tokens_generated"] - st0["tokens_generated"]
    say("serving", device=f'"{device_line}"', requests=len(reqs),
        tokens=tokens, wall_s=f"{wall:.3f}",
        e2e_tokens_per_s=f"{tokens / wall:.2f}",
        decode_tokens_per_s=f"{st1['tokens_per_s']:.2f}",
        itl_p50_ms=f"{st1['itl_p50_ms']:.3f}",
        itl_p99_ms=f"{st1['itl_p99_ms']:.3f}",
        prefills=st1["prefills"] - st0["prefills"], decode_chunks=chunks,
        decode_steps=steps, paged_decode_launches=main_launches)
    return main_launches


# ---------------------------------------------------------------------------
# phases 6 and 7: BERT-base training through the Gluon loop
# ---------------------------------------------------------------------------

def bert_setup(ctx, **cut):
    """BERT-base as bench_bert builds it on an accelerator (``cut``
    overrides widths for a rehearsal on the host), Normal(0.02) weights
    from seed SEED, and its fixed batch (ids and labels from numpy seed
    SEED), with deferred shapes resolved by one forward."""
    import mxnet_tpu_torch as mx

    # the position table's own init="normal" draws from the default
    # generator; the rest from the seeded Normal(0.02)
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    net = mx.models.bert_base(dropout=0.0, use_pooler=False,
                              use_classifier=False, **cut)
    net.initialize(init=mx.initializer.Normal(0.02, seed=SEED), ctx=ctx)
    vocab = cut.get("vocab_size", BERT_VOCAB)
    rs = np.random.RandomState(SEED)
    x = mx.nd.array(rs.randint(0, vocab, (BERT_BATCH, BERT_SEQ)),
                    dtype="int32", ctx=ctx)
    y = mx.nd.array(rs.randint(0, vocab, (BERT_BATCH, BERT_SEQ))
                    .astype(np.float32), ctx=ctx)
    net(x)
    mx.nd.waitall()
    n_params = sum(p.data().size for p in net.collect_params().values())
    say("bert-model", config="BERT-base (bert_12_768_12, vocab 30522)",
        params=n_params, batch=BERT_BATCH, seq=BERT_SEQ, dtype="float32",
        init_s=f"{time.perf_counter() - t0:.2f}", ctx=ctx)
    return net, x, y


def _fwd_bwd(mx, net, x, y):
    """One recorded forward and backward; the mean loss stays on the
    device (no host sync)."""
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = sce(net(x)[-1], y)
    loss.backward()
    return loss.data.detach().mean()


def train_parity_phase(net, x, y):
    """One forward + backward with the kernels, then the same with
    ``F.flash_attention`` swapped, in this script only, for an autograd
    function over the plain versions. Loss within 1e-5 relative; each
    gradient within TRAIN_GRAD_RTOL of the largest |grad| of its block
    (the weight and bias of one layer): an attention key bias has a zero
    gradient in exact arithmetic (softmax ignores a shift shared by all
    keys), so on both sides it is float noise, judged against its block's
    weight gradient and not against itself."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import apply
    from mxnet_tpu_torch.ops.flash_attention import (
        _torch_flash_bwd,
        _torch_flash_fwd,
    )

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = _torch_flash_fwd(q, k, v, q.shape[-1] ** -0.5,
                                        causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            return (*_torch_flash_bwd(q, k, v, out, lse, g,
                                      q.shape[-1] ** -0.5, ctx.causal),
                    None)

    params = net.collect_params()
    loss_k = float(_fwd_bwd(mx, net, x, y))
    grads_k = {k: p.grad().data.clone() for k, p in params.items()}
    kernel_op = mx.nd.flash_attention
    mx.nd.flash_attention = lambda q, k, v, causal=False, **kw: apply(
        PlainFlash.apply, q, k, v, causal)
    try:
        loss_p = float(_fwd_bwd(mx, net, x, y))
    finally:
        mx.nd.flash_attention = kernel_op
    torch.cuda.synchronize()
    blocks = {}
    for name, p in params.items():
        block = name.rsplit("_", 1)[0]
        blocks[block] = max(blocks.get(block, 0.0),
                            float(p.grad().data.abs().max()))
    worst, worst_name = 0.0, ""
    for name, p in params.items():
        diff = float((grads_k[name] - p.grad().data).abs().max())
        rel = diff / max(blocks[name.rsplit("_", 1)[0]], 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    say("train-parity", loss_kernels=f"{loss_k:.6f}",
        loss_plain=f"{loss_p:.6f}", loss_rel=f"{loss_rel:.3e}",
        worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
        tol_rel=TRAIN_GRAD_RTOL, params=len(params))
    check(np.isfinite(loss_k) and loss_rel <= 1e-5,
          "kernel loss disagrees with plain attention")
    check(worst <= TRAIN_GRAD_RTOL,
          f"{worst_name} gradient disagrees with plain attention: {worst}")
    del grads_k


# device time of a train step by kind of kernel (first match wins)
STEP_GROUPS = (("flash_attention", ("mxtpu_flash",)),
               ("matmul", ("gemm", "gemv")),
               ("layer_norm", ("layer_norm",)),
               ("reduce_softmax", ("reduce", "softmax", "logsumexp")),
               ("embedding_index", ("index", "embedding", "gather",
                                    "scatter")),
               ("elementwise", ("elementwise", "unrolled")))


def train_phase(net, x, y, launches, steps=10):
    """The Gluon loop of bench_bert: one warm-up step, ``steps`` timed
    steps (host clock around synchronised work), one profiled step. The
    launch counts are read over exactly these steps."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile

    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4, "wd": 0.01})

    def step():
        loss = _fwd_bwd(mx, net, x, y)
        trainer.step(BERT_BATCH)
        return loss

    launches.clear()
    torch.cuda.reset_peak_memory_stats()
    losses = [step()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    counts = dict(launches)
    n_steps = steps + 2
    losses = [float(v) for v in losses]
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    flash = sum(us for n, us in by_name.items() if "flash" in n)
    say("train", device_steps=n_steps, step_ms=f"{step_s * 1e3:.3f}",
        samples_per_s=f"{BERT_BATCH / step_s:.2f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        profiled_busy_ms=f"{busy / 1e3:.3f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}",
        flash_share=f"{flash / busy:.4f}",
        flash_fwd=counts.get("flash_fwd", 0),
        flash_bwd_dq=counts.get("flash_bwd_dq", 0),
        flash_bwd_dkv=counts.get("flash_bwd_dkv", 0))
    groups = {}
    for name, us in by_name.items():
        group = next((g for g, keys in STEP_GROUPS if any(
            k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us
    say("train-step-split", **{g: f"{us / 1e3:.3f}ms/{us / busy:.4f}"
                               for g, us in sorted(groups.items(),
                                                   key=lambda kv: -kv[1])})
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("train-step-kernel", ms_per_step=f"{us / 1e3:.4f}",
            share=f"{us / busy:.4f}", name=f'"{name[:90]}"')
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts.get(name, 0) == BERT_LAYERS * n_steps,
              f"{name} launched {counts.get(name, 0)} times in {n_steps} "
              f"train steps of {BERT_LAYERS} layers")
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: no CUDA device visible")
    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.serving import TransformerDecoderLM

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("env", nvidia_smi=f'"{smi}"', device=f'"{name}"', capability=cap,
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    check(cap == (9, 0), f"needs a Hopper card (9, 0), found {cap}")

    t0 = time.perf_counter()
    libs = _kernels.build_all()
    say("build", kernels=sorted(libs),
        seconds=f"{time.perf_counter() - t0:.2f}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    row, pools = kernel_phase(dev, gen)
    flash_rows = flash_kernel_phase(dev, gen)

    t0 = time.perf_counter()
    with torch.inference_mode():
        net = TransformerDecoderLM(**STARCODERBASE_1B, seed=SEED, device=dev)
        torch.cuda.synchronize()
        say("model", config="StarCoderBase-1B widths", dtype=net.dtype,
            init_s=f"{time.perf_counter() - t0:.2f}")
        parity_phase(net, dev, _kernels.LAUNCHES)
        step_phase(net, pools, row["ms"])
    del pools
    row["launches"] = serving_phase(net, dev, _kernels.LAUNCHES, smi)
    del net
    torch.cuda.empty_cache()

    import mxnet_tpu_torch as mx

    bert, x, y = bert_setup(mx.gpu(0))
    train_parity_phase(bert, x, y)
    counts = train_phase(bert, x, y, _kernels.LAUNCHES)
    for r in flash_rows:
        r["launches"] = counts[r["name"]]
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [row] + flash_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
