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
   shapes; flash attention forward (K1), its split backward (K2: the dq
   kernel and the dk/dv kernel) and its fused backward (K6) at BERT-base's
   training shape, ``bench_flash_attention``'s causal shape, llama3-8B's
   head layout with a sliding window and at its full causal training
   shape (T = 8192), a ragged and a causal cross shape; then each timed
   with CUDA events beside its bound, its plain version's time and one
   PyTorch library call computing the same function (K6 beside K2 at
   BERT-base's and Llama-3-8B's shapes);
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
   once per layer per forward/backward;
8. resnet parity — ResNet-50 v1 at full width (``bench_resnet``'s
   shapes: batch 128, 224 x 224, 1000 classes, fp32) through
   ``optimize_for("tpu_fused_conv_bn")``: one forward + backward with the
   fused 1x1-conv + BN-statistics kernels (K4 forward, K5 dW and dX),
   every kernel call also held against its plain version on the same
   tensors; the gradients against a run with K5 swapped (here only) for
   its plain version, the loss against a run with K4 and K5 swapped, then
   the un-fused net on the same weights;
9. resnet train — the Gluon loop with ``bench_resnet``'s settings (Xavier
   init, SGD lr 0.05 momentum 0.9 wd 1e-4): one warm-up step, 10 timed
   steps, one profiled step (device time split into cuDNN convs, K4, K5,
   BN and element-wise kernels and the SGD update); the loss must be finite
   and fall, the running statistics move, and K4, K5-dW and K5-dX launch
   30 times per step;
10. llama parity — Llama-3-8B at its published widths cut to 2 decoder
   layers (meta-llama/Meta-Llama-3-8B ``config.json``: vocab 128256,
   hidden 4096, intermediate 14336, 32 heads over 8 kv heads, rope theta
   500000; 1,486,901,248 parameters, fp32), one sequence of 8192 tokens:
   one forward + backward through the Gluon loop with
   ``MXTPU_FLASH_BWD=fused`` (K6) and again with ``split`` (K2) on the
   same weights; the loss must be equal and every gradient agree;
11. llama train — ``parallel.SPMDTrainStep(mesh=None)`` with Adam (lr
   1e-4) under ``MXTPU_FLASH_BWD=fused``: ``run_steps`` for one warm-up
   step, 10 timed steps and one profiled step (device time split into fp32
   products, K1, K6, element-wise kernels and the Adam update); the loss
   must be finite and fall, K6 launch twice per step and K2 never.

Phase 3 also checks K4 and K5's two kernels against their plain versions
(fp32 and bf16, with and without the BatchNorm prologue, at ResNet-50's
stage shapes and two ragged ones) and times them at each of ResNet-50's
nine 1x1 shapes beside their bounds, their plain versions and
``torch.matmul`` of the bare product.

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
# bench_resnet on an accelerator: resnet50_v1 (1000 classes), batch 128 at
# 224 x 224, labels in [0, 10), SGD lr 0.05 momentum 0.9 wd 1e-4
RESNET_BATCH, RESNET_SIZE = 128, 224
RESNET_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
RESNET_FUSED = 30  # stride-1 1x1 convs optimize_for marks in ResNet-50 v1
# those convs as (M = N * H * W, K -> N, calls per step) at batch 128
RESNET_1X1 = ((401408, 64, 64, 1), (401408, 64, 256, 4),
              (401408, 256, 64, 2), (100352, 128, 512, 4),
              (100352, 512, 128, 3), (25088, 256, 1024, 6),
              (25088, 1024, 256, 5), (6272, 512, 2048, 3),
              (6272, 2048, 512, 2))
# K4/K5 vs plain, relative to the largest |value| of each output, as
# (storage-type outputs y/dx/dw, fp32 statistics): fp32 differs by
# summation order only (~1e-6 measured over 401408 rows); in bf16 y, dx and
# dw are rounded once on both sides (one bf16 step, 2^-7 of the largest
# value) while the statistics stay fp32 (order only; 1e-4 leaves room for
# one bf16 operand rounded the other way)
FUSED_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
# ResNet-50 with K4/K5 vs with their plain versions (see
# resnet_parity_phase): loss within 1e-5 relative, each weight's gradient
# within 1e-4 of its own largest |grad|
RESNET_LOSS_RTOL, RESNET_GRAD_RTOL = 1e-5, 1e-4
# the fused net against the un-fused one: another computation (the conv
# bias is applied and cancelled, cuDNN sums in its own order), so 1e-4
# relative for the loss
UNFUSED_LOSS_RTOL = 1e-4
# meta-llama/Meta-Llama-3-8B config.json (the repo's
# _LLAMA_CONFIGS["llama3_8b"]): vocab 128256, hidden 4096, intermediate
# 14336, 32 heads over 8 kv heads, rope theta 500000, context 8192; cut to
# 2 of its 32 decoder layers so that fp32 Adam fits one card, trained on
# one sequence of 8192 tokens (the longest K6's cap admits)
LLAMA_LAYERS, LLAMA_SEQ, LLAMA_PARAMS = 2, 8192, 1486901248
LLAMA_ADAM_LR = 1e-4
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


def sdpa_bwd_ms(qs, ks, vs, g, causal, iters):
    """Mean device milliseconds of SDPA's backward alone: one forward
    outside the timed calls, then ``torch.autograd.grad`` of its output
    over the kept graph."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    o = sdpa(qs, ks, vs, is_causal=causal)
    ms = cuda_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), g,
                                             retain_graph=True), iters)
    del o
    return ms


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
    "llama3_8b_causal": (1, 32, 8, 8192, 8192, 128, True, 0, False),
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
    once) of K1, K2's dq kernel, K2's dk/dv kernel and K6."""
    pairs = B * H * visible_pairs(T, S, causal, window)
    q_b, kv_b, rows_b = B * H * T * D * item, B * KVH * S * D * item, \
        B * H * T * 4
    return {
        "flash_fwd": (4 * pairs * D, 2 * q_b + 2 * kv_b + rows_b),
        "flash_bwd_dq": (6 * pairs * D, 3 * q_b + 2 * kv_b + 2 * rows_b),
        "flash_bwd_dkv": (8 * pairs * D, 2 * q_b + 4 * kv_b + 2 * rows_b),
        # Q, dO, O and dq; K, V, dK and dV; LSE and delta
        "flash_bwd_fused": (10 * pairs * D, 4 * q_b + 4 * kv_b + 2 * rows_b),
    }


def flash_inputs(gen, dev, B, H, KVH, T, S, D, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return (randn(B, H, T, D), randn(B, KVH, S, D), randn(B, KVH, S, D),
            randn(B, H, T, D))


def flash_kernel_phase(dev, gen):
    """Every case in fp32 and bf16: O and the gradients through the
    public autograd op (K1 forward, K2 backward), the LSE from K1 itself,
    and K6's gradients (fed the plain forward's O and LSE), all against
    the plain versions on the same tensors. Then, at the training shape
    in fp32, each kernel timed beside its bound, its plain version and
    scaled_dot_product_attention (never used by the port; the K2 rows
    take its backward alone, timed after one forward). Returns the
    rows of K1 and K2 and the errors of every case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from mxnet_tpu_torch.ops.flash_attention import (
        _cuda_flash_bwd,
        _cuda_flash_bwd_fused,
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
            k6 = _cuda_flash_bwd_fused(q, k, v, want_o, want_lse, g,
                                       D ** -0.5, causal, window)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dtype]
            facts = {}
            for what, got, ref, lim in (
                    ("out", out, want_o, tol),
                    ("lse", lse, want_lse, FLASH_TOL[torch.float32]),
                    ("dq", leaves[0].grad, want[0], tol),
                    ("dk", leaves[1].grad, want[1], tol),
                    ("dv", leaves[2].grad, want[2], tol),
                    ("k6_dq", k6[0], want[0], tol),
                    ("k6_dk", k6[1], want[1], tol),
                    ("k6_dv", k6[2], want[2], tol)):
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
            del q, k, v, g, leaves, out, want, k6, want_o, want_lse, lse
        torch.cuda.empty_cache()

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
    lib_fwd_bwd_ms = cuda_ms(lib_fwd_bwd, 20)
    lib_bwd = sdpa_bwd_ms(qs, ks, vs, g, causal, 20)
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
        sdpa_fwd_bwd_ms=f"{lib_fwd_bwd_ms:.4f}",
        note='"plain_ms/library_ms of each K2 row are the whole backward"')
    return rows, errs


# K6 is timed at these FLASH_CASES shapes (BERT-base's and Llama-3-8B's);
# the kernels line gets the last, where the llama phases run it
K6_TIME_CASES = ("bert_base", "llama3_8b_causal")


def fused_bwd_time_phase(dev, gen, errs):
    """K6 timed with CUDA events beside K2 (its dq and dk/dv kernels
    together) at the same shapes in fp32, with K6's bound, the plain
    backward, SDPA's backward alone (the row's ``library_ms``) and SDPA
    forward + backward (kv heads repeated before the timed calls: SDPA's
    fused kernels take no grouped heads). Each time is
    a whole backward wrapper call: delta, the outputs (K6's zeroed dq
    workspace) and the launch(es). Returns K6's row at the last case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from mxnet_tpu_torch.ops import flash_attention as fa

    row = None
    for case in K6_TIME_CASES:
        B, H, KVH, T, S, D, causal, window, _ = FLASH_CASES[case]
        q, k, v, g = flash_inputs(gen, dev, B, H, KVH, T, S, D,
                                  torch.float32)
        scale = D ** -0.5
        out, lse = fa._cuda_flash_fwd(q, k, v, scale, causal, window)
        qs, ks, vs = (t.clone().requires_grad_() for t in (
            q, k.repeat_interleave(H // KVH, 1),
            v.repeat_interleave(H // KVH, 1)))

        def lib_fwd_bwd():
            o = sdpa(qs, ks, vs, is_causal=causal)
            torch.autograd.grad(o, (qs, ks, vs), g)

        iters = 50 if T <= 1024 else 5
        args = (q, k, v, out, lse, g, scale, causal, window)
        ms = cuda_ms(lambda: fa._cuda_flash_bwd_fused(*args), iters)
        k2_ms = cuda_ms(lambda: fa._cuda_flash_bwd(*args), iters)
        plain_ms = cuda_ms(lambda: fa._torch_flash_bwd(*args),
                           max(2, iters // 3))
        lib_fwd_bwd_ms = cuda_ms(lib_fwd_bwd, max(2, iters // 3))
        lib_ms = sdpa_bwd_ms(qs, ks, vs, g, causal, max(2, iters // 3))
        ops, nbytes = flash_work(B, H, KVH, T, S, D, causal, window,
                                 4)["flash_bwd_fused"]
        t_ops = ops / PEAK_OPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row = {
            "name": "flash_bwd_fused",
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_bwd_fused.cu",
            "replaces": "mxnet_tpu/ops/flash_attention.py:263",
            "launches": None,  # filled from the llama training phase
            "max_abs_err": max(errs[(case, torch.float32, w)]
                               for w in ("k6_dq", "k6_dk", "k6_dv")),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        }
        say("kernel-time", kernel="flash_bwd_fused",
            shape=f"B{B}_H{H}_KVH{KVH}_T{T}_D{D}_causal{int(causal)}_fp32",
            ms=f"{ms:.4f}", k2_dq_dkv_ms=f"{k2_ms:.4f}",
            k6_over_k2=f"{ms / k2_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", sdpa_fwd_bwd_ms=f"{lib_fwd_bwd_ms:.4f}",
            k6_over_library=f"{ms / lib_ms:.4f}",
            bound_ms=f"{row['bound_ms']:.5f}",
            bound_by=row["bound_by"], tflops=f"{ops / ms / 1e9:.2f}",
            bound_share=f"{row['bound_ms'] / ms:.4f}")
        del q, k, v, g, out, lse, qs, ks, vs
        torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 3c: fused 1x1-conv + BN-statistics kernels (K4, K5) against their
# plain versions
# ---------------------------------------------------------------------------

# name: (M, K, N): ResNet-50's three stage-1 shapes, one of each later
# stage, and two shapes that fit no tile
FUSED_CASES = {
    "stage1_64_64": (401408, 64, 64), "stage1_64_256": (401408, 64, 256),
    "stage1_256_64": (401408, 256, 64), "stage2_512_128": (100352, 512, 128),
    "stage3_256_1024": (25088, 256, 1024),
    "stage4_2048_512": (6272, 2048, 512),
    "ragged_72_40": (1000, 72, 40), "ragged_37_23": (1000, 37, 23),
}
FUSED_MODES = {"plain": (False, False), "prologue": (True, False),
               "prologue_relu": (True, True)}


def fused_inputs(gen, dev, M, K, N, dtype, prologue):
    """x, w, scale, shift (None without a prologue), y, dy, dsum, dssq."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x, w = randn(M, K).to(dtype), randn(K, N, scale=K ** -0.5).to(dtype)
    s = torch.rand(K, generator=gen, device=dev) + 0.5 if prologue else None
    t = randn(K, scale=0.1) if prologue else None
    return (x, w, s, t, randn(M, N).to(dtype), randn(M, N).to(dtype),
            randn(N), randn(N, scale=0.01))


def fused_kernel_phase(dev, gen):
    """K4 and K5's dW and dX kernels against their plain versions on the
    same tensors, every case in fp32 and bf16, with no prologue and with
    one (relu off and on). Returns the largest absolute error of each
    kernel over the fp32 ResNet-50 cases without a prologue (the path's
    variant)."""
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    worst = {"fused_fwd": 0.0, "fused_dw": 0.0, "fused_dx": 0.0}
    for name, (M, K, N) in FUSED_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for mode, (pro, relu) in FUSED_MODES.items():
                x, w, s, t, y, dy, ds, dq = fused_inputs(gen, dev, M, K, N,
                                                         dtype, pro)
                got = {"fused_fwd": fcbn._cuda_fused_fwd(x, w, s, t, relu),
                       "fused_dw": (fcbn._cuda_fused_dw(
                           x, w, y, s, t, dy, ds, dq, relu),),
                       "fused_dx": fcbn._cuda_fused_dx(x, w, y, s, t, dy,
                                                       ds, dq, relu)}
                torch.cuda.synchronize()
                want = {"fused_fwd": fcbn._torch_fused_fwd(x, w, s, t, relu),
                        "fused_dw": (fcbn._torch_fused_dw(
                            x, y, s, t, dy, ds, dq, relu, w.dtype),),
                        "fused_dx": fcbn._torch_fused_dx(x, w, y, s, t, dy,
                                                         ds, dq, relu)}
                lim_t, lim_f = FUSED_TOL[dtype]
                facts = {}
                for kernel, outs in want.items():
                    for i, ref in enumerate(outs):
                        g = got[kernel][i]
                        if ref is None:
                            check(g is None, f"{kernel} {name} output {i}")
                            continue
                        check(g.dtype == ref.dtype and g.shape == ref.shape,
                              f"{kernel} {name} output {i}: {g.dtype} "
                              f"{tuple(g.shape)}")
                        diff = float((g.float() - ref.float()).abs().max())
                        rel = diff / max(float(ref.float().abs().max()),
                                         1e-30)
                        lim = lim_t if ref.dtype == dtype else lim_f
                        check(rel <= lim, f"{kernel} {name} {dtype} {mode} "
                              f"output {i} disagrees with plain: {rel:.3e} > "
                              f"{lim}")
                        facts[f"{kernel[6:]}{i}"] = f"{rel:.1e}"
                        if dtype == torch.float32 and not pro \
                                and not name.startswith("ragged"):
                            worst[kernel] = max(worst[kernel], diff)
                say("fused-kernel", case=name, shape=f"M{M}_K{K}_N{N}",
                    dtype=str(dtype).split(".")[1], mode=mode,
                    rel_err=",".join(f"{k}:{v}" for k, v in facts.items()),
                    tol_rel=f"{lim_t:.3g}/{lim_f:.3g}", ok=True)
                del x, w, y, dy, got, want
    return worst


def fused_work(M, K, N, item=4):
    """Operations (2 M K N) and bytes (each input read once, each output
    written once) of K4 and K5's two kernels without a prologue."""
    x, w, mn, vec = M * K * item, K * N * item, M * N * item, 2 * N * 4
    ops = 2 * M * K * N
    return {"fused_fwd": (ops, x + w + mn + vec),
            "fused_dw": (ops, x + 2 * mn + vec + w),
            "fused_dx": (ops, 2 * mn + w + vec + x)}


def fused_time_phase(dev, gen, worst):
    """K4, K5-dW and K5-dX timed at each of ResNet-50's 1x1 shapes (fp32,
    no prologue, as the training path runs them) with CUDA events, beside
    their bounds, their plain versions and torch.matmul of the bare
    product. The kernels line gets each kernel's totals over the 30 calls
    of one training step."""
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    replaces = {"fused_fwd": "mxnet_tpu/ops/fused_conv_bn.py:105",
                "fused_dw": "mxnet_tpu/ops/fused_conv_bn.py:216",
                "fused_dx": "mxnet_tpu/ops/fused_conv_bn.py:246"}
    total = {k: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "ops": 0, "bytes": 0}
             for k in replaces}
    for M, K, N, calls in RESNET_1X1:
        x, w, _, _, y, dy, ds, dq = fused_inputs(gen, dev, M, K, N,
                                                 torch.float32, False)
        runs = {
            "fused_fwd": (lambda: fcbn._cuda_fused_fwd(x, w, None, None),
                          lambda: fcbn._torch_fused_fwd(x, w, None, None),
                          lambda: torch.matmul(x, w)),
            "fused_dw": (lambda: fcbn._cuda_fused_dw(x, w, y, None, None, dy,
                                                     ds, dq),
                         lambda: fcbn._torch_fused_dw(x, y, None, None, dy,
                                                      ds, dq, False, w.dtype),
                         lambda: torch.matmul(x.t(), dy)),
            "fused_dx": (lambda: fcbn._cuda_fused_dx(x, w, y, None, None, dy,
                                                     ds, dq),
                         lambda: fcbn._torch_fused_dx(x, w, y, None, None, dy,
                                                      ds, dq, False),
                         lambda: torch.matmul(dy, w.t())),
        }
        work = fused_work(M, K, N)
        for name, (kern, plain, lib) in runs.items():
            ms, plain_ms, lib_ms = (cuda_ms(kern, 20), cuda_ms(plain, 10),
                                    cuda_ms(lib, 20))
            ops, nbytes = work[name]
            t_ops = ops / PEAK_OPS[torch.float32] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            tot = total[name]
            tot["ms"] += calls * ms
            tot["plain"] += calls * plain_ms
            tot["lib"] += calls * lib_ms
            tot["ops"] += calls * ops
            tot["bytes"] += calls * nbytes
            say("kernel-time", kernel=name, shape=f"M{M}_K{K}_N{N}_fp32",
                calls_per_step=calls, ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}",
                matmul_product_only_ms=f"{lib_ms:.4f}",
                bound_ms=f"{max(t_ops, t_bytes):.5f}",
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                tflops=f"{ops / ms / 1e9:.2f}",
                bound_share=f"{max(t_ops, t_bytes) / ms:.4f}")
        del x, w, y, dy
    rows = []
    for name, tot in total.items():
        t_ops = tot["ops"] / PEAK_OPS[torch.float32] * 1e3
        t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/fused_conv_bn.cu",
            "replaces": replaces[name],
            "launches": None,  # filled from the ResNet training phase
            "max_abs_err": worst[name],
            "ms": tot["ms"],
            "plain_ms": tot["plain"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # no single PyTorch call computes the product with its
            # statistics; the bare product's time is in the lines above
            "library_ms": None,
        })
        say("kernel-time", kernel=name, shape="resnet50_step_30_calls",
            ms=f"{tot['ms']:.4f}", plain_ms=f"{tot['plain']:.4f}",
            matmul_product_only_ms=f"{tot['lib']:.4f}",
            bound_ms=f"{rows[-1]['bound_ms']:.4f}",
            bound_by=rows[-1]["bound_by"], gflop=f"{tot['ops'] / 1e9:.2f}",
            gbytes=f"{tot['bytes'] / 1e9:.3f}")
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


# ---------------------------------------------------------------------------
# phases 8 and 9: ResNet-50 v1 training through optimize_for
# ---------------------------------------------------------------------------

def resnet_setup(ctx, batch=RESNET_BATCH, size=RESNET_SIZE, spec=None):
    """ResNet-50 v1 as bench_resnet builds it on an accelerator (``spec`` =
    (layers, channels, classes) builds a smaller ResNetV1 for a rehearsal
    on the host), Xavier weights from seed SEED, and its fixed batch
    (images and labels from numpy seed SEED). Returns the net, its
    ``optimize_for("tpu_fused_conv_bn")`` adapter, the batch, the fused
    convs and a builder of the same architecture."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    def build():
        return vision.resnet50_v1(classes=1000) if spec is None else \
            vision.ResNetV1(vision.BottleneckV1, *spec)

    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    net = build()
    net.initialize(init=mx.initializer.Xavier(seed=SEED), ctx=ctx)
    rs = np.random.RandomState(SEED)
    x = mx.nd.array(rs.rand(batch, 3, size, size).astype(np.float32),
                    ctx=ctx)
    y = mx.nd.array(rs.randint(0, 10, (batch,)).astype(np.float32), ctx=ctx)
    net(x[0:2])  # resolve deferred shapes (predict mode: no state moves)
    fused = net.optimize_for(backend="tpu_fused_conv_bn")
    marked = []

    def walk(b):
        if getattr(b, "_tpu_fused", False):
            marked.append(b)
        for c in b._children.values():
            walk(c)

    walk(net)
    if spec is None:
        check(len(marked) == RESNET_FUSED, f"optimize_for marked "
              f"{len(marked)} convs of ResNet-50, expected {RESNET_FUSED}")
    mx.nd.waitall()
    n_params = sum(p.data().size for p in net.collect_params().values())
    say("resnet-model", config="ResNet-50 v1 (resnet50_v1, 1000 classes)"
        if spec is None else f"ResNetV1{spec}", params=n_params,
        fused_convs=len(marked), batch=batch, image=size, dtype="float32",
        init_s=f"{time.perf_counter() - t0:.2f}", ctx=ctx)
    return net, fused, x, y, marked, build


def _resnet_fwd_bwd(mx, call, x, y):
    """One recorded forward and backward; the mean loss stays on the
    device."""
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = sce(call(x), y)
    loss.backward()
    return loss.data.detach().mean()


def _grads(params):
    return {k: p.grad().data.clone() for k, p in params.items()
            if p.grad_req != "null"}


def _grad_errors(grads, ref, skip=()):
    """The worst gradient error, each relative to its own largest |grad|,
    and its parameter."""
    worst, worst_name = 0.0, ""
    for name in ref:
        if name in skip:
            continue
        scale = max(float(ref[name].abs().max()), 1e-30)
        rel = float((grads[name] - ref[name]).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


class _CheckedCalls:
    """Inside ``with``: every K4 and K5 call of the fused operators also
    runs the plain version on the same tensors and records each output's
    error relative to its largest |value| (the plain versions launch no
    kernel of the port, so the launch counts stay the main path's)."""

    def __init__(self):
        from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

        self._fcbn = fcbn
        self.worst = {"fused_fwd": 0.0, "fused_dw": 0.0, "fused_dx": 0.0}
        self.calls = {k: 0 for k in self.worst}

    def _note(self, kernel, outs, refs):
        self.calls[kernel] += 1
        for g, r in zip(outs, refs):
            if r is None:
                continue
            rel = float((g.float() - r.float()).abs().max()) / max(
                float(r.float().abs().max()), 1e-30)
            self.worst[kernel] = max(self.worst[kernel], rel)

    def __enter__(self):
        f = self._fcbn
        self._saved = (f._fused_fwd, f._fused_bwd)
        fwd, bwd = self._saved

        def fwd_checked(*args):
            out = fwd(*args)
            self._note("fused_fwd", out, f._torch_fused_fwd(*args))
            return out

        def bwd_checked(*args):
            dx, dw, dsc, dbi = bwd(*args)
            rdx, rdw, rsc, rbi = f._torch_fused_bwd(*args)
            self._note("fused_dw", (dw,), (rdw,))
            self._note("fused_dx", (dx, dsc, dbi), (rdx, rsc, rbi))
            return dx, dw, dsc, dbi

        f._fused_fwd, f._fused_bwd = fwd_checked, bwd_checked
        return self

    def __exit__(self, *exc):
        self._fcbn._fused_fwd, self._fcbn._fused_bwd = self._saved
        return False


def _swapped_op(forward):
    """An ``nd`` operator for ``_contrib_fused_matmul_stats`` whose forward
    is ``forward(x, w)`` and whose backward is K5's plain version."""
    from mxnet_tpu_torch.ndarray.ndarray import apply
    from mxnet_tpu_torch.ops.fused_conv_bn import _torch_fused_bwd

    class Swapped(torch.autograd.Function):
        @staticmethod
        def forward(ctx_, a, w):
            out = forward(a, w)
            ctx_.save_for_backward(a, w, out[0])
            return out

        @staticmethod
        def backward(ctx_, dy, dsum, dssq):
            a, w, out = ctx_.saved_tensors
            dx, dw, _, _ = _torch_fused_bwd(a, w, out, None, None, dy, dsum,
                                            dssq)
            return dx, dw

    return lambda a, w: apply(Swapped.apply, a, w)


def resnet_parity_phase(net, fused, x, y, marked, build, launches, ctx):
    """ResNet-50 through optimize_for with the kernels against the same
    net with K4/K5 swapped, in this script only, for their plain versions,
    and against the un-fused net, all in training mode with cuDNN's
    deterministic algorithms.

    - Every K4/K5 call of the kernel run is also held against its plain
      version on the same tensors (FUSED_TOL).
    - Gradients: the run with K5 swapped for its plain version (K4 kept,
      so both backward passes see the same forward activations) must give
      every weight's gradient within RESNET_GRAD_RTOL of its own largest
      |grad|. With K4 swapped too the forward rounds otherwise, and at
      Xavier init this net's training-mode gradient is chaotic at fp32
      rounding: every relu that a rounding moves across zero changes the
      backward, and BatchNorm's backward leaves a small residual of large
      cancelling terms. That run's gradient difference is printed beside
      ``chaos_floor``, the kernel run against itself with its input moved
      by one rounding.
    - Losses: with K4/K5 swapped, within RESNET_LOSS_RTOL; the un-fused
      net, within UNFUSED_LOSS_RTOL (its gradient difference printed)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    def swapped_run(op, expect):
        """One step with ``op`` in place of the fused operator; the
        kernels launched must be ``expect``."""
        kernel_op = mx.nd._contrib_fused_matmul_stats
        mx.nd._contrib_fused_matmul_stats = op
        launches.clear()
        try:
            loss = float(_resnet_fwd_bwd(mx, fused, x, y))
        finally:
            mx.nd._contrib_fused_matmul_stats = kernel_op
        got = {k: v for k, v in launches.items() if v}
        check(got == expect, f"the swapped run launched {got}, not {expect}")
        return loss

    params = net.collect_params()
    n = len(marked)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches.clear()
        with _CheckedCalls() as calls:
            loss_k = float(_resnet_fwd_bwd(mx, fused, x, y))
        counts = dict(launches)
        lim = FUSED_TOL[torch.float32][0]
        say("resnet-parity", check="every_call_vs_plain",
            calls=calls.calls,
            worst_rel={k: f"{v:.2e}" for k, v in calls.worst.items()},
            tol_rel=lim)
        for k in ("fused_fwd", "fused_dw", "fused_dx"):
            check(counts.get(k, 0) == n and calls.calls[k] == n,
                  f"{k} launched {counts.get(k, 0)} times in one step of "
                  f"{n} fused convs")
            check(calls.worst[k] <= lim, f"{k} disagrees with its plain "
                  f"version on the main path's tensors: {calls.worst[k]:.3e}")
        grads_k = _grads(params)

        loss_b = swapped_run(
            _swapped_op(lambda a, w: fcbn._fused_fwd(a, w, None, None,
                                                     False)),
            {"fused_fwd": n})
        # a conv bias before a training-mode BatchNorm has a zero gradient
        # in exact arithmetic: float noise on both sides, judged against
        # its conv's weight gradient
        noise = {k for k in grads_k if "conv2d" in k and k.endswith("_bias")}
        grads_b = _grads(params)
        worst, worst_name = _grad_errors(grads_b, grads_k, noise)
        for k in noise:
            w = k[:-len("bias")] + "weight"
            rel = float((grads_b[k] - grads_k[k]).abs().max()) / max(
                float(grads_k[w].abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, k
        say("resnet-parity", vs="plain_K5_same_forward",
            loss_kernels=f"{loss_k:.7f}", loss_plain_k5=f"{loss_b:.7f}",
            worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
            tol_grad=RESNET_GRAD_RTOL, params=len(grads_k))
        check(loss_b == loss_k, "the same forward gave another loss")
        check(worst <= RESNET_GRAD_RTOL, f"{worst_name} gradient with K5 "
              f"disagrees with its plain version: {worst}")
        del grads_b

        loss_p = swapped_run(
            _swapped_op(lambda a, w: fcbn._torch_fused_fwd(a, w, None,
                                                           None)), {})
        chaos, chaos_name = _grad_errors(_grads(params), grads_k, noise)
        xp = NDArray(x.data * (1.0 + 2.0 ** -24 * torch.randn(
            x.shape, generator=torch.Generator(x.data.device).manual_seed(
                SEED), device=x.data.device)))
        _resnet_fwd_bwd(mx, fused, xp, y)
        floor, floor_name = _grad_errors(_grads(params), grads_k, noise)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        say("resnet-parity", vs="plain_K4_K5", loss_kernels=f"{loss_k:.7f}",
            loss_plain=f"{loss_p:.7f}", loss_rel=f"{loss_rel:.3e}",
            tol_loss=RESNET_LOSS_RTOL, worst_grad_rel=f"{chaos:.3e}",
            worst_param=chaos_name, chaos_floor=f"{floor:.3e}",
            chaos_floor_param=floor_name)
        check(np.isfinite(loss_k) and loss_rel <= RESNET_LOSS_RTOL,
              "ResNet-50 loss with K4/K5 disagrees with their plain versions")

        # the un-fused net on the same weights
        plain = build()
        plain.initialize(ctx=ctx)
        plain(x[0:2])
        for p, q in zip(plain.collect_params().values(), params.values()):
            p.set_data(q.data())
        loss_u = float(_resnet_fwd_bwd(mx, plain, x, y))
        grads_u = {k: p.grad().data for k, p in zip(
            params.keys(), plain.collect_params().values())
            if p.grad_req != "null"}
        worst, worst_name = _grad_errors(grads_u, grads_k, noise)
        loss_rel = abs(loss_k - loss_u) / abs(loss_u)
        say("resnet-parity", vs="unfused_net", loss_fused=f"{loss_k:.7f}",
            loss_unfused=f"{loss_u:.7f}", loss_rel=f"{loss_rel:.3e}",
            tol_loss=UNFUSED_LOSS_RTOL, worst_grad_rel=f"{worst:.3e}",
            worst_param=worst_name, chaos_floor=f"{floor:.3e}")
        check(loss_rel <= UNFUSED_LOSS_RTOL,
              "the fused ResNet-50 loss disagrees with the un-fused net's")
        del plain, grads_u, grads_k
    finally:
        torch.backends.cudnn.deterministic = deterministic


def resnet_group(name):
    """The kind of a kernel in a ResNet train step's device time."""
    n = name.lower()
    if "mxtpu_fcbn" in n:
        if "dw_kernel" in n or "reduce_splits" in n:
            return "k5_dw"
        return "k5_dx" if "dx_kernel" in n else "k4"
    if any(k in n for k in ("conv", "cudnn", "xmma", "implicit", "wgrad",
                            "dgrad", "fprop", "winograd")):
        return "conv_cudnn"
    return "gemm" if "gemm" in n else "bn_elementwise"


def _device_us(prof):
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return by_name


def resnet_train_phase(net, fused, x, y, marked, launches, steps=10):
    """The Gluon loop with bench_resnet's settings: one warm-up step,
    ``steps`` timed steps (host clock around synchronised work), one
    profiled step (its forward + backward and its SGD update in two
    profiler windows). The launch counts are read over exactly these
    steps."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile

    batch = x.shape[0]
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", dict(RESNET_SGD))
    stats = {k: p.data().data.clone() for k, p in params.items()
             if "running" in k}

    def step():
        loss = _resnet_fwd_bwd(mx, fused, x, y)
        trainer.step(batch)
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
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_fb:
        t1 = time.perf_counter()
        losses.append(_resnet_fwd_bwd(mx, fused, x, y))
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    with profile(activities=acts) as prof_sgd:
        t1 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        window_us += (time.perf_counter() - t1) * 1e6
    counts = dict(launches)
    n_steps = steps + 2
    losses = [float(v) for v in losses]
    by_name = _device_us(prof_fb)
    sgd_us = sum(_device_us(prof_sgd).values())
    busy = sum(by_name.values()) + sgd_us
    check(busy > 0, "the profiler saw no device time")
    groups = {"sgd": sgd_us}
    for name, us in by_name.items():
        g = resnet_group(name)
        groups[g] = groups.get(g, 0.0) + us
    say("resnet-train", device_steps=n_steps, step_ms=f"{step_s * 1e3:.3f}",
        images_per_s=f"{batch / step_s:.2f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        profiled_busy_ms=f"{busy / 1e3:.3f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}",
        fused_fwd=counts.get("fused_fwd", 0),
        fused_dw=counts.get("fused_dw", 0),
        fused_dx=counts.get("fused_dx", 0))
    say("resnet-step-split", **{g: f"{us / 1e3:.3f}ms/{us / busy:.4f}"
                                for g, us in sorted(groups.items(),
                                                    key=lambda kv: -kv[1])})
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("resnet-step-kernel", ms_per_step=f"{us / 1e3:.4f}",
            share=f"{us / busy:.4f}", name=f'"{name[:90]}"')
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    moved = 0
    for k, before in stats.items():
        now = params[k].data().data
        check(bool(torch.isfinite(now).all()), f"{k} is not finite")
        moved += int(not torch.equal(now, before))
    check(moved == len(stats), f"only {moved} of {len(stats)} running "
          "statistics moved")
    for name in ("fused_fwd", "fused_dw", "fused_dx"):
        check(counts.get(name, 0) == len(marked) * n_steps,
              f"{name} launched {counts.get(name, 0)} times in {n_steps} "
              f"train steps of {len(marked)} fused convs")
    return counts


# ---------------------------------------------------------------------------
# phases 10 and 11: Llama-3-8B widths through SPMDTrainStep(mesh=None)
# ---------------------------------------------------------------------------

def llama_setup(ctx, layers=LLAMA_LAYERS, seq=LLAMA_SEQ, **cut):
    """Llama-3-8B's widths with ``layers`` decoder layers (``cut``
    overrides widths for a rehearsal on the host), Normal(0.02) weights
    from seed SEED, and one sequence from numpy seed SEED: x = ids[:, :-1],
    y = ids[:, 1:] of a (1, seq + 1) draw. Deferred shapes are resolved by
    one predict-mode forward."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    net = mx.models.llama3_8b(num_layers=layers, **cut)
    net.initialize(init=mx.initializer.Normal(0.02, seed=SEED), ctx=ctx)
    vocab = net._cfg["vocab_size"]
    ids = np.random.RandomState(SEED).randint(0, vocab, (1, seq + 1))
    x = mx.nd.array(ids[:, :-1], dtype="int32", ctx=ctx)
    y = mx.nd.array(ids[:, 1:].astype(np.float32), ctx=ctx)
    net(x)
    mx.nd.waitall()
    n_params = sum(p.data().size for p in net.collect_params().values())
    if not cut:
        check(n_params == LLAMA_PARAMS and layers == LLAMA_LAYERS,
              f"Llama-3-8B cut to {layers} layers has {n_params} parameters")
    say("llama-model", config=f"Llama-3-8B widths, {layers} of 32 layers",
        params=n_params, batch=1, seq=seq, dtype="float32",
        init_s=f"{time.perf_counter() - t0:.2f}", ctx=ctx)
    return net, x, y


def llama_lm_loss(mx):
    """The reference's ``test_llama_tiny_train`` loss: softmax
    cross-entropy over the flattened logits."""
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(logits, labels):
        return sce(logits.reshape((-1, logits.shape[-1])),
                   labels.reshape((-1,)))

    return lm_loss


def llama_parity_phase(net, x, y, launches):
    """One forward + backward through the Gluon loop with
    ``MXTPU_FLASH_BWD=fused`` (K6), then with ``split`` (K2), on the same
    weights: the forward is the same K1 launches, so the loss must be
    equal; every gradient must agree within TRAIN_GRAD_RTOL of its own
    largest |grad| (Llama has no bias whose exact gradient is zero)."""
    import mxnet_tpu_torch as mx

    lm_loss = llama_lm_loss(mx)
    params = net.collect_params()

    def fwd_bwd(route):
        os.environ["MXTPU_FLASH_BWD"] = route
        launches.clear()
        with mx.autograd.record():
            loss = mx.nd.mean(lm_loss(net(x), y))
        loss.backward()
        value = float(loss.asnumpy())
        got = {k: v for k, v in launches.items() if v}
        return value, got

    try:
        loss_f, got_f = fwd_bwd("fused")
        grads_f = _grads(params)
        loss_s, got_s = fwd_bwd("split")
    finally:
        os.environ.pop("MXTPU_FLASH_BWD", None)
    n = net._cfg["num_layers"]
    check(got_f == {"flash_fwd": n, "flash_bwd_fused": n},
          f"the fused run launched {got_f}")
    check(got_s == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n},
          f"the split run launched {got_s}")
    worst, worst_name = _grad_errors(grads_f, _grads(params))
    say("llama-parity", loss_k6=f"{loss_f:.7f}", loss_k2=f"{loss_s:.7f}",
        worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
        tol_rel=TRAIN_GRAD_RTOL, params=len(grads_f),
        launches_k6_run=got_f, launches_k2_run=got_s)
    check(np.isfinite(loss_f) and loss_f == loss_s,
          "the same forward gave another loss")
    check(worst <= TRAIN_GRAD_RTOL, f"{worst_name} gradient with K6 "
          f"disagrees with K2's: {worst}")
    del grads_f


def llama_group(name):
    """The kind of a kernel in a Llama forward + backward's device
    time."""
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "k1"
    if "flash_bwd_fused_kernel" in n:
        return "k6"
    if "flash_bwd" in n:
        return "k2"
    if "gemm" in n or "gemv" in n:
        return "fp32_products"
    return "elementwise"


def llama_train_phase(net, x, y, launches, steps=10):
    """``SPMDTrainStep(mesh=None)`` with Adam under
    ``MXTPU_FLASH_BWD=fused``: ``run_steps`` for one warm-up step (its
    first call also copies the weights into the step and resolves shapes
    with one predict-mode forward), ``steps`` timed steps (host clock
    around synchronised work) and one profiled step, whose loss and
    gradients and whose Adam update run in two profiler windows. The
    launch counts are read over exactly these steps."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile

    os.environ["MXTPU_FLASH_BWD"] = "fused"
    try:
        step = mx.parallel.SPMDTrainStep(net, llama_lm_loss(mx), "adam", {},
                                         mesh=None)
        launches.clear()
        torch.cuda.reset_peak_memory_stats()
        losses = [step.run_steps(x, y, 1, lr=LLAMA_ADAM_LR)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step.run_steps(x, y, steps, lr=LLAMA_ADAM_LR))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        raw_x, raw_y, lr = step._prepare(x, y, LLAMA_ADAM_LR)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof_fb:
            t1 = time.perf_counter()
            loss, grads = step._loss_and_grads(raw_x, raw_y)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t1) * 1e6
        with profile(activities=acts) as prof_upd:
            t1 = time.perf_counter()
            step._apply(grads, lr)
            torch.cuda.synchronize()
            window_us += (time.perf_counter() - t1) * 1e6
        losses.append(loss)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        os.environ.pop("MXTPU_FLASH_BWD", None)
    counts = dict(launches)
    n_steps = steps + 2
    losses = [float(v) for v in losses]
    by_name = _device_us(prof_fb)
    adam_us = sum(_device_us(prof_upd).values())
    busy = sum(by_name.values()) + adam_us
    check(busy > 0, "the profiler saw no device time")
    groups = {"adam_update": adam_us}
    for name, us in by_name.items():
        g = llama_group(name)
        groups[g] = groups.get(g, 0.0) + us
    seq = x.shape[0] * x.shape[1]
    layers = net._cfg["num_layers"]
    say("llama-train", device_steps=n_steps, step_ms=f"{step_s * 1e3:.3f}",
        tokens_per_s=f"{seq / step_s:.2f}", loss_first=f"{losses[0]:.5f}",
        loss_after_timed=f"{losses[1]:.5f}", loss_last=f"{losses[-1]:.5f}",
        peak_mem_gb=f"{peak_gb:.2f}", profiled_busy_ms=f"{busy / 1e3:.3f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}",
        flash_fwd=counts.get("flash_fwd", 0),
        flash_bwd_fused=counts.get("flash_bwd_fused", 0),
        flash_bwd_dq=counts.get("flash_bwd_dq", 0),
        flash_bwd_dkv=counts.get("flash_bwd_dkv", 0))
    say("llama-step-split", **{g: f"{us / 1e3:.3f}ms/{us / busy:.4f}"
                               for g, us in sorted(groups.items(),
                                                   key=lambda kv: -kv[1])})
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say("llama-step-kernel", ms_per_step=f"{us / 1e3:.4f}",
            share=f"{us / busy:.4f}", name=f'"{name[:90]}"')
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    # one sequence is memorised: after the timed steps the loss is near 0,
    # where Adam's steps move it up and down
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(counts.get("flash_bwd_fused", 0) == layers * n_steps,
          f"K6 launched {counts.get('flash_bwd_fused', 0)} times in "
          f"{n_steps} train steps of {layers} layers")
    check(counts.get("flash_bwd_dq", 0) == 0
          and counts.get("flash_bwd_dkv", 0) == 0,
          f"K2 launched under MXTPU_FLASH_BWD=fused: {counts}")
    # one predict-mode forward resolves the step's state on its first call
    check(counts.get("flash_fwd", 0) == layers * (n_steps + 1),
          f"K1 launched {counts.get('flash_fwd', 0)} times")
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
    flash_rows, flash_errs = flash_kernel_phase(dev, gen)
    k6_row = fused_bwd_time_phase(dev, gen, flash_errs)
    fused_rows = fused_time_phase(dev, gen, fused_kernel_phase(dev, gen))
    torch.cuda.empty_cache()

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
    del bert, x, y
    torch.cuda.empty_cache()

    net, fused, x, y, marked, build = resnet_setup(mx.gpu(0))
    resnet_parity_phase(net, fused, x, y, marked, build, _kernels.LAUNCHES,
                        mx.gpu(0))
    torch.cuda.empty_cache()
    counts = resnet_train_phase(net, fused, x, y, marked, _kernels.LAUNCHES)
    for r in fused_rows:
        r["launches"] = counts[r["name"]]
    del net, fused, x, y, marked, build
    torch.cuda.empty_cache()

    llama, x, y = llama_setup(mx.gpu(0))
    llama_parity_phase(llama, x, y, _kernels.LAUNCHES)
    torch.cuda.empty_cache()
    counts = llama_train_phase(llama, x, y, _kernels.LAUNCHES)
    k6_row["launches"] = counts["flash_bwd_fused"]
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [row] + flash_rows + fused_rows
                      + [k6_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
