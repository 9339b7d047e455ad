#!/usr/bin/env python
"""What torch.distributed can do on this machine's card(s).

Answers, for the data-parallel paths of ``mxnet_tpu_torch``:

- whether NCCL forms a communicator of two ranks that share one card
  (``nccl2``), and its error text when it does not;
- which gloo collectives take CUDA tensors, with their results checked
  (``gloo2``);
- the time of one ``all_reduce`` of a 64 MiB float32 bucket in a one-rank
  NCCL world (``nccl1``), and, in the two-rank gloo world, of a whole
  BERT-base gradient set (133,547,324 float32, 534 MB) reduced as one
  tensor and as 4 MiB buckets, from CUDA and from host tensors.

Run with no arguments: ``python tools/dist_probe.py``. Each world is two
(or one) worker processes of this file (``--worker SCENARIO RANK WORLD
HOST:PORT``), each with a hard time limit; a world that hangs is killed
with its process group. Prints one JSON line per rank and the card's
name and power limit. Needs a CUDA card; imports only torch.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

BERT_PARAMS = 133_547_324
BUCKET = 4 << 20


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cuda_ms(fn, iters=3):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _gloo_cases(dist, torch, rank, world, dev):
    """Each gloo collective on tensors on ``dev``: 'ok', 'wrong' or the
    error's first line."""
    out = {}

    def run(name, fn):
        try:
            out[name] = "ok" if fn() else "wrong"
        except Exception as e:  # the probe reports, it does not fail
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    n = 8 * world

    def all_reduce():
        t = torch.full((n,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def reduce_scatter_tensor():
        src = torch.arange(n, dtype=torch.float32, device=dev) + rank
        dst = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(dst, src)
        want = (torch.arange(n, dtype=torch.float32, device=dev) * world
                + sum(range(world)))[rank * (n // world):
                                     (rank + 1) * (n // world)]
        return bool(torch.equal(dst, want))

    def all_gather_into_tensor():
        src = torch.full((4,), float(rank), device=dev)
        dst = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(dst, src)
        return bool(torch.equal(dst, torch.arange(world, device=dev)
                                .float().repeat_interleave(4)))

    def all_gather():
        src = torch.full((4,), float(rank), device=dev)
        dst = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(dst, src)
        return all(bool((d == i).all()) for i, d in enumerate(dst))

    def broadcast():
        t = torch.full((4,), float(rank + 7), device=dev)
        dist.broadcast(t, 0)
        return bool((t == 7).all())

    def reduce_scatter():
        ins = [torch.full((4,), float(rank + i), device=dev)
               for i in range(world)]
        dst = torch.empty(4, device=dev)
        dist.reduce_scatter(dst, ins)
        return bool((dst == sum(r + rank for r in range(world))).all())

    def barrier():
        dist.barrier()
        return True

    for fn in (all_reduce, reduce_scatter_tensor, all_gather_into_tensor,
               all_gather, broadcast, reduce_scatter, barrier):
        run(fn.__name__, fn)
    return out


def _bert_allreduce_ms(dist, torch, dev):
    """ms of reducing BERT-base's fp32 gradient set on ``dev``: as one
    tensor, and as 4 MiB buckets (one collective each)."""
    flat = torch.ones(BERT_PARAMS, device=dev)
    per = BUCKET // 4
    buckets = list(torch.split(flat, per))

    def one():
        dist.all_reduce(flat)

    def each():
        for b in buckets:
            dist.all_reduce(b)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(fn):
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(2):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / 2

    return {"one_tensor_ms": timed(one), "buckets": len(buckets),
            "bucketed_ms": timed(each)}


def worker(scenario, rank, world, addr):
    import datetime

    import torch
    import torch.distributed as dist

    rank, world = int(rank), int(world)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    backend = "nccl" if scenario.startswith("nccl") else "gloo"
    res = {"scenario": scenario, "rank": rank, "world": world,
           "backend": backend}
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=60),
            **({"device_id": dev} if backend == "nccl" else {}))
        if scenario == "nccl2":
            t = torch.full((1 << 18,), float(rank + 1), device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            res["all_reduce"] = "ok" if bool((t == 3).all()) else "wrong"
        elif scenario == "nccl1":
            t = torch.ones((64 << 20) // 4, device=dev)
            res["all_reduce_64MiB_ms"] = _cuda_ms(lambda: dist.all_reduce(t),
                                                  iters=10)
        else:
            res["cuda"] = _gloo_cases(dist, torch, rank, world, dev)
            res["cpu"] = _gloo_cases(dist, torch, rank, world,
                                     torch.device("cpu"))
            res["bert_cuda"] = _bert_allreduce_ms(dist, torch, dev)
            res["bert_cpu"] = _bert_allreduce_ms(dist, torch,
                                                 torch.device("cpu"))
        dist.destroy_process_group()
    except Exception as e:
        res["error"] = f"{type(e).__name__}: {str(e)[:600]}"
    print("PROBE " + json.dumps(res), flush=True)


def run_world(scenario, world, limit):
    port = _free_port()
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", scenario, str(r),
             str(world), f"127.0.0.1:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True))
    outs = []
    deadline = time.monotonic() + limit
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
        except subprocess.TimeoutExpired:
            for q in procs:
                try:
                    os.killpg(q.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            out, _ = p.communicate()
            out = (out or "") + f"\n[killed after {limit} s]"
        outs.append((p.returncode, out))
    for rc, out in outs:
        lines = [ln[6:] for ln in out.splitlines() if ln.startswith("PROBE ")]
        print(lines[0] if lines else json.dumps(
            {"scenario": scenario, "rc": rc, "tail": out[-1500:]}),
            flush=True)


def main():
    if len(sys.argv) > 5 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:6])
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("dist_probe: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, nccl {torch.cuda.nccl.version()}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    run_world("nccl1", 1, 120)
    run_world("nccl2", 2, 120)
    run_world("gloo2", 2, 300)


if __name__ == "__main__":
    main()
