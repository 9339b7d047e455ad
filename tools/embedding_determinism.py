#!/usr/bin/env python3
"""Does an embedding's weight gradient repeat bit for bit, and what does
it cost? On one CUDA card, at BERT-base's shapes (batch 64 x 128, units
768): the word table (30522 rows, a quarter of the positions on one id,
as frequent tokens are) and the token-type table (2 rows, ids 0 then 1
over each sequence). For the port's ``ops.nn.embedding`` and for
``torch.nn.functional.embedding``: three forward + backward passes from
the same weights (equal gradients or not) and the mean ms of 20 passes
timed with CUDA events.

    python tools/embedding_determinism.py
"""

import os
import sys

import torch
import torch.nn.functional as tF


def main():
    if not torch.cuda.is_available():
        raise SystemExit("embedding_determinism: no CUDA device visible")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from mxnet_tpu_torch.ops.nn import embedding

    dev = torch.device("cuda")
    torch.manual_seed(0)
    ways = {"port": embedding, "F.embedding": lambda i, w: tF.embedding(i, w)}
    words = torch.randint(0, 30522, (64, 128), device=dev)
    words[:, ::4] = 7
    types = (torch.arange(128, device=dev) >= 64).long().expand(64, 128)
    for table, rows, idx in (("words", 30522, words), ("types", 2, types)):
        g = torch.randn(64, 128, 768, device=dev)
        w0 = torch.randn(rows, 768, device=dev)
        for name, fn in ways.items():
            grads = []
            for _ in range(3):
                w = w0.clone().requires_grad_(True)
                fn(idx, w).backward(g)
                grads.append(w.grad)
            same = all(torch.equal(grads[0], x) for x in grads[1:])
            w = w0.clone().requires_grad_(True)
            for _ in range(5):
                fn(idx, w).backward(g)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn(idx, w).backward(g)
            end.record()
            torch.cuda.synchronize()
            print(f"[embedding] table={table} rows={rows} way={name} "
                  f"fwd_bwd_ms={start.elapsed_time(end) / 20:.4f} "
                  f"repeats_bitwise={same}", flush=True)


if __name__ == "__main__":
    main()
