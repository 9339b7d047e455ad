#!/usr/bin/env python3
"""Parameter counts of zoo nets at full width (1000 classes), and of
BERT-base as its pretraining defines it (``models.bert_base()``: pooler,
NSP classifier, MLM decoder, vocab 30522), in either package: each net
built, its deferred shapes resolved by one predict-mode forward of a
single image at its input size (of 8 token ids for BERT), and its
parameters counted (running statistics included).

    JAX_PLATFORMS=cpu python tools/zoo_param_counts.py --side jax
    python tools/zoo_param_counts.py --side torch

``chip_smoke.py``'s ``ZOO_PARAMS`` and ``BERT_PRETRAIN_PARAMS`` hold the
JAX package's counts from the first command; its ``[zoo]`` and
``[bert-pretrain]`` phases hold the port's nets to them. The last line is
one JSON object ``{name: count}``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each family's canonical net and its input size
NETS = (("alexnet", 224), ("vgg16", 224), ("vgg16_bn", 224),
        ("squeezenet1.0", 224), ("squeezenet1.1", 224),
        ("densenet121", 224), ("mobilenet1.0", 224),
        ("mobilenetv2_1.0", 224), ("inceptionv3", 299))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--side", choices=("jax", "torch"), required=True)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    if args.side == "jax":
        import mxnet_tpu as mx
        from mxnet_tpu.gluon.model_zoo import vision
        ctx_kw = {}
    else:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.gluon.model_zoo import vision
        ctx_kw = {"ctx": mx.cpu()}
    counts = {}
    for name, size in NETS:
        t0 = time.perf_counter()
        net = vision.get_model(name, classes=1000)
        net.initialize(**ctx_kw)
        if args.side == "jax":
            net.hybridize()  # one compile instead of one per operator
        net(mx.nd.array(np.zeros((1, 3, size, size), np.float32), **ctx_kw))
        counts[name] = int(sum(int(np.prod(q.shape))
                               for q in net.collect_params().values()))
        print(f"{name} {counts[name]} {time.perf_counter() - t0:.1f}s",
              flush=True)
    net = mx.models.bert_base()
    net.initialize(**ctx_kw)
    net(mx.nd.array(np.zeros((1, 8), np.int32), dtype="int32", **ctx_kw))
    counts["bert_base"] = int(sum(int(np.prod(q.shape))
                                  for q in net.collect_params().values()))
    print(f"bert_base {counts['bert_base']}", flush=True)
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
