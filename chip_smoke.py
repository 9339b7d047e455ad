#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases (each prints one line of facts; any failure exits non-zero):

1. environment — card name and power limit (``nvidia-smi``), compute
   capability (must be 9.0), TF32 turned off for float32 parity;
2. build — every CUDA kernel of the port from ``mxnet_tpu_torch/csrc``;
   the TF32 tensor-core instructions in the SASS of each flash library and
   of K4 and K5's, and in each instantiation of K4's own function
   (``[sass]``); then, for K4 and K5's kernels at each storage type
   and prologue mode and each flash kernel (K1, K2's two, K6) at each
   storage type and head-dim bucket, the registers, shared memory, local
   memory and blocks per SM the runtime reports (``[kernel-resources]``);
3. kernels — each kernel against its plain PyTorch version on the card,
   in float32, bfloat16 and float16: paged decode (K3: its split kernel
   and its combine kernel) at the serving path's shapes and at the split's
   edge lengths, two calls equal bit for bit, then timed at the serving
   slice's contexts and at long ones (4096 to 8192 positions), the calls
   queued back to back; flash attention forward (K1), its split backward (K2:
   the dq kernel, which also forms delta, and the dk/dv kernel) and its
   fused backward (K6) at BERT-base's training shape,
   ``bench_flash_attention``'s causal shape, llama3-8B's head layout with
   a sliding window and at its full causal training shape (T = 8192), a
   ragged and a causal cross shape, and Transformer-base's three (encoder
   self, decoder causal self, and the non-causal cross-attention with
   T = 120 != S = 128); head dim 160, which both packages
   compute with their plain versions (``flash_plain_*`` and
   ``paged_decode_plain`` counts, no kernel launched); then each timed
   with CUDA events beside its bound, its plain version's time and one
   PyTorch library call computing the same function (K1 and K6 beside
   SDPA and K2 at BERT-base's, Transformer-base's three and Llama-3-8B's
   shapes; at BERT-base's and Llama-3-8B's, K1's O and
   LSE, K2's gradients and K6's gradients must also repeat bit for bit
   over two calls, ``[determinism]``);
4. serving parity — a StarCoderBase-1B-width decoder (random weights from
   a seed): prefill + 32 paged decode steps, each step's logits against
   the dense forward's logits at that position; then one full-width
   decode step, timed (the device's time for a step queued behind a spin
   kernel, CUDA events around 10 steps as the host issues them, the
   host's time to enqueue one) and profiled (device time by kernel, K3's
   share, idle share);
5. serving — ``GenerationEngine`` answers 20 ragged requests at full
   width, every prefill and every decode chunk a replay of its captured
   CUDA graph; each of K3's two launch counts must equal layers x decode
   steps; the time to first token (p50/p99, all 20 submitted at once);
5b. decode chunk — one replay of the captured chunk (8 steps, 8 seated
   slots) equal to the eager chunk body on the same static inputs, and
   the pools equal after it, bit for bit; K3's two kernels once per layer
   per step from the replay's accounting; the chunk replayed and eager on
   the same inputs: host ms, busy ms and idle share of a profiled window;
   two captured engines from one seed sample the same tokens;
5c. serve repo (generation) — StarCoderBase-1B staged by
   ``ModelRepository``: a captured ``GenerationEngine`` and its canary;
5d. prefill graph — each prompt bucket's prefill (256 and 1024, the
   buckets of phase 5) as the CUDA graph the engine's deploy captures:
   one replay against the eager prefill on the same inputs and pools,
   logits and every pool block but the null block equal bit for bit, the
   first token (greedy and sampled from three seeds) equal; device ms of
   a replay and of the eager prefill, and host ms of each from the
   request's buffers to its first token on the host;
6. train parity — BERT-base at full width (bench_bert's shapes: batch 64,
   sequence 128, vocab 30522), one forward + backward through the Gluon
   loop with the kernels, and again with attention swapped (here only)
   for the plain versions: the loss and every gradient must agree;
7. train — the Gluon loop as ``bench_bert`` runs it (Normal(0.02) init,
   Adam lr 1e-4 wd 0.01): one warm-up step, 10 timed steps, one profiled
   step; the loss must be finite and fall, and K1/K2 must have launched
   once per layer per forward/backward;
7b. train hybrid — BERT-base ``hybridize()``d (the cached graph: its
   forward and backward captured as CUDA graphs and replayed): one
   forward + backward against an eager net from the same seed (loss 1e-5,
   every gradient 1e-4 of its layer's largest, bit for bit expected),
   then the loop of phase 7 on it, every step a replay: one recording
   entry, K1/K2 once per layer per pass from the replays' launch
   accounting, the flash kernels in the profile; a half batch captures a
   second entry (cause ``shape``) and a cast captures again (cause
   ``params``) to the same loss;
7c. params — ``save_parameters`` of the trained BERT-base and
   ``load_parameters`` into a net from another seed: outputs equal bit
   for bit; two saves give the same bytes, the parameters' bytes plus the
   container's header; a load into a hybridized net that has captured
   an entry captures nothing and replays the loaded weights' output; a
   bfloat16 net round-trips bit for bit;
7d. warmup — ``HybridBlock.warmup`` of a hybridized BERT-base at the
   buckets (64, 64) and (64, 128) with an Adam trainer: returns 2,
   weights, gradient buffers and handles restored in place, the first
   real step captures nothing, 3 steps equal to a net that did not warm
   up, existing Adam states put back in place;
7e. aot predict — ``aot_predict_fn`` of BERT-base captured into a CUDA
   graph per bucket (batch 8, 32, 64): each replay equal to the eager
   forward, K1 12 times a replay, device ms beside the eager forward's;
7e2. serve bert — BERT-base at full width (its sequence, pooled and NSP
   outputs; seeded weights, fp32) served by ``InferenceEngine``: buckets
   32, 64, 128, one captured CUDA graph each, max_batch 8, max_wait 5 ms;
   64 ragged requests (17-128 ids) together, then 16 one at a time;
   every batch ``torch.equal`` to the eager forward on the same padded
   ids, compiles 3, K1 12 launches per batch; requests/s, p50/p99, batch
   fill, replay ms per bucket;
7e3. serve repo — ``ModelRepository``: BERT-base v1 serving, v2 staged
   and flipped under traffic, each answer its version's; rollback
   without a capture; a NaN version refused by the canary;
7f. bert pretrain — BERT-base as the reference defines it
   (``models.bert_base()``: dropout 0.1, pooler, NSP classifier and MLM
   decoder; 133,547,324 parameters, the JAX package's count), batch 64 x
   128, Adam lr 1e-4 wd 0.01, each step's mask (15% of the positions,
   ``nd.random.uniform < 0.15`` then ``nd.where`` to the mask id) and NSP
   labels (``nd.random.randint``) drawn from ``mx.random``; the loss the
   MLM cross-entropy over the masked positions (``nd.log_softmax``,
   ``nd.pick``) plus the NSP cross-entropy (``nd.softmax_cross_entropy``).
   At dropout 0 one step with K1/K2 against the plain versions (loss 1e-5,
   gradients 1e-4 of their layer's largest); Dropout(0.1) keeps 0.9 and
   the masks cover 0.15, each within 1e-3; eager then ``hybridize()``d:
   10 steps (one warm-up, one profiled) from ``mx.random.seed(SEED)``,
   twice, the losses equal bit for bit, falling and finite, K1/K2 12
   launches a step; a run from SEED + 1 gives other losses; two replays
   of the captured graph draw different dropout masks and a seed before
   each the same ones; step ms, sequences/s, busy ms, idle share, the
   split of busy time and the MLM top-1/top-5 readout (``nd.topk``,
   ``nd.argmax``, ``nd.broadcast_equal``);
7g. nd ops — every operator this slice ports, on the card at BERT-base's
   widths (activations (64, 128, 768), MLM logits (8192, 30522), its
   projection shapes) against the same op on the host in float64, forward
   and first-order gradient (element-wise 1e-6 of the output's largest,
   reductions and products 1e-5, gradients 10 times their family's); the
   second-order cases of ``test_higher_order_grad.py`` at (64, 128, 768);
   the samplers' moments over 1e6 draws; plain PyTorch, no kernel of the
   port, and each line says so;
8. trainer fused — the Trainer's multi-tensor Adam update
   (``torch._foreach_*``, the default) against its per-parameter path at
   BERT-base's widths, on two nets from one seed fed the same gradients:
   3 steps, every weight and Adam moment within 1e-6 of its own largest
   value; ``save_states`` after step 2, a fresh Trainer's
   ``load_states`` and step 3 equal to the uninterrupted run; the update
   alone profiled on each path (device ms, device events, ``_foreach_*``
   calls per step; the fused path must launch fewer kernels than there
   are parameters); then the net cast to bfloat16 with
   ``multi_precision``, 2 fused steps, every weight its fp32 master
   rounded, the loss finite;
8d. bert amp superstep (``[bert-amp-superstep]``) — phase 7f's
   BERT-base pretraining under ``amp.init("bfloat16")`` +
   ``convert_model`` with Adam's fp32 masters, fed from host batches by
   ``gluon.data.SuperstepRing(k=4)`` into ``gluon.Superstep(k=4)``
   (``run``: three supersteps, each ONE captured CUDA graph of four
   iterations, then a tail of two single steps): at dropout 0 a superstep
   against four hybridized ``trainer.step``s (losses 2^-8, fp32 weights
   and masters 1e-5 of their largest; bit for bit expected); over 8 steps
   within (0.08, 0.05) of an fp32 run; K1 and K2 launched in bfloat16
   inside the graph, 48 each; one replay a superstep and no host
   synchronisation in ``step`` (``set_sync_debug_mode("error")``); two
   runs from one seed equal bit for bit; ms a step on the device and the
   host clock, idle share, busy split, peak memory;
8e. checkpoint resume (``[checkpoint-resume]``) — the same net with a
   ``CheckpointManager`` every 4 steps over three supersteps; a fresh net
   and trainer ``load_checkpoint`` step 8 and run superstep 3 again:
   loss, weights, fp32 masters and Adam's m, v and t equal to the
   uninterrupted run's bit for bit; ``verify`` passes on every committed
   step; the checkpoint's bytes, the snapshot's host time in the loop,
   the writer thread's time;
8b. transformer parity — Transformer-base MT at its published widths
   (Vaswani et al. 2017 Table 3 "base": 6 + 6 layers, units 512, hidden
   2048, 8 heads; shared vocabulary 37000; fp32, dropout 0), batch 32 x
   source 128 / target 120: one forward + backward with the kernels
   against one with plain attention (loss 1e-5, gradients 1e-4 of their
   layer's largest), then a ``hybridize()``d net against an eager one
   from the same seed;
8c. transformer train — Adam (beta2 0.98, eps 1e-9, lr 1e-4): one
   warm-up, 10 timed and one profiled step; the loss must fall, K1 launch
   18 times per forward and K2's two kernels 18 each per backward (6
   encoder, 6 decoder causal and 6 cross layers), tallied per shape for
   the Transformer rows of the kernels line; then the same loop on a
   ``hybridize()``d net (``[transformer-train-hybrid]``);
9. resnet parity — ResNet-50 v1 at full width (``bench_resnet``'s
   shapes: batch 128, 224 x 224, 1000 classes, fp32) through
   ``optimize_for("tpu_fused_conv_bn")``: one forward + backward with the
   fused 1x1-conv + BN-statistics kernels (K4 forward, K5 dW and dX),
   every kernel call also held against its plain version on the same
   tensors and each K4 and K5 call against its plain version in float64
   (``k4_calls_vs_float64``, ``k5_calls_vs_float64``); the gradients against a
   run with K5 swapped (here only) for its plain version in float64: no
   farther from it than the run with K5's fp32 plain version, while a run
   with K5 on TF32 products must fall outside (``k5_grad_gate``); the loss
   against a run with K4 and K5 swapped, then the un-fused net on the
   same weights;
10. resnet train — the Gluon loop with ``bench_resnet``'s settings but a
   tenth of its lr (Xavier init, SGD lr 0.005 momentum 0.9 wd 1e-4, see
   ``RESNET_SGD``): one warm-up step, 10 timed
   steps, one profiled step (device time split into cuDNN convs, K4, K5,
   BN and element-wise kernels and the SGD update, which is the fused
   multi-tensor update); the loss must be finite
   and fall, the running statistics move, and K4, K5-dW and K5-dX launch
   30 times per step;
10b. resnet train hybrid — phase 10 on a ``hybridize()``d net: parity
   with an eager net from the same seed (loss and running statistics
   within 1e-5, gradients bit for bit or within K5's float64 gate), one
   recording entry, K4, K5-dW and K5-dX 30 times per step from the
   replays, and the same shape and cast recaptures;
10b'. resnet amp fp16 (``[resnet-amp-fp16]``) — ResNet-50 v1 at batch
   128 under ``amp.init("float16")``, ``convert_model``, ``init_trainer``,
   ``optimize_for`` and ``hybridize()`` (K4/K5 in float16), SGD with fp32
   masters, ``gluon.Superstep(k=2)``: the default scale overflows at
   first and the scaler backs off until two supersteps run clean (the
   supersteps reported); then three supersteps with ``resilience.chaos``
   poisoning slot 0 of the second: that iteration's flag 1, the other
   applied, the scale halved and the overflow total counting it once;
   K4/K5 in float16, 60 of each a replay; ms a step beside fp32's;
10c. nn layers — each layer of the rest of ``gluon.nn`` (the 1-D and 3-D
   convs, the transposed convs, the 1-D and 3-D pools, ReflectionPad2D,
   SyncBatchNorm, InstanceNorm, GroupNorm, LeakyReLU, PReLU, ELU, SELU,
   Swish, Lambda and a captured HybridLambda) at a width users run: one
   forward and backward on the card against the same block loaded from
   its ``.params`` on the host in float64 (NN_LAYER_RTOL); plain PyTorch,
   no kernel of the port, and each line says so;
10d. zoo — each family's canonical net at full width (ZOO_NETS: alexnet,
   vgg16, vgg16_bn, squeezenet1.0/1.1, densenet121, mobilenet1.0,
   mobilenetv2_1.0 at 224 x 224, inceptionv3 at 299 x 299; 1000 classes,
   batch ZOO_BATCH) built with ``get_model``: its parameter count equal to
   the JAX package's (ZOO_PARAMS); an eager and a ``hybridize()``d net
   from one seed, one SGD step each with every Dropout at rate 0, loss
   and gradients equal (bit for bit expected); then with the Dropout
   rates restored, the ms and images/s of an eager and of a replayed step
   and the device's busy ms and idle share of each;
10e. mobilenet parity — MobileNet v1 and MobileNetV2 1.0 at batch 128 x
   224 x 224 through ``optimize_for`` with phase 9's checks (every K4/K5
   call against plain and float64, ``k5_grad_gate`` with its TF32
   control, the loss against plain K4/K5 and the un-fused net): 13 and
   36 K4 calls a forward and as many of K5's two kernels a backward; in
   v2 7 of the K4 calls take a prologue, all with relu off, and the K4
   calls and the prologue calls have MOBILENETV2_1X1's shapes;
10f. mobilenet train — MobileNetV2 1.0 as phase 10 trains ResNet-50
   (MOBILENET_SGD: SGD momentum 0.9, wd 4e-5, the lr where the JAX
   reference's loss falls): one warm-up step, 10 timed steps, one profiled
   step, the device time split (cuDNN convs, the depthwise 3x3s among
   them, K4, K5 dW, K5 dX, BN and element-wise kernels, the SGD update),
   idle share and peak memory; the loss must fall, 36 launches of each of
   K4, K5-dW and K5-dX a step;
10g. mobilenet train hybrid — phase 10b on MobileNetV2 1.0;
10h. data — 1,024 seeded smooth 256 x 256 RGB images with labels in
   0..999, written as JPEG (quality 95) records through ``recordio.pack_img``
   with ``MXIndexedRecordIO`` into a temporary directory.
   ``[data-recordio]``: ``mx.io.ImageRecordIter`` at batch 128,
   ``data_shape=(3, 224, 224)``, random crops and mirrors, ImageNet's
   mean and std, ``preprocess_threads`` the machine's core count: the
   native pipeline where ``cxx/mxtpu_io.cc`` builds (the iterator must be
   ``_NativeImageRecordIter``); where the build fails (a machine without
   libjpeg's and libpng's headers or libraries) the error must name the
   missing codec,
   the iterator without an ``aug_list`` must raise it too, and the phase
   runs the reference's Python route (``aug_list``: ``ImageIter`` behind a
   ``PrefetchingIter``) and says so. A centre-cropped batch equals the
   records decoded and normalised by ``mx.image`` within 1e-5; images/s
   on the host over two epochs with a ``reset()`` between.
   ``[resnet-train-data]``: phase 10b's ResNet-50 (hybridized,
   ``optimize_for``, batch 128, lr 0.005) fed by that iterator through
   ``DevicePrefetcher(device=mx.gpu(), depth=2)`` for 16 steps: a staged
   batch equal to its host batch bit for bit, the host-to-device copies on
   another stream than the step's kernels in a profiled window, K4 and
   K5's two kernels 30 times a step; host-clock step, busy ms, idle share,
   the prefetcher's wait and the bytes staged per step and their copy ms,
   beside the same step on a device-resident batch; the loss must fall.
   ``[data-gluon]``: ``ImageRecordDataset`` + ``transforms.Compose(
   [RandomResizedCrop(224), RandomFlipLeftRight(), ToTensor(),
   Normalize(mean, std)])`` + ``DataLoader(batch_size=128, num_workers=k,
   pin_memory=True, device=mx.gpu())``: images/s over two epochs, then 8
   ResNet-50 steps on it with their idle share; ``[data-gluon-raw]`` the
   same over raw uint8 HWC records read through ``RecordFileDataset`` and
   ``np.frombuffer``. ``[mnist]``: ``examples/train_mnist_gluon.py``'s
   synthetic stand-in through ``DataLoader`` to a hybridized MLP (Dense
   256/128/10), SGD lr 0.02, batch 128, 3 epochs on the card; validation
   accuracy must exceed 0.9;
11. llama parity — Llama-3-8B at its published widths cut to 2 decoder
   layers (meta-llama/Meta-Llama-3-8B ``config.json``: vocab 128256,
   hidden 4096, intermediate 14336, 32 heads over 8 kv heads, rope theta
   500000; 1,486,901,248 parameters, fp32), one sequence of 8192 tokens:
   one forward + backward through the Gluon loop with
   ``MXTPU_FLASH_BWD=fused`` (K6) and again with ``split`` (K2) on the
   same weights; the loss must be equal and every gradient agree;
12. llama train — ``parallel.SPMDTrainStep(mesh=None)`` with Adam (lr
   1e-4) under ``MXTPU_FLASH_BWD=fused``: ``run_steps`` for one warm-up
   step, 10 timed steps and one profiled step (device time split into fp32
   products, K1, K6, element-wise kernels and the Adam update); the loss
   must be finite and fall, K6 launch twice per step and K2 never.

13. distributed — ``[dist-nccl]``: a world of one rank through
   ``kvstore.init_distributed()`` under the launcher's environment contract
   on ``cuda:0``, backend NCCL (its default on a card): NCCL's version,
   ``dist_tpu_sync``'s rank 0 of 1, a barrier, one ``all_reduce`` of a
   64 MiB bucket timed. Then two worker processes of this script
   (``--dist-worker``) share the card in a world of two ranks, backend
   ``DIST_BACKEND`` (gloo: NCCL refuses two ranks on one card,
   ``tools/dist_probe.py``), each with its half (32 x 128) of
   ``[bert-pretrain]``'s global batch of 64 on BERT-base at full width
   (pooler, NSP and MLM heads, 133,547,324 parameters, Normal(0.02) from
   SEED, fp32, dropout 0). ``[dist-bert-trainer]``: ``Trainer(kvstore=
   "dist_tpu_sync")``, Adam lr 1e-4 wd 0.01, 3 steps of the pretraining
   loss; after the first ``allreduce_grads`` both ranks' gradients equal
   bit for bit and each within DIST_GRAD_RTOL of its layer's largest of
   the one-process gradient of the whole batch, and each rank's losses
   within DIST_LOSS_RTOL of the one-process run's on its half (that run,
   3 steps of the same Trainer without a store, made here before the
   world starts, then freed); after 3 steps the parameters equal bit for
   bit across ranks; the losses finite and the last below the first; K1
   and K2's two kernels 12 times a step in each rank. ``[dist-bert-zero]``:
   ``SPMDTrainStep(mesh=make_mesh({"dp": 2}))`` with Adam at ZeRO 0, 2
   and 3 (``overlap="ready"``) and at 0 with ``"barrier"``, 3 steps each:
   stages 2 and 3 equal stage 0 and ``ready`` equals ``barrier``, losses
   and parameters bit for bit; 0/ready's losses within
   DIST_ZERO_LOSS_RTOL and each parameter's update within
   DIST_ZERO_UPDATE_RTOL (norm-wise; the attention's key biases within
   Adam's step bound) of ``SPMDTrainStep(mesh=None)``'s over the whole
   batch (made before the world starts, then freed);
   ``zero_memory_report`` shows stage 2/3's
   optimizer + gradient bytes within 1.05/2 of replicated and stage 3's
   parameter bytes below stage 0's. Each prints its step ms, the
   reduction's ms, bytes and buckets a step, the backend, each rank's
   peak memory and the idle share of a profiled step. A worker that fails
   fails the phase with its output; the world has a hard time limit and
   is killed with its process groups.

Phase 3 also times K1 and K2 in bfloat16 at BERT-base's shape and K4 and
K5 in float16 at ResNet-50's 1x1 shapes (``[kernel-time-lowp]``), the
types of phases 8d and 10b', beside the function's bound in that type
and one library call in it.

Phase 3 also checks K4 and K5's two kernels against their plain versions
(fp32, bf16 and fp16, with and without the BatchNorm prologue, at ResNet-50's
stage shapes, two ragged ones, MobileNetV2 1.0's extremes and
mobilenetv2_0.75's 12 channels), times them at each of ResNet-50's nine
and MobileNetV2 1.0's 21 1x1 shapes (its 7 prologue calls with their
prologue, relu off) beside their bounds, their plain
versions and ``torch.matmul`` of the bare product, and holds K4's three
outputs and K5's four equal over two calls at each of ResNet-50's shapes
(``[determinism]``).

Then one JSON line listing every ported kernel (K1 and K2 also once per
Transformer shape, ``flash_fwd@transformer_enc`` and so on, with the
launches at that shape in phase 8c; K4 and K5 also per MobileNetV2 1.0
step, ``fused_fwd@mobilenetv2_1.0`` and so on, with the launches of phase
10f), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

import collections
import gc
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
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.float16: 989e12}
# the flash kernels (K1, K2, K6) multiply fp32 on the tensor cores as
# 3xTF32: three TF32 products (495 TFLOP/s dense) per product
TF32_TC_OPS, TF32X3 = 495e12, 3
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# kernel vs plain: fp32 differs by summation order only (outputs are
# convex mixes of V rows, |out| < ~5, so ~1e-6); bf16 and fp16 round the
# output once on both sides, so they may differ by one step of the type
# (2^-8 relative in bf16, at most 2^-10 of |value| in fp16)
KERNEL_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2),
              torch.float16: (2.0 ** -10, 2.0 ** -10)}
# flash attention kernels vs plain, relative to the largest |value|: fp32
# differs by summation order only (~3e-6 at T = 2048 measured); bf16 and
# fp16 O and gradients are rounded once on both sides, so they may differ
# by one step of the type (2^-7 of the largest value in bf16, 2^-10 in
# fp16); the LSE is fp32 on both sides
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
             torch.float16: 2.0 ** -10}
# bench_bert on an accelerator: bert_base(dropout=0, no pooler/classifier)
BERT_BATCH, BERT_SEQ, BERT_VOCAB, BERT_LAYERS = 64, 128, 30522, 12
# bench_bert's optimizer, and the fused update against the per-parameter
# one on the same gradients: float32 element-wise updates evaluated in
# another order, each value within 1e-6 of its tensor's largest |value|
BERT_ADAM = {"learning_rate": 1e-4, "wd": 0.01}
FUSED_UPDATE_RTOL = 1e-6
# kernels vs plain attention over a full BERT-base forward + backward in
# fp32, each parameter's gradient relative to the largest |grad| of its
# layer's group (see train_parity_phase)
TRAIN_GRAD_RTOL = 1e-4
# bench_resnet on an accelerator: resnet50_v1 (1000 classes), batch 128 at
# 224 x 224, labels in [0, 10), SGD momentum 0.9 wd 1e-4 at lr 0.005, where
# bench_resnet has 0.05: on this one fixed batch from Xavier init the JAX
# reference's loss swings up to ~71 at 0.05 and ends above its first (at
# 0.01 too), and falls to a third of it at 0.005
# (tools/resnet_loss_trajectory.py, PERF.md)
RESNET_BATCH, RESNET_SIZE = 128, 224
RESNET_SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
RESNET_FUSED = 30  # stride-1 1x1 convs optimize_for marks in ResNet-50 v1
# those convs as (M = N * H * W, K -> N, calls per step) at batch 128
RESNET_1X1 = ((401408, 64, 64, 1), (401408, 64, 256, 4),
              (401408, 256, 64, 2), (100352, 128, 512, 4),
              (100352, 512, 128, 3), (25088, 256, 1024, 6),
              (25088, 1024, 256, 5), (6272, 512, 2048, 3),
              (6272, 2048, 512, 2))
# MobileNet v1 and v2 at multiplier 1.0 (phases 10e-10g) as bench_resnet
# feeds ResNet-50: batch 128 at 224 x 224, labels in [0, 10), fp32; SGD
# momentum 0.9 with Sandler et al. 2018's weight decay 4e-5 (section 6.1;
# their RMSProp is not in the port's path) at bench_resnet's lr 0.05: on
# this seed-0 batch from Xavier init the JAX reference's own loss falls
# over 12 steps from 7.096 to 2.242 at 0.05 (to 3.058 at 0.005)
# (tools/resnet_loss_trajectory.py --model mobilenetv2_1.0, PERF.md)
MOBILENET_BATCH, MOBILENET_SIZE = 128, 224
MOBILENET_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 4e-5}
# stride-1 1x1 convs optimize_for marks: v1's 13 pointwise convs; v2's
# 17 expansions, 17 projections, the 320 -> 1280 conv and the classifier
MOBILENET_FUSED = {"mobilenet1.0": 13, "mobilenetv2_1.0": 36}
# MobileNetV2 1.0's fused convs as (M = N * H * W, K -> N, calls per step,
# of them with a prologue) at batch 128, from the net's own calls (36 in
# 21 shapes, 72.2 GFLOP a forward); the prologue calls, all with relu
# off, are the expansion after each bottleneck without a shortcut (6) and
# the 320 -> 1280 conv; [mobilenet-parity] holds the forward's K4 calls
# and its prologue calls to this table
MOBILENETV2_1X1 = (
    (1605632, 32, 32, 1, 0), (1605632, 32, 16, 1, 0),
    (1605632, 16, 96, 1, 1), (401408, 96, 24, 1, 0),
    (401408, 24, 144, 2, 1), (401408, 144, 24, 1, 0),
    (100352, 144, 32, 1, 0), (100352, 32, 192, 3, 1),
    (100352, 192, 32, 2, 0), (25088, 192, 64, 1, 0),
    (25088, 64, 384, 4, 1), (25088, 384, 64, 3, 0),
    (25088, 384, 96, 1, 0), (25088, 96, 576, 3, 1),
    (25088, 576, 96, 2, 0), (6272, 576, 160, 1, 0),
    (6272, 160, 960, 3, 1), (6272, 960, 160, 2, 0),
    (6272, 960, 320, 1, 0), (6272, 320, 1280, 1, 1),
    (128, 1280, 1000, 1, 0))
MOBILENETV2_PROLOGUE = sum(row[4] for row in MOBILENETV2_1X1)
# the classification zoo (phase 10d): each family's canonical net at full
# width, 1000 classes, batch ZOO_BATCH, at its input size; ZOO_PARAMS are
# the JAX package's parameter counts of the same names, from a CPU run of
# `JAX_PLATFORMS=cpu python tools/zoo_param_counts.py --side jax`
ZOO_BATCH = 32
ZOO_NETS = (("alexnet", 224), ("vgg16", 224), ("vgg16_bn", 224),
            ("squeezenet1.0", 224), ("squeezenet1.1", 224),
            ("densenet121", 224), ("mobilenet1.0", 224),
            ("mobilenetv2_1.0", 224), ("inceptionv3", 299))
ZOO_PARAMS = {"alexnet": 61100840, "vgg16": 138357544,
              "vgg16_bn": 138374440, "squeezenet1.0": 1248424,
              "squeezenet1.1": 1235496, "densenet121": 8062504,
              "mobilenet1.0": 4253864, "mobilenetv2_1.0": 3539136,
              "inceptionv3": 23869000}
# a hybridized net against the eager net from the same seed, one SGD
# step with every Dropout at rate 0: the same kernels in the same order,
# so bit for bit expected; loss 1e-5 relative, each gradient 1e-4 of its
# layer's largest
ZOO_LOSS_RTOL, ZOO_GRAD_RTOL = 1e-5, 1e-4
# each layer of the rest of gluon.nn on the card against the same block
# (same .params) in float64 on the host: float32 sums in another order,
# 1e-5 of each output's largest |value|
NN_LAYER_RTOL = 1e-5
# K4/K5 vs plain, relative to the largest |value| of each output, as
# (storage-type outputs y/dx/dw, fp32 statistics): fp32 differs by
# summation order only (~1e-6 measured over 401408 rows); in bf16 and fp16
# y, dx and dw are rounded once on both sides (one step of the type, 2^-7
# of the largest value in bf16, 2^-10 in fp16) while the statistics stay
# fp32 (order only; 1e-4 leaves room for one 16-bit operand rounded the
# other way)
FUSED_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-4),
             torch.float16: (2.0 ** -10, 1e-4)}
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


# a spin kernel of this many SM cycles (over 0.1 s at the H100's clocks)
# holds the device while the host queues a timed run behind it
QUEUE_SPIN_CYCLES = 200_000_000


def queued_ms(fn, iters):
    """Mean device milliseconds of ``fn()`` over ``iters`` runs queued back
    to back (after one warm-up run): the runs are enqueued behind a spin
    kernel, so the host's launch rate does not set the time, as it would
    in ``cuda_ms`` for calls whose host work outlasts their device work.
    Also the host microseconds each run takes to enqueue; fails if the
    enqueueing outlasted the spin (the queue would have run dry)."""
    fn()
    torch.cuda.synchronize()
    spin0 = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin0.record()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    spin_ms = spin0.elapsed_time(start)
    check(host_ms < spin_ms, f"enqueueing {iters} runs took {host_ms:.1f} ms, "
          f"longer than the {spin_ms:.1f} ms spin ahead of them")
    return start.elapsed_time(end) / iters, host_ms * 1e3 / iters


def sdpa_bwd_ms(qs, ks, vs, g, causal, iters, timer=cuda_ms):
    """Mean device milliseconds of SDPA's backward alone (what ``timer``
    returns): one forward outside the timed calls, then
    ``torch.autograd.grad`` of its output over the kept graph, timed by
    ``timer``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    o = sdpa(qs, ks, vs, is_causal=causal)
    ms = timer(lambda: torch.autograd.grad(o, (qs, ks, vs), g,
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
    used = np.minimum(-(-lens // BLOCK), max_blocks)  # the table's reach
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
    """K3 (its split kernel and its combine kernel, one call) against its
    plain version in every case and storage type, two calls equal bit for
    bit, zeros where the context is empty; head dim 160 through the plain
    route; then timed at the serving slice's shape and at long contexts
    beside their bounds. Returns K3's row and the slice's pools."""
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.flash_attention import (
        _lib,
        _paged_decode_splits,
        _torch_paged_decode,
        paged_decode_attention,
    )

    rs = np.random.RandomState(SEED)
    slice_lens = rs.randint(1, 1100, 8)
    slice_lens[0] = 0  # an empty slot answers zeros
    reach = 512 * BLOCK  # paged_inputs' max_blocks * BLOCK
    nsplit = _paged_decode_splits(
        8, 16, 1, 512, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    cases = {
        "slice": dict(batch=8, heads=16, kv_heads=1, lens=slice_lens),
        "gqa": dict(batch=8, heads=32, kv_heads=8,
                    lens=rs.randint(1, 1100, 8)),
        "one_block": dict(batch=8, heads=16, kv_heads=1,
                          lens=np.full(8, BLOCK)),
        # the split kernel's edges: empty, one position, one pool block, a
        # multiple of nsplit blocks, ragged, the table's reach and past it
        "edges": dict(batch=8, heads=16, kv_heads=1, num_blocks=2048,
                      lens=np.array([0, 1, BLOCK, 10 * nsplit * BLOCK, 777,
                                     reach, reach + 5, 2 * BLOCK + 1])),
    }
    errs = {}
    for name, kw in cases.items():
        for dtype in DTYPES:
            q, kp, vp, tables, lens = paged_inputs(gen, dev, dtype=dtype,
                                                   **kw)
            scale = 1.0 / q.shape[-1] ** 0.5
            got = paged_decode_attention(q, kp[0], vp[0], tables, lens)
            again = paged_decode_attention(q, kp[0], vp[0], tables, lens)
            torch.cuda.synchronize()
            want = _torch_paged_decode(q, kp[0], vp[0], tables, lens, scale)
            diff = (got.float() - want.float()).abs()
            atol, rtol = KERNEL_TOL[dtype]
            ok = bool((diff <= atol + rtol * want.float().abs()).all())
            same = torch.equal(got, again)
            err = float(diff.max())
            errs[(name, dtype)] = err
            say("kernel", case=name, dtype=str(dtype).split(".")[1],
                max_abs_err=f"{err:.3e}", atol=atol, rtol=rtol, ok=ok,
                repeat="equal" if same else "DIFFERS")
            check(ok, f"paged_decode {name} {dtype} disagrees with plain")
            check(same, f"paged_decode {name} {dtype} differs between calls")
            check(bool((got[lens == 0] == 0).all()), "ctx 0 must give zeros")

    # head dim 160: past the kernel's 128 the JAX package runs its jnp
    # path, and the port its plain version on the card, chosen by shape
    q, kp, vp, tables, lens = paged_inputs(gen, dev, dtype=torch.float32,
                                           head_dim=160, **cases["gqa"])
    before = dict(_kernels.LAUNCHES)
    got = paged_decode_attention(q, kp[0], vp[0], tables, lens)
    counts = {k: _kernels.LAUNCHES[k] - before.get(k, 0)
              for k in ("paged_decode", "paged_decode_combine",
                        "paged_decode_plain")}
    same = torch.equal(got, _torch_paged_decode(q, kp[0], vp[0], tables,
                                                lens, 160 ** -0.5))
    say("kernel", case="gqa_d160_plain_route", launches=counts, equal=same)
    check(counts == {"paged_decode": 0, "paged_decode_combine": 0,
                     "paged_decode_plain": 1} and same,
          f"paged decode at head dim 160: {counts}, equal {same}")

    # timing in float32 (the engine's pool type), one pool per layer of the
    # model so every call finds L2 cold as it does in a decode step (24 x 2
    # pools > the 50 MB L2): the serving slice's contexts, then 8 long
    # ones, 4096 to 8192 positions (the table's reach), where the K/V bytes
    # and not the launches set the bound. Each time is a whole call (both
    # kernels and the workspace) on the device, the calls queued back to
    # back; the host's time to enqueue one call is printed beside it.
    layers = STARCODERBASE_1B["num_layers"]
    row, pools = None, None
    for shape, lens_, blocks in (
            ("slice", slice_lens, 1024),
            ("long", np.linspace(4096, reach, 8).astype(np.int32), 3200)):
        q, kp, vp, tables, lens = paged_inputs(
            gen, dev, dtype=torch.float32, layers=layers, batch=8,
            heads=16, kv_heads=1, lens=lens_, num_blocks=blocks)
        scale = 1.0 / q.shape[-1] ** 0.5
        state = {"li": 0}

        def kernel():
            li = state["li"] = (state["li"] + 1) % layers
            paged_decode_attention(q, kp[li], vp[li], tables, lens, scale)

        def plain():
            li = state["li"] = (state["li"] + 1) % layers
            _torch_paged_decode(q, kp[li], vp[li], tables, lens, scale)

        kernel_ms, host_us = queued_ms(kernel, 10 * layers)
        plain_ms = cuda_ms(plain, 2 * layers)
        nbytes, ops = paged_work(q, kp, tables, lens)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[torch.float32] * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        say("kernel-time", kernel="paged_decode",
            shape=f"B8_H16_KVH1_D128_bs16_fp32_{shape}",
            ctx_total=int(lens.sum()), ctx_max=int(lens.max()),
            nsplit=nsplit, split_smem_bytes=_lib()
            .mxtpu_paged_decode_smem_bytes(0, 128), bytes=nbytes,
            ms=f"{kernel_ms:.4f}", host_us_per_call=f"{host_us:.1f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.5f}",
            bound_by=bound_by, bound_share=f"{bound / kernel_ms:.4f}",
            gbytes_per_s=f"{nbytes / kernel_ms / 1e6:.1f}")
        if shape == "slice":
            row = {
                "name": "paged_decode",
                "route": "cuda",
                "source": "mxnet_tpu_torch/csrc/paged_decode.cu",
                "replaces": "mxnet_tpu/ops/flash_attention.py:693",
                "launches": None,  # filled from the serving phase
                "max_abs_err": errs[("slice", torch.float32)],
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes it
            }
            pools = (kp, vp, tables, lens)
        del q, kp, vp, tables, lens
    torch.cuda.empty_cache()
    return row, pools


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
    # Transformer-base MT (TRANSFORMER below) at batch 32, source 128,
    # target 120: the encoder's self-attention, the decoder's causal
    # self-attention and its cross-attention (T != S, T not a multiple of
    # the kernels' 64-row tile)
    "transformer_enc": (32, 8, 8, 128, 128, 64, False, 0, False),
    "transformer_dec_self": (32, 8, 8, 120, 120, 64, True, 0, False),
    "transformer_cross": (32, 8, 8, 120, 128, 64, False, 0, False),
    # BERT-base served by InferenceEngine (SERVE_BUCKETS below, max_batch
    # 8): the buckets under 128, where K1's one key tile is partial
    "bert_serve_32": (8, 12, 12, 32, 32, 64, False, 0, False),
    "bert_serve_64": (8, 12, 12, 64, 64, 64, False, 0, False),
}
# the cases timed beside their bounds, as rows of the kernels line (the
# BERT-base rows keep the kernels' own names), and whether the calls are
# queued behind a spin kernel (``queued_ms``): a Transformer-shape call
# takes the device for less time than the host takes to launch it, so
# ``cuda_ms`` would time the host
FLASH_TIMED = {"bert_base": ("", False),
               "transformer_enc": ("@transformer_enc", True),
               "transformer_dec_self": ("@transformer_dec_self", True),
               "transformer_cross": ("@transformer_cross", True)}


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


def tf32x3_ms(ops):
    """The operations bound of K1, K2, K5 and K6 in ms: 3xTF32 runs each
    product as three TF32 products on the tensor cores."""
    return TF32X3 * ops / TF32_TC_OPS * 1e3


def flash_inputs(gen, dev, B, H, KVH, T, S, D, dtype):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return (randn(B, H, T, D), randn(B, KVH, S, D), randn(B, KVH, S, D),
            randn(B, H, T, D))


def flash_kernel_phase(dev, gen):
    """Every case in fp32, bf16 and fp16: O and the gradients through the
    public autograd op (K1 forward, K2 backward), the LSE from K1 itself,
    and K6's gradients (fed the plain forward's O and LSE), all against
    the plain versions on the same tensors; head dim 160 through the
    plain route. Then each case of FLASH_TIMED timed
    (:func:`flash_time_rows`). Returns the rows of K1 and K2 and the
    errors of every case."""
    from mxnet_tpu_torch.ops.flash_attention import (
        _cuda_flash_bwd_fused,
        _cuda_flash_fwd,
        _torch_flash_bwd,
        _torch_flash_fwd,
        flash_attention,
    )

    from mxnet_tpu_torch.ops import _kernels

    errs = {}
    for name, (B, H, KVH, T, S, D, causal, window, native) in \
            FLASH_CASES.items():
        for dtype in DTYPES:
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

    # head dim 160: past the kernels' 128 the JAX package runs its jnp
    # path, and the port its plain versions on the card, chosen by shape
    B, H, KVH, T, S, D = 2, 4, 2, 256, 256, 160
    q, k, v, g = flash_inputs(gen, dev, B, H, KVH, T, S, D, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(_kernels.LAUNCHES)
    out = flash_attention(*leaves, causal=True)
    out.backward(g)
    counts = {n: _kernels.LAUNCHES[n] - before.get(n, 0) for n in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused",
        "flash_plain_fwd", "flash_plain_bwd")}
    want_o, want_lse = _torch_flash_fwd(q, k, v, 1.0 / D ** 0.5, True)
    want = _torch_flash_bwd(q, k, v, want_o, want_lse, g, 1.0 / D ** 0.5,
                            True)
    rel = max(float((a.detach() - b).abs().max() / b.abs().max())
              for a, b in zip([out] + [t.grad for t in leaves],
                              [want_o, *want]))
    say("kernel", case="flash_gqa2_d160_plain_route",
        shape=f"B{B}_H{H}_KVH{KVH}_T{T}_S{S}_D{D}", launches=counts,
        rel_err=f"{rel:.2e}", tol_rel=FLASH_TOL[torch.float32])
    check(rel <= FLASH_TOL[torch.float32] and counts == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_bwd_fused": 0, "flash_plain_fwd": 1, "flash_plain_bwd": 1},
        f"flash attention at head dim 160: {counts}, rel {rel:.3e}")
    del q, k, v, g, leaves, out, want, want_o, want_lse

    rows = []
    for case, (suffix, queued) in FLASH_TIMED.items():
        rows += flash_time_rows(dev, gen, case, suffix, errs, queued)
        torch.cuda.empty_cache()
    return rows, errs


def flash_time_rows(dev, gen, case, suffix, errs, queued=False):
    """K1 and K2's two kernels at ``case``'s shape in fp32 (the training
    type), each timed beside its bound, its plain version and
    scaled_dot_product_attention (never used by the port; the K2 rows take
    its backward alone, timed after one forward), by CUDA events around
    the calls (``cuda_ms``) or, with ``queued``, around calls queued
    behind a spin kernel (``queued_ms``); and the delta K2's dq kernel
    wrote held against the torch expression. Returns the three rows of
    the kernels line, named with ``suffix``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops.flash_attention import (
        _cuda_flash_bwd,
        _cuda_flash_fwd,
        _torch_flash_bwd,
        _torch_flash_fwd,
    )

    B, H, KVH, T, S, D, causal, window, _ = FLASH_CASES[case]
    timer = (lambda fn, iters: queued_ms(fn, iters)[0]) if queued \
        else cuda_ms
    q, k, v, g = flash_inputs(gen, dev, B, H, KVH, T, S, D, torch.float32)
    scale = D ** -0.5
    out, lse = _cuda_flash_fwd(q, k, v, scale, causal, window)
    plain_o, plain_lse = _torch_flash_fwd(q, k, v, scale, causal, window)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

    def lib_fwd_bwd():
        o = sdpa(qs, ks, vs, is_causal=causal)
        torch.autograd.grad(o, (qs, ks, vs), g)

    # the dk/dv kernel reads the delta the dq kernel wrote (dq is timed
    # first, and every dq call writes it)
    bwd_args = fa._bwd_operands(q, k, v, out, lse, g)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)

    def dq_only():
        fa._launch_flash_bwd("dq", *bwd_args[:-1], delta, bwd_args[-1],
                             (dq,), scale, causal, window)

    def dkv_only():
        fa._launch_flash_bwd("dkv", *bwd_args[:-1], delta, bwd_args[-1],
                             (dk, dv), scale, causal, window)

    times = {
        "flash_fwd": (timer(lambda: _cuda_flash_fwd(
            q, k, v, scale, causal, window), 50),
            timer(lambda: _torch_flash_fwd(q, k, v, scale, causal,
                                             window), 20),
            timer(lambda: sdpa(q, k, v, is_causal=causal), 50)),
    }
    plain_bwd = timer(lambda: _torch_flash_bwd(
        q, k, v, plain_o, plain_lse, g, scale, causal, window), 20)
    lib_fwd_bwd_ms = timer(lib_fwd_bwd, 20)
    lib_bwd = sdpa_bwd_ms(qs, ks, vs, g, causal, 20, timer)
    times["flash_bwd_dq"] = (timer(dq_only, 50), plain_bwd, lib_bwd)
    times["flash_bwd_dkv"] = (timer(dkv_only, 50), plain_bwd, lib_bwd)
    want_delta = (g.float() * out.float()).sum(dim=-1)
    delta_rel = float((delta - want_delta).abs().max()
                      / want_delta.abs().max())
    say("kernel", case=f"flash_bwd_dq_delta{suffix}",
        rel_err=f"{delta_rel:.2e}",
        tol_rel=FLASH_TOL[torch.float32])
    check(delta_rel <= FLASH_TOL[torch.float32],
          f"the delta K2's dq kernel wrote is off by {delta_rel:.3e}")
    both = timer(lambda: _cuda_flash_bwd(q, k, v, out, lse, g, scale,
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
        t_cores = ops / PEAK_OPS[torch.float32] * 1e3
        t_ops = tf32x3_ms(ops)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row = {
            "name": name + suffix,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + (
                "flash_fwd.cu" if name == "flash_fwd" else "flash_bwd.cu"),
            "replaces": replaces[name],
            "launches": None,  # filled from the training phase
            "max_abs_err": max(errs[(case, torch.float32, w)]
                               for w in err_of[name]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        }
        rows.append(row)
        say("kernel-time", kernel=name + suffix,
            shape=f"B{B}_H{H}_T{T}_S{S}_D{D}_causal{int(causal)}_fp32",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{row['bound_ms']:.5f}",
            bound_by=row["bound_by"], tflops=f"{ops / ms / 1e9:.2f}",
            bound_share=f"{row['bound_ms'] / ms:.4f}",
            bound_cuda_cores_ms=f"{t_cores:.5f}")
    say("kernel-time", kernel="flash_bwd_dq+dkv" + suffix,
        ms=f"{both:.4f}",
        library_ms=f"{lib_bwd:.4f}", over_library=f"{both / lib_bwd:.4f}",
        sdpa_fwd_bwd_ms=f"{lib_fwd_bwd_ms:.4f}",
        note='"plain_ms/library_ms of each K2 row are the whole backward"')
    return rows


def determinism_check(case, args):
    """K1's O and LSE, K2's dq, dk and dv and K6's dq, dk and dv must
    repeat bit for bit over two calls on the same tensors."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    q, k, v, _, _, _, scale, causal, window = args
    k1 = [fa._cuda_flash_fwd(q, k, v, scale, causal, window)
          for _ in range(2)]
    k2 = [fa._cuda_flash_bwd(*args) for _ in range(2)]
    k6 = [fa._cuda_flash_bwd_fused(*args) for _ in range(2)]
    torch.cuda.synchronize()
    same = {f"k1_{w}": torch.equal(a, b)
            for w, a, b in zip(("o", "lse"), *k1)}
    same.update({f"k2_{w}": torch.equal(a, b)
                 for w, a, b in zip(("dq", "dk", "dv"), *k2)})
    same.update({f"k6_{w}": torch.equal(a, b)
                 for w, a, b in zip(("dq", "dk", "dv"), *k6)})
    check(all(same.values()), f"flash backward at {case} not repeatable: "
          f"{same}")
    say("determinism", case=case, **{k: "equal" for k in same})


def sass_phase(libs):
    """The flash kernels, K4 and K5 multiply on the tensor cores: count the
    TF32 mma instructions in each library's SASS (``cuobjdump -sass``,
    beside nvcc in the toolkit), and in each of the nine instantiations
    (storage type x prologue mode) of K4's own function, ``fwd_kernel``."""
    import re

    from mxnet_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    for stem in ("flash_fwd", "flash_bwd", "flash_bwd_fused",
                 "fused_conv_bn"):
        sass = subprocess.run([tool, "-sass", libs[stem]], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        n = sass.count("HMMA.1688.F32.TF32")
        say("sass", library=stem, hmma_1688_f32_tf32=n)
        check(n > 0, f"{stem} holds no HMMA.1688.F32.TF32")
        if stem != "fused_conv_bn":
            continue
        # [preamble, name, body, name, body, ...], one body per function
        parts = re.split(r"^\s*Function\s*:\s*(\S+)\s*$", sass, flags=re.M)
        k4 = [body.count("HMMA.1688.F32.TF32")
              for name, body in zip(parts[1::2], parts[2::2])
              if "10fwd_kernel" in name]
        say("sass", library=stem, function="fwd_kernel (K4)",
            instantiations=len(k4), hmma_1688_f32_tf32=sum(k4),
            fewest_in_one=min(k4, default=0))
        check(len(k4) == 9 and min(k4) > 0, f"K4's fwd_kernel: {k4} "
              "HMMA.1688.F32.TF32 in its instantiations, need 9, each > 0")


def kernel_resources_phase():
    """What the runtime reports for each flash kernel at each storage type
    and head-dim bucket, and for K4 and K5's kernels (dW for K >= N and for
    K < N, dX) at each storage type and prologue mode
    (cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    through each source's mxtpu_*_resources)."""
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn
    from mxnet_tpu_torch.ops.flash_attention import _kernel_resources

    for kernel in ("fused_fwd", "fused_dw", "fused_dw_t", "fused_dx"):
        for dtype in DTYPES:
            for mode, (pro, relu) in FUSED_MODES.items():
                r = fcbn._kernel_resources(kernel, dtype, pro, relu)
                check(r["blocks_per_sm"] >= 1, f"{kernel} {dtype} {mode} "
                      f"fits no SM: {r}")
                if dtype == torch.float32:
                    check(r["local_bytes"] == 0 and r["blocks_per_sm"] >= 2,
                          f"{kernel} fp32 {mode} spills or holds fewer than "
                          f"two blocks an SM: {r}")
                say("kernel-resources", kernel=kernel,
                    dtype=str(dtype).split(".")[1], mode=mode, **r,
                    warps_per_sm=r["threads"] // 32 * r["blocks_per_sm"])
    for kernel in ("fwd", "dq", "dkv", "fused"):
        for dtype in DTYPES:
            for bucket in (32, 64, 128):
                r = _kernel_resources(kernel, dtype, bucket)
                name = "flash_fwd" if kernel == "fwd" \
                    else f"flash_bwd_{kernel}"
                check(r["blocks_per_sm"] >= 1, f"{name} {dtype} D{bucket} "
                      f"fits no SM: {r}")
                say("kernel-resources", kernel=name,
                    dtype=str(dtype).split(".")[1], d_bucket=bucket, **r,
                    warps_per_sm=r["threads"] // 32 * r["blocks_per_sm"])


# K6 (and K1 again) are timed at these FLASH_CASES shapes (BERT-base's and
# Llama-3-8B's); the kernels line gets K6 at the last, where the llama
# phases run it
K6_TIME_CASES = ("bert_base", "llama3_8b_causal")


def fused_bwd_time_phase(dev, gen, errs):
    """K6 timed with CUDA events beside K2 (its dq and dk/dv kernels
    together) at the same shapes in fp32, with K6's bound, the plain
    backward, SDPA's backward alone (the row's ``library_ms``) and SDPA
    forward + backward (kv heads repeated before the timed calls: SDPA's
    fused kernels take no grouped heads); and K1 beside its bound, the
    plain forward and SDPA's forward. Each time is a whole wrapper call:
    the outputs (K6's zeroed dq workspace and its torch delta), the
    launch(es). Returns K6's row at the last case."""
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
        determinism_check(case, args)
        k1_ms = cuda_ms(lambda: fa._cuda_flash_fwd(q, k, v, scale, causal,
                                                   window), iters)
        k1_plain_ms = cuda_ms(lambda: fa._torch_flash_fwd(
            q, k, v, scale, causal, window), max(2, iters // 3))
        with torch.no_grad():
            lib_fwd_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=causal),
                                 iters)
        ops, nbytes = flash_work(B, H, KVH, T, S, D, causal, window,
                                 4)["flash_fwd"]
        t_ops, t_bytes = tf32x3_ms(ops), nbytes / HBM_BYTES_PER_S * 1e3
        say("kernel-time", kernel="flash_fwd",
            shape=f"B{B}_H{H}_KVH{KVH}_T{T}_D{D}_causal{int(causal)}_fp32",
            ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}",
            library_ms=f"{lib_fwd_ms:.4f}",
            over_library=f"{k1_ms / lib_fwd_ms:.4f}",
            bound_ms=f"{max(t_ops, t_bytes):.5f}",
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops=f"{ops / k1_ms / 1e9:.2f}",
            bound_share=f"{max(t_ops, t_bytes) / k1_ms:.4f}",
            bound_cuda_cores_ms=f"{ops / PEAK_OPS[torch.float32] * 1e3:.5f}")
        ms = cuda_ms(lambda: fa._cuda_flash_bwd_fused(*args), iters)
        k2_ms = cuda_ms(lambda: fa._cuda_flash_bwd(*args), iters)
        plain_ms = cuda_ms(lambda: fa._torch_flash_bwd(*args),
                           max(2, iters // 3))
        lib_fwd_bwd_ms = cuda_ms(lib_fwd_bwd, max(2, iters // 3))
        lib_ms = sdpa_bwd_ms(qs, ks, vs, g, causal, max(2, iters // 3))
        ops, nbytes = flash_work(B, H, KVH, T, S, D, causal, window,
                                 4)["flash_bwd_fused"]
        t_ops = tf32x3_ms(ops)
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
            k6_over_k2=f"{ms / k2_ms:.4f}",
            k2_over_library=f"{k2_ms / lib_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", sdpa_fwd_bwd_ms=f"{lib_fwd_bwd_ms:.4f}",
            k6_over_library=f"{ms / lib_ms:.4f}",
            bound_ms=f"{row['bound_ms']:.5f}",
            bound_by=row["bound_by"], tflops=f"{ops / ms / 1e9:.2f}",
            bound_share=f"{row['bound_ms'] / ms:.4f}",
            bound_cuda_cores_ms=f"{ops / PEAK_OPS[torch.float32] * 1e3:.5f}")
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
    # MobileNetV2 1.0's extremes at batch 128: its widest M at its
    # narrowest K and N, a stage-4 shape and the classifier (M = batch);
    # and mobilenetv2_0.75's 12 channels (24 bytes a bf16 row, not a
    # multiple of 16) as N and as K
    "mnv2_32_16": (1605632, 32, 16), "mnv2_16_96": (1605632, 16, 96),
    "mnv2_384_96": (25088, 384, 96), "mnv2_1280_1000": (128, 1280, 1000),
    "mnv2_075_24_12": (1605632, 24, 12), "mnv2_075_12_72": (1605632, 12, 72),
}
FUSED_MODES = {"plain": (False, False), "prologue": (True, False),
               "prologue_relu": (True, True)}


# float16 holds values up to 65504: with a prologue, dW's sum over
# 401408 rows of shift x dsum alone reaches ~2.5e5 with these inputs, so
# float16 cases scale the cotangents (dy, dsum, dssq) by 2^-6 as a loss
# scale would (a power of two: the same values, shifted in exponent)
FP16_COTANGENT_SCALE = 2.0 ** -6


def _fused_case_path(name, prologue, relu):
    """The training path a fused case stands for, or None: ResNet-50's
    stage shapes without a prologue; MobileNetV2 1.0's shapes without one
    and with one, relu off."""
    if name.startswith("mnv2_") and "075" not in name:
        return None if relu else "mobilenetv2"
    if name.startswith("stage") and not prologue:
        return "resnet50"
    return None


def fused_inputs(gen, dev, M, K, N, dtype, prologue):
    """x, w, scale, shift (None without a prologue), y, dy, dsum, dssq."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    ct = FP16_COTANGENT_SCALE if dtype == torch.float16 else 1.0
    x, w = randn(M, K).to(dtype), randn(K, N, scale=K ** -0.5).to(dtype)
    s = torch.rand(K, generator=gen, device=dev) + 0.5 if prologue else None
    t = randn(K, scale=0.1) if prologue else None
    return (x, w, s, t, randn(M, N).to(dtype),
            randn(M, N, scale=ct).to(dtype), randn(N, scale=ct),
            randn(N, scale=0.01 * ct))


def fused_kernel_phase(dev, gen):
    """K4 and K5's dW and dX kernels against their plain versions on the
    same tensors, every case in fp32, bf16 and fp16, with no prologue and
    with one (relu off and on). Returns the largest absolute error of each
    kernel in fp32 on the paths' variants: ``{"resnet50": ...}`` over
    ResNet-50's cases without a prologue, ``{"mobilenetv2": ...}`` over
    MobileNetV2 1.0's without one and with one, relu off."""
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    worst = {path: {"fused_fwd": 0.0, "fused_dw": 0.0, "fused_dx": 0.0}
             for path in ("resnet50", "mobilenetv2")}
    for name, (M, K, N) in FUSED_CASES.items():
        for dtype in DTYPES:
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
                        path = _fused_case_path(name, pro, relu)
                        if dtype == torch.float32 and path is not None:
                            worst[path][kernel] = max(worst[path][kernel],
                                                      diff)
                say("fused-kernel", case=name, shape=f"M{M}_K{K}_N{N}",
                    dtype=str(dtype).split(".")[1], mode=mode,
                    rel_err=",".join(f"{k}:{v}" for k, v in facts.items()),
                    tol_rel=f"{lim_t:.3g}/{lim_f:.3g}", ok=True)
                del x, w, y, dy, got, want
    return worst


def fused_work(M, K, N, item=4, prologue=False):
    """Operations (2 M K N) and bytes (each input read once, each output
    written once) of K4 and K5's two kernels. A prologue adds its scale
    and shift (read by all three) and dX's dscale and dbias (written); its
    M K multiply-adds on the CUDA cores, under 1/N of the product's
    operations, are not counted."""
    x, w, mn, vec = M * K * item, K * N * item, M * N * item, 2 * N * 4
    kvec = 2 * K * 4 if prologue else 0
    ops = 2 * M * K * N
    return {"fused_fwd": (ops, x + w + mn + vec + kvec),
            "fused_dw": (ops, x + 2 * mn + vec + w + kvec),
            "fused_dx": (ops, 2 * mn + w + vec + x + 2 * kvec)}


def fused_bound(ops, nbytes):
    """(bound ms, bound by, CUDA cores' operations bound ms) of one call:
    K4 and K5 multiply as 3xTF32 on the tensor cores; the CUDA cores' bound
    (67 TFLOP/s fp32) is printed beside it."""
    t_cores = ops / PEAK_OPS[torch.float32] * 1e3
    t_ops = tf32x3_ms(ops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", t_cores)


def fused_determinism(dev, gen):
    """K4's y, ysum and yssq and K5's dW, dX, dscale and dbias repeat bit
    for bit over two calls at each of ResNet-50's 1x1 shapes (fp32, with
    the prologue and relu, so that every output exists, and without, as
    the training path runs)."""
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    for M, K, N, _ in RESNET_1X1:
        same = {}
        for mode in ("plain", "prologue_relu"):
            pro, relu = FUSED_MODES[mode]
            x, w, s, t, y, dy, ds, dq = fused_inputs(gen, dev, M, K, N,
                                                     torch.float32, pro)
            k4 = [fcbn._cuda_fused_fwd(x, w, s, t, relu) for _ in range(2)]
            runs = [(fcbn._cuda_fused_dw(x, w, y, s, t, dy, ds, dq, relu),)
                    + fcbn._cuda_fused_dx(x, w, y, s, t, dy, ds, dq, relu)
                    for _ in range(2)]
            torch.cuda.synchronize()
            for what, a, b in zip(("y", "ysum", "yssq"), *k4):
                same[f"{mode}_k4_{what}"] = torch.equal(a, b)
            for what, a, b in zip(("dw", "dx", "dscale", "dbias"), *runs):
                if a is not None:
                    same[f"{mode}_k5_{what}"] = torch.equal(a, b)
            del x, w, y, dy, k4, runs
        check(all(same.values()), f"K4/K5 at M{M}_K{K}_N{N} not "
              f"repeatable: {same}")
        say("determinism", case=f"resnet50_1x1_M{M}_K{K}_N{N}_fp32",
            **{k: "equal" for k in same})


def fused_time_phase(dev, gen, worst, table=RESNET_1X1, path="resnet50"):
    """K4, K5-dW and K5-dX timed at each 1x1 shape of a training step
    (``table``: ResNet-50's, whose calls run no prologue, or MobileNetV2
    1.0's with ``path`` "mobilenetv2", whose rows' fifth field counts the
    calls with a prologue, relu off, timed with it; fp32) with CUDA
    events, beside their bounds (on the 3xTF32 route, with the CUDA cores'
    beside it), their plain versions and torch.matmul of the bare product.
    The kernels line gets each kernel's totals over the calls of one
    training step, the bound summed call by call (MobileNetV2's rows named
    ``<kernel>@mobilenetv2_1.0``); ``worst`` is ``fused_kernel_phase``'s."""
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    replaces = {"fused_fwd": "mxnet_tpu/ops/fused_conv_bn.py:105",
                "fused_dw": "mxnet_tpu/ops/fused_conv_bn.py:216",
                "fused_dx": "mxnet_tpu/ops/fused_conv_bn.py:246"}
    total = {k: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "ops": 0, "bytes": 0,
                 "bound": 0.0, "by_bytes": 0.0, "cores": 0.0}
             for k in replaces}
    suffix = "" if path == "resnet50" else "@mobilenetv2_1.0"
    n_calls = sum(row[3] for row in table)
    n_prologue = sum(row[4] for row in table if len(row) > 4)
    variants = []  # (M, K, N, calls, prologue)
    for M, K, N, calls, *pro in table:
        p = pro[0] if pro else 0
        variants += [(M, K, N, c, v) for c, v in ((calls - p, False),
                                                   (p, True)) if c]
    for M, K, N, calls, pro in variants:
        x, w, s, t, y, dy, ds, dq = fused_inputs(gen, dev, M, K, N,
                                                 torch.float32, pro)
        runs = {
            "fused_fwd": (lambda: fcbn._cuda_fused_fwd(x, w, s, t),
                          lambda: fcbn._torch_fused_fwd(x, w, s, t),
                          lambda: torch.matmul(x, w)),
            "fused_dw": (lambda: fcbn._cuda_fused_dw(x, w, y, s, t, dy, ds,
                                                     dq),
                         lambda: fcbn._torch_fused_dw(x, y, s, t, dy, ds, dq,
                                                      False, w.dtype),
                         lambda: torch.matmul(x.t(), dy)),
            "fused_dx": (lambda: fcbn._cuda_fused_dx(x, w, y, s, t, dy, ds,
                                                     dq),
                         lambda: fcbn._torch_fused_dx(x, w, y, s, t, dy, ds,
                                                      dq, False),
                         lambda: torch.matmul(dy, w.t())),
        }
        work = fused_work(M, K, N, prologue=pro)
        label = f"M{M}_K{K}_N{N}_fp32" + ("_prologue_relu_off" if pro
                                          else "")
        for name, (kern, plain, lib) in runs.items():
            ms, plain_ms, lib_ms = (cuda_ms(kern, 20), cuda_ms(plain, 10),
                                    cuda_ms(lib, 20))
            ops, nbytes = work[name]
            bound, by, t_cores = fused_bound(ops, nbytes)
            tot = total[name]
            tot["ms"] += calls * ms
            tot["plain"] += calls * plain_ms
            tot["lib"] += calls * lib_ms
            tot["ops"] += calls * ops
            tot["bytes"] += calls * nbytes
            tot["bound"] += calls * bound
            tot["by_bytes"] += calls * bound * (by == "bytes")
            tot["cores"] += calls * t_cores
            say("kernel-time", kernel=name, shape=label,
                calls_per_step=calls, ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}",
                matmul_product_only_ms=f"{lib_ms:.4f}",
                bound_ms=f"{bound:.5f}", bound_by=by,
                bound_cuda_cores_ms=f"{t_cores:.5f}",
                tflops=f"{ops / ms / 1e9:.2f}",
                bound_share=f"{bound / ms:.4f}")
        del x, w, s, t, y, dy
    rows = []
    for name, tot in total.items():
        rows.append({
            "name": name + suffix,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/fused_conv_bn.cu",
            "replaces": replaces[name],
            "launches": None,  # filled from the path's training phase
            "max_abs_err": worst[path][name],
            "ms": tot["ms"],
            "plain_ms": tot["plain"],
            "bound_ms": tot["bound"],
            # the kind of bound that holds the larger part of the sum
            "bound_by": "bytes" if 2 * tot["by_bytes"] > tot["bound"]
            else "operations",
            # no single PyTorch call computes the product with its
            # statistics; the bare product's time is in the lines above
            "library_ms": None,
        })
        say("kernel-time", kernel=name, shape=f"{path}_step_{n_calls}_calls",
            math='"3xTF32 tensor cores"', prologue_relu_off_calls=n_prologue,
            ms=f"{tot['ms']:.4f}", plain_ms=f"{tot['plain']:.4f}",
            matmul_product_only_ms=f"{tot['lib']:.4f}",
            bound_ms=f"{tot['bound']:.4f}", bound_by=rows[-1]["bound_by"],
            bound_bytes_bound_calls_ms=f"{tot['by_bytes']:.4f}",
            bound_cuda_cores_ms=f"{tot['cores']:.4f}",
            bound_share=f"{tot['bound'] / tot['ms']:.4f}",
            gflop=f"{tot['ops'] / 1e9:.2f}",
            gbytes=f"{tot['bytes'] / 1e9:.3f}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: decode logits against dense logits at full width
# ---------------------------------------------------------------------------

def step_phase(net, pools, kernel_ms):
    """Where a full-width decode step's time goes at the kernel timing's
    shape (8 slots, ragged contexts up to ~1100, 24 cold layer pools):
    the device's time for one step queued behind a spin kernel (one
    step's launches fit the launch queue, two steps' do not), the mean of
    3; CUDA events around 10 steps run as the host issues them (the
    device's time or the host's, whichever is longer: the earlier
    step_dev_ms); the host's time to enqueue a step; and one profiled
    window that splits the device's busy time by kernel and gives its idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    kp, vp, tables, lens = pools
    params, step = net.params(), net.decode_step_fn()
    active = lens > 0
    pos = torch.clamp(lens.long() - 1, min=0)  # context = lens
    token = (pos * 7919) % net.vocab_size

    def run():
        step(params, token, pos, kp, vp, tables, active)

    queued = [queued_ms(run, 1) for _ in range(3)]
    dev_ms = sum(ms for ms, _ in queued) / len(queued)
    enqueue_ms = sum(us for _, us in queued) / len(queued) / 1e3
    events_ms = cuda_ms(run, 10)
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
        step_events_ms=f"{events_ms:.4f}", step_enqueue_ms=f"{enqueue_ms:.4f}",
        paged_decode_ms=f"{net.num_layers * kernel_ms:.4f}",
        paged_decode_share=f"{net.num_layers * kernel_ms / dev_ms:.4f}",
        weights_bound_ms=f"{4 * n_params / HBM_BYTES_PER_S * 1e3:.4f}",
        profiled_busy_ms=f"{busy / reps / 1e3:.4f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}")
    paged = sum(us for name, us in by_name.items() if "paged_decode" in name)
    say("decode-step-k3", k3_ms_per_step=f"{paged / reps / 1e3:.4f}",
        k3_share_of_busy=f"{paged / busy:.4f}")
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
    for name in ("paged_decode", "paged_decode_combine"):
        check(launches[name] == steps * net.num_layers,
              f"parity decode launched {name} {launches[name]} times, "
              f"expected {steps * net.num_layers}")

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
        check(sorted(eng._prefill_graphs) == [256, 1024],
              "the serving engine's prefill is not captured per bucket")
        st0 = eng.stats()
        launches.clear()
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=64, **kw) for p, kw in reqs]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        ttft = np.array([f.token_times()[0] - t0 for f in futs]) * 1e3
        st1 = eng.stats()
        main_launches = launches["paged_decode"]
        combine_launches = launches["paged_decode_combine"]
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
    for name, n in (("paged_decode", main_launches),
                    ("paged_decode_combine", combine_launches)):
        check(n == net.num_layers * steps,
              f"{name} launched {n} times for {steps} decode steps x "
              f"{net.num_layers} layers")
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
        ttft_p50_ms=f"{np.percentile(ttft, 50):.3f}",
        ttft_p99_ms=f"{np.percentile(ttft, 99):.3f}",
        prefills=st1["prefills"] - st0["prefills"], decode_chunks=chunks,
        decode_steps=steps, paged_decode_launches=main_launches,
        paged_decode_combine_launches=combine_launches)
    return main_launches


# ---------------------------------------------------------------------------
# phase 5b: the decode chunk as one CUDA graph; the repository's generation
# engine
# ---------------------------------------------------------------------------

CHUNK_WINDOW = 5  # chunks in each profiled window of [decode-chunk]


def _chunk_window(fn, reps=10, window=CHUNK_WINDOW):
    """Host ms per ``fn()`` (each ends synchronised) over ``reps`` runs,
    then one profiled window of ``window`` runs: its device busy ms per
    run and idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(window):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    busy = sum(_device_us(prof).values())
    check(busy > 0, "the profiler saw no device time")
    return host_ms, busy / window / 1e3, 1 - busy / window_us


def decode_chunk_phase(net, launches):
    """``GenerationEngine``'s decode chunk (8 steps of the 8-slot batch)
    as the ONE CUDA graph its deploy captures. Eight greedy requests
    (prompts of 17-999 tokens) are prefilled into the slots; one replay on
    their static slot buffers must give the eager chunk body's tokens,
    flags and slot state and the same pools after it, bit for bit, and
    launch K3's two kernels once per layer per step (from the replay's
    accounting). Then the chunk on the same inputs, replayed and eager
    (each with its one host-to-device and one device-to-host copy): host
    ms per chunk, device busy ms and the idle share of a profiled window.
    Last, two engines from one seed sample the same tokens when every
    chunk is a replay, and another seed samples others."""
    from mxnet_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(net, shapes=[1024], slots=8, chunk=8,
                           cache_blocks=1024, autostart=False,
                           name="starcoderbase-1b-chunk")
    try:
        check(eng._chunk_graph is not None,
              "the decode chunk was not captured as a CUDA graph")
        graph_counts = dict(eng._chunk_graph.launches)
        rs = np.random.RandomState(SEED + 6)
        for p in rs.randint(17, 1000, eng._slots):
            eng.submit(rs.randint(0, net.vocab_size, p), max_new_tokens=64)
        with eng._on_device():
            eng._admit()
            check(int(eng._active.sum()) == eng._slots,
                  "the chunk's slots were not all seated")
            tables = np.zeros((eng._slots, eng._mb), np.int32)
            for s, table in enumerate(eng._slot_tables):
                eng.cache.ensure(table, int(eng._lens[s]) + eng._chunk)
                tables[s] = table.device_row(eng._mb)
            eng._pack(tables)
            eng._dev_in.copy_(eng._host_in)
            k, v = eng.cache.pools()
            k0, v0 = k.clone(), v.clone()
            launches.clear()
            eng._chunk_graph.replay()
            counts = dict(launches)
            replayed = eng._chunk_out.clone()
            gk, gv = k.clone(), v.clone()
            k.copy_(k0)
            v.copy_(v0)
            eager = eng._chunk_body()
            torch.cuda.synchronize()
            tokens_equal = torch.equal(replayed, eager)
            pools_equal = torch.equal(gk, k) and torch.equal(gv, v)
            del k0, v0, gk, gv

            def replay_chunk():
                eng._dev_in.copy_(eng._host_in, non_blocking=True)
                eng._chunk_graph.replay()
                eng._host_out.copy_(eng._chunk_out, non_blocking=True)
                torch.cuda.current_stream().synchronize()

            def eager_chunk():
                eng._dev_in.copy_(eng._host_in, non_blocking=True)
                eng._chunk_body().cpu()

            replay_dev_ms = cuda_ms(eng._chunk_graph.replay, 10)
            r_host, r_busy, r_idle = _chunk_window(replay_chunk)
            e_host, e_busy, e_idle = _chunk_window(eager_chunk)
    finally:
        eng.close()
    steps = eng._chunk
    say("decode-chunk", slots=eng._slots, chunk=steps,
        equal_eager_tokens=tokens_equal, equal_eager_pools=pools_equal,
        graph_launches=graph_counts, replay_launches=counts,
        replay_device_ms=f"{replay_dev_ms:.4f}",
        replay_host_ms_per_chunk=f"{r_host:.4f}",
        replay_busy_ms_per_chunk=f"{r_busy:.4f}",
        replay_idle_share=f"{r_idle:.4f}",
        eager_host_ms_per_chunk=f"{e_host:.4f}",
        eager_busy_ms_per_chunk=f"{e_busy:.4f}",
        eager_idle_share=f"{e_idle:.4f}",
        replay_ms_per_step=f"{r_host / steps:.4f}",
        eager_ms_per_step=f"{e_host / steps:.4f}")
    check(tokens_equal, "the replayed decode chunk's tokens or slot state "
          "differ from the eager chunk body's")
    check(pools_equal, "the replayed decode chunk left other pools than "
          "the eager chunk body")
    for name in ("paged_decode", "paged_decode_combine"):
        check(counts.get(name) == net.num_layers * steps,
              f"one replay launched {name} {counts.get(name)} times, "
              f"expected {net.num_layers * steps}")

    def sampled(seed):
        e = GenerationEngine(net, shapes=[256], slots=8, chunk=8,
                             cache_blocks=256, seed=seed,
                             name=f"starcoderbase-1b-seed{seed}")
        try:
            r = np.random.RandomState(SEED + 7)
            futs = [e.submit(r.randint(0, net.vocab_size, n),
                             max_new_tokens=24, greedy=False,
                             temperature=1.0, top_k=50, seed=3)
                    for n in (40, 200)]
            return [f.result(timeout=300).tolist() for f in futs]
        finally:
            e.close()

    a, b, c = sampled(5), sampled(5), sampled(6)
    say("decode-chunk-seed", same_seed_equal=a == b,
        other_seed_differs=a != c, tokens=sum(len(t) for t in a))
    check(a == b, "two captured engines from one seed sampled differently")
    check(a != c, "engines from two seeds sampled the same tokens")


def repo_generation_phase(net):
    """StarCoderBase-1B loaded through ``ModelRepository``: the staged load
    builds a ``GenerationEngine`` (its chunk captured) and runs its
    ``canary()``; then one request through the repository."""
    from mxnet_tpu_torch.serving import GenerationEngine, ModelRepository

    repo = ModelRepository()
    try:
        t0 = time.perf_counter()
        eng = repo.load("starcoderbase-1b", net, [256], version="v1",
                        slots=8, chunk=8, cache_blocks=256)
        load_s = time.perf_counter() - t0
        st = repo.stats("starcoderbase-1b")
        toks = repo.predict("starcoderbase-1b",
                            np.arange(1, 33, dtype=np.int32),
                            max_new_tokens=16, timeout=300)
        say("serve-repo-generation", engine=type(eng).__name__,
            load_s=f"{load_s:.3f}", canary_requests=st["requests_ok"],
            captured=eng._chunk_graph is not None, tokens=len(toks))
        check(isinstance(eng, GenerationEngine) and st["requests_ok"] == 1,
              "the repository did not stage a generation engine with its "
              "canary")
        check(len(toks) == 16 and toks.min() >= 0
              and toks.max() < net.vocab_size, "bad tokens through the "
              "repository")
    finally:
        repo.close()


# ---------------------------------------------------------------------------
# phase 5d: the captured prefill
# ---------------------------------------------------------------------------

PREFILL_BUCKETS = [256, 1024]  # the buckets of [serving]'s engine
PREFILL_SEEDS = (1, 2, 3)  # first tokens sampled from these seeds


def prefill_graph_phase(net):
    """Each prompt bucket's prefill as the CUDA graph ``GenerationEngine``
    captures at deploy: for a prompt 7 tokens short of the bucket, the
    engine's own prefill (``_prefill_logits``, which ``_prefill`` runs:
    its packing into the bucket's static buffer, its pool check, one
    replay) against the eager prefill on the same inputs and pools
    (logits, and every pool block but the null block 0 that pad positions
    share), bit for bit; the first token, greedy and sampled from
    PREFILL_SEEDS, equal. Then the device ms of the engine's prefill and
    of the eager one, and the host ms of each from the request's prompt
    to its greedy first token on the host."""
    from mxnet_tpu_torch.serving import GenerationEngine, sample_tokens

    eng = GenerationEngine(net, shapes=PREFILL_BUCKETS, slots=8, chunk=8,
                           cache_blocks=1024, autostart=False,
                           name="starcoderbase-1b-prefill")
    rows = []
    try:
        check(sorted(eng._prefill_graphs) == PREFILL_BUCKETS,
              f"prefill graphs for {sorted(eng._prefill_graphs)}, not "
              f"for every bucket {PREFILL_BUCKETS}")
        check(eng.stats()["compiles"] == 1 + len(PREFILL_BUCKETS),
              "the engine did not count one capture per bucket")
        rs = np.random.RandomState(SEED + 8)
        dev, mb = eng._dev, eng._mb
        with eng._on_device():
            for tb in PREFILL_BUCKETS:
                plen = tb - 7
                prompt = rs.randint(0, net.vocab_size, plen)
                table = eng.cache.allocate(plen)
                row = table.device_row(mb)
                padded = np.zeros((1, tb), np.int64)
                padded[0, :plen] = prompt
                k, v = eng.cache.pools()
                k0, v0 = k.clone(), v.clone()

                def captured():
                    return eng._prefill_logits(prompt, table)

                def eager():
                    return eng._prefill_step(
                        eng._params, dev(padded), k, v, dev(row[None, :]),
                        dev([plen], torch.int32))[0]

                replay = captured().clone()
                gk, gv = k.clone(), v.clone()
                k.copy_(k0)
                v.copy_(v0)
                ref = eager()
                torch.cuda.synchronize()
                logits_equal = torch.equal(replay, ref)
                pools_equal = (torch.equal(gk[:, 1:], k[:, 1:])
                               and torch.equal(gv[:, 1:], v[:, 1:]))
                del k0, v0, gk, gv

                def first(lg, seed):
                    if seed is None:
                        return int(lg.argmax(-1)[0])
                    gen = torch.Generator(device=lg.device).manual_seed(seed)
                    return int(sample_tokens(
                        lg, gen, dev([0.9], torch.float32),
                        dev([50], torch.int32), dev([0.95], torch.float32),
                        dev([False], torch.bool)).cpu()[0])

                firsts = [[first(lg, s) for s in (None,) + PREFILL_SEEDS]
                          for lg in (replay, ref)]
                # the same prompt every time: a host buffer rewritten
                # before the previous copy ran holds the same bytes
                replay_ms = cuda_ms(captured, 10)
                eager_ms = cuda_ms(eager, 10)

                def host_ms(fn, reps=10):
                    fn()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    return (time.perf_counter() - t0) * 1e3 / reps

                r_host = host_ms(
                    lambda: int(captured().argmax(-1).cpu()[0]))
                e_host = host_ms(lambda: int(eager().argmax(-1).cpu()[0]))
                eng.cache.release(table)
                rows.append(dict(bucket=tb, prompt=plen,
                                 logits_equal=logits_equal,
                                 pools_equal=pools_equal,
                                 first_tokens_equal=firsts[0] == firsts[1],
                                 first_tokens=firsts[0],
                                 replay_device_ms=f"{replay_ms:.4f}",
                                 eager_device_ms=f"{eager_ms:.4f}",
                                 replay_host_ms=f"{r_host:.4f}",
                                 eager_host_ms=f"{e_host:.4f}"))
    finally:
        eng.close()
    for r in rows:
        say("prefill-graph", **r)
        check(r["logits_equal"], f"bucket {r['bucket']}: the replayed "
              "prefill's logits differ from the eager prefill's")
        check(r["pools_equal"], f"bucket {r['bucket']}: the replayed "
              "prefill wrote other K/V than the eager prefill")
        check(r["first_tokens_equal"], f"bucket {r['bucket']}: the first "
              "tokens differ between the replayed and the eager prefill")


# ---------------------------------------------------------------------------
# phases 6 and 7: BERT-base training through the Gluon loop
# ---------------------------------------------------------------------------

def bert_setup(ctx, seed=SEED, **cut):
    """BERT-base as bench_bert builds it on an accelerator (``cut``
    overrides widths for a rehearsal on the host), Normal(0.02) weights
    from ``seed`` (SEED), and its fixed batch (ids and labels from numpy
    seed SEED), with deferred shapes resolved by one forward."""
    import mxnet_tpu_torch as mx

    # the position table's own init="normal" draws from the default
    # generator; the rest from the seeded Normal(0.02)
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    net = mx.models.bert_base(dropout=0.0, use_pooler=False,
                              use_classifier=False, **cut)
    net.initialize(init=mx.initializer.Normal(0.02, seed=seed), ctx=ctx)
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


class PlainFlash(torch.autograd.Function):
    """Attention over the plain versions, for the parity phases only."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from mxnet_tpu_torch.ops.flash_attention import _torch_flash_fwd

        out, lse = _torch_flash_fwd(q, k, v, q.shape[-1] ** -0.5, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        from mxnet_tpu_torch.ops.flash_attention import _torch_flash_bwd

        q, k, v, out, lse = ctx.saved_tensors
        return (*_torch_flash_bwd(q, k, v, out, lse, g, q.shape[-1] ** -0.5,
                                  ctx.causal), None)


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


def profiled_loop(step, launches, steps):
    """One warm-up ``step()``, ``steps`` timed steps (host clock around
    synchronised work), one profiled step. Returns the losses, the launch
    counts over exactly these steps, the seconds per timed step, the
    profiled step's device microseconds by kernel name, and its window in
    microseconds on the host clock."""
    from torch.profiler import ProfilerActivity, profile

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
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return [float(v) for v in losses], counts, step_s, by_name, window_us


def say_step_split(tag, by_name, busy, groups=STEP_GROUPS):
    """The profiled step's device time by kind of kernel (``groups``,
    STEP_GROUPS by default) and its eight largest kernels."""
    table = groups
    groups = {}
    for name, us in by_name.items():
        group = next((g for g, keys in table if any(
            k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us
    say(f"{tag}-step-split", **{g: f"{us / 1e3:.3f}ms/{us / busy:.4f}"
                                for g, us in sorted(groups.items(),
                                                    key=lambda kv: -kv[1])})
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"{tag}-step-kernel", ms_per_step=f"{us / 1e3:.4f}",
            share=f"{us / busy:.4f}", name=f'"{name[:90]}"')


def train_phase(net, x, y, launches, steps=10, tag="train"):
    """The Gluon loop of bench_bert: one warm-up step, ``steps`` timed
    steps (host clock around synchronised work), one profiled step, whose
    kernels must include the flash kernels. The launch counts are read
    over exactly these steps. ``tag`` names the printed lines."""
    import mxnet_tpu_torch as mx

    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(BERT_ADAM))

    def step():
        loss = _fwd_bwd(mx, net, x, y)
        trainer.step(BERT_BATCH)
        return loss

    losses, counts, step_s, by_name, window_us = profiled_loop(
        step, launches, steps)
    n_steps = steps + 2
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    flash = sum(us for n, us in by_name.items() if "flash" in n)
    check(flash > 0, f"[{tag}] the profiler saw no flash kernel")
    say(tag, device_steps=n_steps, step_ms=f"{step_s * 1e3:.3f}",
        samples_per_s=f"{BERT_BATCH / step_s:.2f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        reserved_gb=f"{torch.cuda.memory_reserved() / 1e9:.2f}",
        profiled_busy_ms=f"{busy / 1e3:.3f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}",
        flash_share=f"{flash / busy:.4f}",
        flash_fwd=counts.get("flash_fwd", 0),
        flash_bwd_dq=counts.get("flash_bwd_dq", 0),
        flash_bwd_dkv=counts.get("flash_bwd_dkv", 0))
    say_step_split(tag, by_name, busy)
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts.get(name, 0) == BERT_LAYERS * n_steps,
              f"{name} launched {counts.get(name, 0)} times in {n_steps} "
              f"train steps of {BERT_LAYERS} layers")
    return counts


def recapture_checks(tag, block, fwd_bwd, x, y):
    """On a trained hybridized net: a batch of half the size captures a
    second entry, cause ``shape``; a cast of every parameter to float32,
    its own type (new tensors behind the same handles), captures the
    full-batch entry again, cause ``params``, and its loss equals the
    replayed loss on the same weights before the cast."""
    graph = block._cached_graph
    n0 = len(graph.retrace_causes)
    half = x.shape[0] // 2
    loss_half = float(fwd_bwd(x[0:half], y[0:half]))
    shape_causes = graph.retrace_causes[n0:]
    loss_before = float(fwd_bwd(x, y))
    block.cast("float32")
    loss_after = float(fwd_bwd(x, y))
    causes = graph.retrace_causes[n0:]
    entries = list(graph._cache.values())
    rel = abs(loss_after - loss_before) / abs(loss_before)
    say(f"{tag}-recapture", causes=causes, entries=len(entries),
        batches=sorted(k[0][0][0][0] for k in graph._cache),
        loss_half=f"{loss_half:.6f}", loss_before_cast=f"{loss_before:.6f}",
        loss_after_cast=f"{loss_after:.6f}", loss_rel=f"{rel:.3e}",
        bitwise=loss_after == loss_before)
    check(shape_causes == ["shape"], f"a batch of {half} captured with "
          f"causes {shape_causes}, not ['shape']")
    check(causes == ["shape", "params"], f"the cast recaptured with causes "
          f"{causes}, not ['shape', 'params']")
    check(len(entries) == 2 and all(e.graphed and e.recording
                                    for e in entries),
          f"{len(entries)} entries after the shape change and the cast")
    check(np.isfinite(loss_half) and rel <= 1e-5,
          f"the recaptured loss {loss_after} is not the replayed "
          f"{loss_before}")


def _layer_grad_errors(grads, ref):
    """The worst gradient error, each relative to the largest |grad| of
    its layer's group in ``ref`` (the weight and bias of one layer), and
    its parameter; both dicts in the same parameter order."""
    blocks = {}
    for name, g in ref.items():
        block = name.rsplit("_", 1)[0]
        blocks[block] = max(blocks.get(block, 0.0), float(g.abs().max()))
    worst, worst_name = 0.0, ""
    for (name, want), got in zip(ref.items(), grads.values()):
        rel = float((got - want).abs().max()) / max(
            blocks[name.rsplit("_", 1)[0]], 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def train_hybrid_phase(ctx, launches, steps=10, **cut):
    """BERT-base ``hybridize()``d: two nets from the same seed, one eager
    and one hybridized. One forward + backward each (the hybridized one
    captures its forward and backward graphs and replays them): the loss
    within 1e-5 relative and each gradient within TRAIN_GRAD_RTOL of its
    layer's largest, bit for bit expected (the same kernels in the same
    order). Then the Gluon loop on the hybridized net as ``train_phase``
    runs it, every step a replay: one captured recording entry, K1/K2
    once per layer per pass from the replays' launch accounting, the
    flash kernels among the profiled kernels. Then ``recapture_checks``."""
    import mxnet_tpu_torch as mx

    eager, x, y = bert_setup(ctx, **cut)
    net, _, _ = bert_setup(ctx, **cut)
    net.hybridize()
    loss_e = float(_fwd_bwd(mx, eager, x, y))
    grads_e = _grads(eager.collect_params())
    del eager
    loss_h = float(_fwd_bwd(mx, net, x, y))
    grads_h = _grads(net.collect_params())
    worst, worst_name = _layer_grad_errors(grads_h, grads_e)
    bitwise = loss_h == loss_e and all(
        torch.equal(a, b) for a, b in zip(grads_h.values(), grads_e.values()))
    loss_rel = abs(loss_h - loss_e) / abs(loss_e)
    say("train-hybrid-parity", loss_eager=f"{loss_e:.7f}",
        loss_hybrid=f"{loss_h:.7f}", loss_rel=f"{loss_rel:.3e}",
        worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
        tol_rel=TRAIN_GRAD_RTOL, bitwise=bitwise, params=len(grads_e))
    check(np.isfinite(loss_h) and loss_rel <= 1e-5,
          "the hybridized BERT-base loss disagrees with the eager net's")
    check(worst <= TRAIN_GRAD_RTOL, f"hybridized {worst_name} gradient "
          f"disagrees with the eager net's: {worst}")
    del grads_e, grads_h
    torch.cuda.empty_cache()
    counts = train_phase(net, x, y, launches, steps, tag="train-hybrid")
    entries = list(net._cached_graph._cache.values())
    say("train-hybrid-entries", entries=len(entries),
        recording=[e.recording for e in entries],
        graphed=[e.graphed for e in entries],
        replays=[e.gen for e in entries],
        fwd_graph_launches=dict(entries[0]._fwd.launches),
        bwd_graph_launches=dict(entries[0]._bwd.launches))
    check(len(entries) == 1 and entries[0].recording and entries[0].graphed,
          f"{len(entries)} entries captured, not one recording entry")
    recapture_checks("train-hybrid", net,
                     lambda xb, yb: _fwd_bwd(mx, net, xb, yb), x, y)
    return counts


# ---------------------------------------------------------------------------
# phases 7c-7e: .params save/load, warmup and aot_predict_fn on BERT-base
# ---------------------------------------------------------------------------

def _predict(mx, net, *inputs):
    """The predict-mode forward's output tensors."""
    with mx.autograd.predict_mode():
        out = net(*inputs)
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [o.data for o in outs]


def params_header_bytes(net):
    """The NDARRAY_V2 container's bytes besides the parameters' data for
    ``net.save_parameters``: the list header (magic, reserved, count),
    each blob's magic, storage type, ndim, dims, context and type flag,
    and the name list (count, then each name's length and bytes)."""
    params = net._collect_params_with_prefix()
    blobs = sum(4 + 4 + 4 + 4 * len(p.shape) + 8 + 4
                for p in params.values())
    names = 8 + sum(8 + len(k.encode()) for k in params)
    return 24 + blobs + names


def params_phase(trained, x, ctx, **cut):
    """``save_parameters``/``load_parameters`` at BERT-base's widths:

    1. the trained net saved, loaded into a fresh net built from another
       seed: the predict-mode outputs ``torch.equal``;
    2. the same net saved twice: the files equal byte for byte, of the
       parameters' bytes plus the container's header;
    3. loaded into a hybridized net that has already captured a
       predict-mode entry: no new entry (the entry count and
       ``retrace_causes`` unchanged, every handle keeps its tensor), and
       the replay after the load gives the loaded weights' output;
    4. a net cast to bfloat16 saved and loaded into a fresh bfloat16
       net: every parameter and the output equal bit for bit."""
    import tempfile

    import mxnet_tpu_torch as mx

    tmp = tempfile.mkdtemp(prefix="chip_smoke_params_")
    path, again = os.path.join(tmp, "a.params"), os.path.join(tmp, "b.params")
    want = _predict(mx, trained, x)
    t0 = time.perf_counter()
    trained.save_parameters(path)
    save_s = time.perf_counter() - t0
    trained.save_parameters(again)
    size = os.path.getsize(path)
    with open(path, "rb") as f1, open(again, "rb") as f2:
        same_bytes = f1.read() == f2.read()
    data_bytes = sum(p.data().data.numel() * p.data().data.element_size()
                     for p in trained.collect_params().values())
    header = params_header_bytes(trained)

    fresh, _, _ = bert_setup(ctx, seed=SEED + 1, **cut)
    before = _predict(mx, fresh, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load_parameters(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = _predict(mx, fresh, x)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    changed = not all(torch.equal(a, b) for a, b in zip(before, want))
    del fresh, before, got

    hyb, _, _ = bert_setup(ctx, seed=SEED + 2, **cut)
    hyb.hybridize()
    _predict(mx, hyb, x)  # captures the predict-mode entry
    graph = hyb._cached_graph
    entries, causes = len(graph._cache), list(graph.retrace_causes)
    tensors = [p.data().data for p in hyb.collect_params().values()]
    hyb.load_parameters(path)
    replayed = _predict(mx, hyb, x)
    causes_after = list(graph.retrace_causes)
    same_tensors = all(p.data().data is t for p, t in
                       zip(hyb.collect_params().values(), tensors))
    hyb_rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(replayed, want))
    hyb_bitwise = all(torch.equal(a, b) for a, b in zip(replayed, want))
    new_entries = len(graph._cache) - entries
    del hyb, replayed, graph

    trained_bf16 = os.path.join(tmp, "bf16.params")
    src, _, _ = bert_setup(ctx, seed=SEED + 3, **cut)
    src.cast("bfloat16")
    src.save_parameters(trained_bf16)
    dst, _, _ = bert_setup(ctx, seed=SEED + 4, **cut)
    dst.cast("bfloat16")
    dst.load_parameters(trained_bf16)
    bf16_params = all(torch.equal(a.data().data, b.data().data) for a, b in
                      zip(src.collect_params().values(),
                          dst.collect_params().values()))
    bf16_dtypes = {str(p.data().data.dtype)
                   for p in dst.collect_params().values()}
    bf16_out = all(torch.equal(a, b) for a, b in
                   zip(_predict(mx, src, x), _predict(mx, dst, x)))
    bf16_size = os.path.getsize(trained_bf16)
    del src, dst
    for f in (path, again, trained_bf16):
        os.remove(f)
    os.rmdir(tmp)
    say("params", file_bytes=size, param_bytes=data_bytes,
        header_bytes=header, save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}",
        loaded_equal=equal, fresh_net_differed=changed,
        saved_twice_same_bytes=same_bytes,
        hybrid_new_entries=new_entries, hybrid_causes=causes_after,
        hybrid_handles_kept=same_tensors,
        hybrid_replay_rel=f"{hyb_rel:.3e}", hybrid_bitwise=hyb_bitwise,
        bf16_params_equal=bf16_params, bf16_out_equal=bf16_out,
        bf16_dtypes=sorted(bf16_dtypes), bf16_file_bytes=bf16_size)
    check(changed, "the fresh net's output already equalled the trained one")
    check(equal, "the loaded net's output differs from the saved net's")
    check(same_bytes, "two saves of one net differ")
    check(size == data_bytes + header, f"file of {size} bytes, want "
          f"{data_bytes} + {header}")
    check(new_entries == 0 and causes_after == causes and same_tensors,
          f"loading into a hybridized net captured {new_entries} entries "
          f"(causes {causes_after}) or replaced tensors")
    check(hyb_rel <= 1e-6, f"the replay after the load is off by {hyb_rel}")
    check(bf16_params and bf16_out and bf16_dtypes == {"torch.bfloat16"},
          "the bfloat16 net did not round-trip bit for bit")


def warmup_phase(ctx, **cut):
    """``HybridBlock.warmup`` on a hybridized BERT-base with the Adam
    trainer, at the two buckets (64, 64) and (64, 128), on zero ids and
    zero labels (the loss reads the labels of the output's length):

    1. it returns 2;
    2. every weight and gradient buffer equals its value before and each
       handle holds the same tensor object; the Trainer keeps no state of
       the warm-up steps and its update counts are as before;
    3. the first real step at (64, 128) captures no new entry;
    4. after 3 steps the loss and every weight ``torch.equal`` those of a
       net from the same seed that did not warm up (dropout 0);
    5. on that second net, after its steps, a warmup puts its Adam
       states back in place, every state tensor the same object;
    and prints the host seconds to the end of step 1 with and without
    warmup."""
    import mxnet_tpu_torch as mx

    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def mlm_loss(out, label):
        logits = out[-1]
        return sce(logits, label[:, :logits.shape[1]])

    def steps(net, trainer, n):
        losses = []
        for _ in range(n):
            loss = _fwd_bwd(mx, net, x, y)
            trainer.step(BERT_BATCH)
            losses.append(loss)
        return losses

    buckets = [(BERT_BATCH, BERT_SEQ // 2), (BERT_BATCH, BERT_SEQ)]
    warm = dict(dtype="int32", ctx=ctx, loss_fn=mlm_loss,
                label_shape=(BERT_BATCH, BERT_SEQ))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net, x, y = bert_setup(ctx, **cut)
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(BERT_ADAM))
    params = list(net.collect_params().values())
    handles = [(p.data(), p.data().data, p.data().grad.data) for p in params]
    weights = [p.data().data.clone() for p in params]
    grads = [p.data().grad.data.clone() for p in params]
    counts = dict(trainer._optimizer._index_update_count)
    t1 = time.perf_counter()
    n = net.warmup(buckets, trainer=trainer, **warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    graph = net._cached_graph
    entries, causes = len(graph._cache), list(graph.retrace_causes)
    restored = all(torch.equal(p.data().data, w) and
                   torch.equal(p.data().grad.data, g)
                   for p, w, g in zip(params, weights, grads))
    same_objects = all(p.data() is h and p.data().data is t and
                       p.data().grad.data is g
                       for p, (h, t, g) in zip(params, handles))
    no_state = not trainer._fused_states and \
        trainer._optimizer._index_update_count == counts
    first = steps(net, trainer, 1)
    torch.cuda.synchronize()
    to_step1_warm = time.perf_counter() - t0
    step1_entries = len(graph._cache) - entries
    step1_causes = graph.retrace_causes[len(causes):]
    losses = first + steps(net, trainer, 2)
    final = [p.data().data.clone() for p in params]
    losses = [float(v) for v in losses]
    del net, trainer, graph, handles, weights, grads, params
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _, _ = bert_setup(ctx, **cut)
    plain.hybridize()
    ptrainer = mx.gluon.Trainer(plain.collect_params(), "adam",
                                dict(BERT_ADAM))
    pfirst = steps(plain, ptrainer, 1)
    torch.cuda.synchronize()
    to_step1_plain = time.perf_counter() - t0
    plosses = [float(v) for v in pfirst + steps(plain, ptrainer, 2)]
    same_weights = all(torch.equal(a, p.data().data) for a, p in
                       zip(final, plain.collect_params().values()))

    # a warmup over existing Adam states puts them back in place
    states = {k: tuple(st) for k, st in ptrainer._fused_states.items()}
    values = {k: [t.clone() for t in st] for k, st in states.items()}
    plain.warmup(buckets, trainer=ptrainer, **warm)
    states_kept = sorted(ptrainer._fused_states) == sorted(states) and all(
        all(a is b and torch.equal(a, c) for a, b, c in
            zip(ptrainer._fused_states[k], states[k], values[k]))
        for k in states)
    del plain, ptrainer, states, values, final
    gc.collect()
    torch.cuda.empty_cache()
    say("warmup", returned=n, buckets=buckets, warmup_s=f"{warm_s:.3f}",
        entries_after_warmup=entries, weights_grads_restored=restored,
        handles_same_objects=same_objects, trainer_state_restored=no_state,
        step1_new_entries=step1_entries, step1_causes=step1_causes,
        loss_warm=[f"{v:.7f}" for v in losses],
        loss_plain=[f"{v:.7f}" for v in plosses],
        weights_equal=same_weights, adam_states_kept_in_place=states_kept,
        host_s_to_step1_warm=f"{to_step1_warm:.3f}",
        host_s_to_step1_plain=f"{to_step1_plain:.3f}")
    check(n == 2, f"warmup returned {n}")
    check(entries == 2, f"warmup left {entries} entries, not 2")
    check(restored and same_objects and no_state,
          "warmup did not restore the training state in place")
    check(step1_entries == 0 and not step1_causes,
          f"the first step after warmup captured {step1_causes}")
    check(losses == plosses and same_weights,
          f"3 steps after warmup differ from 3 without: {losses} {plosses}")
    check(states_kept, "warmup replaced or changed existing Adam states")


AOT_BATCHES = (8, 32, 64)


def aot_predict_phase(net, launches, ctx, iters=20):
    """``aot_predict_fn`` on BERT-base: its function captured per bucket
    (batch 8, 32, 64 at sequence BERT_SEQ) into a CUDA graph through
    ``gluon._capture.Graph``, with a static input buffer. Each replay
    ``torch.equal`` to the eager predict-mode forward; K1 launches once
    per layer per replay, from the replays' accounting; device ms per
    replay beside the eager forward's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import _capture

    fn, params = net.aot_predict_fn(ctx=ctx)
    rs = np.random.RandomState(SEED + 5)
    for batch in AOT_BATCHES:
        ids = mx.nd.array(rs.randint(0, BERT_VOCAB, (batch, BERT_SEQ)),
                          dtype="int32", ctx=ctx).data
        static = torch.zeros_like(ids)
        _capture.warm_up(lambda: fn(params, static))
        graph = _capture.Graph(torch.cuda.graph_pool_handle(),
                               f"aot_predict_fn at batch {batch}")
        outs = graph.capture(lambda: fn(params, static))
        static.copy_(ids)
        launches.clear()
        graph.replay()
        replay_counts = dict(launches)
        got = [o.clone() for o in outs]
        want = _predict(mx, net, mx.nd.NDArray(ids))
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        replay_ms = cuda_ms(graph.replay, iters)
        eager_ms = cuda_ms(lambda: _predict(mx, net, mx.nd.NDArray(ids)),
                           iters)
        say("aot-predict", batch=batch, seq=BERT_SEQ, equal_eager=equal,
            graph_launches=dict(graph.launches),
            replay_launches=replay_counts, replay_ms=f"{replay_ms:.3f}",
            eager_ms=f"{eager_ms:.3f}", outputs=len(got))
        check(equal, f"the captured aot_predict_fn at batch {batch} differs "
              "from the eager forward")
        check(replay_counts.get("flash_fwd", 0) == BERT_LAYERS,
              f"K1 launched {replay_counts} times in one replay")
        del graph, outs, got, want, static, ids
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7e2-7e3: BERT-base served by InferenceEngine; ModelRepository
# ---------------------------------------------------------------------------

SERVE_BUCKETS = ((32,), (64,), (128,))
SERVE_MAX_BATCH, SERVE_WAIT_MS = 8, 5.0
SERVE_BATCHED, SERVE_SINGLE = 64, 16
REPO_BUCKETS = ((64,), (128,))
REPO_RTOL = 1e-4  # a served row (batch of 8) against the same row alone


def serve_bert_net(ctx, seed=SEED, **cut):
    """BERT-base as the served net: ``bert_base(dropout=0.0,
    use_decoder=False)``, whose outputs are the sequence, the pooled
    vector and the NSP logits; Normal(0.02) weights from ``seed``."""
    import mxnet_tpu_torch as mx

    torch.manual_seed(seed)
    net = mx.models.bert_base(dropout=0.0, use_decoder=False, **cut)
    net.initialize(init=mx.initializer.Normal(0.02, seed=seed), ctx=ctx)
    return net


def _recording_engine(*args, **kwargs):
    """An ``InferenceEngine`` that keeps each dispatched batch (its
    requests, the padded ids and the host outputs), for the checks of
    the serving phases only."""
    from mxnet_tpu_torch.serving import InferenceEngine

    class Recording(InferenceEngine):
        def _execute(self, bucket, reqs):
            self._current = reqs
            super()._execute(bucket, reqs)

        def _run(self, entry, padded):
            host = super()._run(entry, padded)
            self.record.append((list(self._current), padded.copy(),
                                [h.copy() for h in host]))
            return host

    eng = Recording(*args, **kwargs)
    eng.record = []
    return eng


def _served_rows_check(mx, net, eng, ctx):
    """Each dispatched batch's outputs against the eager predict-mode
    forward on the same padded batch (``torch.equal``, every output, the
    pad rows too), and each request's result against its rows of its
    batch; returns the number of batches checked."""
    for reqs, padded, host in eng.record:
        want = _predict(mx, net, mx.nd.array(padded, dtype="int32",
                                             ctx=ctx))
        check(len(want) == len(host) == 3, "the served BERT-base gave "
              f"{len(host)} outputs, expected 3")
        for h, w in zip(host, want):
            check(torch.equal(torch.from_numpy(h), w.cpu()),
                  f"a served batch at bucket {padded.shape[1:]} differs "
                  "from the eager forward on the same padded ids")
        off = 0
        for r in reqs:
            check(np.array_equal(padded[off:off + r.rows], r.payload),
                  "a request's padded ids are not its rows of the batch")
            for got, h in zip(r.result, host):
                check(np.array_equal(got, h[off:off + r.rows]),
                      "a request's result is not its rows of the batch")
            off += r.rows
    return len(eng.record)


def serve_bert_phase(ctx, launches, iters=20, **cut):
    """BERT-base at full width served by ``InferenceEngine`` (buckets 32,
    64, 128; max_batch 8; max_wait 5 ms; int32 ids; one captured CUDA
    graph per bucket): 64 requests of 17-128 ids (a fixed seed) submitted
    together, then 16 one at a time. Every dispatched batch equal to the
    eager forward on the same padded ids (``torch.equal``), each request
    its rows of it, ``compiles`` 3 (flat), K1 12 launches per batch from
    the replays' accounting. Prints requests/s of both parts, the
    engine's p50/p99 (its histogram), the single requests' p50/p99 on the
    host clock, the mean batch fill, and per bucket the replay's device
    ms beside the eager forward's at batch 8."""
    import mxnet_tpu_torch as mx

    layers = cut.get("num_layers", BERT_LAYERS)
    vocab = cut.get("vocab_size", BERT_VOCAB)
    t0 = time.perf_counter()
    net = serve_bert_net(ctx, **cut)
    eng = _recording_engine(net, list(SERVE_BUCKETS), ctx=ctx, dtype="int32",
                            max_batch=SERVE_MAX_BATCH,
                            max_wait_ms=SERVE_WAIT_MS, name="bert-base")
    deploy_s = time.perf_counter() - t0
    try:
        rs = np.random.RandomState(SEED + 8)
        rows = [rs.randint(0, vocab, n).astype(np.int32) for n in
                rs.randint(17, 129, SERVE_BATCHED + SERVE_SINGLE)]
        st0 = eng.stats()
        launches.clear()
        t1 = time.perf_counter()
        futs = [eng.submit(r) for r in rows[:SERVE_BATCHED]]
        for f in futs:
            f.result(timeout=600)
        batched_s = time.perf_counter() - t1
        single_ms = []
        for r in rows[SERVE_BATCHED:]:
            t2 = time.perf_counter()
            eng.predict(r, timeout=600)
            single_ms.append((time.perf_counter() - t2) * 1e3)
        st = eng.stats()
        counts = dict(launches)
        batches = st["batches"] - st0["batches"]
        checked = _served_rows_check(mx, net, eng, ctx)
        replay_ms, eager_ms = {}, {}
        for bucket, entry in sorted(eng._compiled.items()):
            x = mx.nd.array(np.zeros((SERVE_MAX_BATCH,) + bucket), ctx=ctx,
                            dtype="int32")
            if entry.graph is not None:
                replay_ms[bucket[0]] = round(cuda_ms(entry.graph.replay,
                                                     iters), 4)
            eager_ms[bucket[0]] = round(cuda_ms(
                lambda: _predict(mx, net, x), iters), 4)
    finally:
        eng.close()
    say("serve-bert", buckets=[b[0] for b in SERVE_BUCKETS],
        max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
        deploy_s=f"{deploy_s:.3f}", compiles=st["compiles"],
        requests=st["requests_ok"] - st0["requests_ok"], batches=batches,
        batches_checked_equal=checked,
        batched_requests_per_s=f"{SERVE_BATCHED / batched_s:.2f}",
        single_requests_per_s=f"{SERVE_SINGLE / (sum(single_ms) / 1e3):.2f}",
        p50_ms=f"{st['latency_p50_ms']:.3f}",
        p99_ms=f"{st['latency_p99_ms']:.3f}",
        single_p50_ms=f"{float(np.percentile(single_ms, 50)):.3f}",
        single_p99_ms=f"{float(np.percentile(single_ms, 99)):.3f}",
        mean_batch_fill=f"{st['mean_batch_fill']:.4f}",
        flash_fwd_launches=counts.get("flash_fwd", 0),
        replay_ms_by_bucket=replay_ms, eager_ms_by_bucket=eager_ms)
    check(st["requests_ok"] - st0["requests_ok"]
          == SERVE_BATCHED + SERVE_SINGLE, "not every request was served")
    check(st["compiles"] == len(SERVE_BUCKETS), f"compiles {st['compiles']}"
          f", expected one per bucket ({len(SERVE_BUCKETS)})")
    check(checked == batches, f"{checked} batches recorded of {batches}")
    check(counts.get("flash_fwd", 0) == layers * batches,
          f"K1 launched {counts.get('flash_fwd', 0)} times for {batches} "
          f"batches x {layers} layers")
    return counts.get("flash_fwd", 0)


def serve_repo_phase(ctx, **cut):
    """``ModelRepository`` with BERT-base at full width (buckets 64, 128):
    v1 (seed SEED) serves, a client thread sends requests, v2 (seed
    SEED + 1) stages and flips under that traffic; every answer must be
    its reported version's forward on that row alone (REPO_RTOL of the
    output's largest) and far from the other version's. ``rollback``
    captures nothing and launches nothing; a staged v3 whose weights hold
    a NaN is refused by the canary while v1 keeps serving. K1's count
    stays exact though v2 and v3 capture while v1's thread replays: each
    graph holds one launch per layer, and ``LAUNCHES`` gains each graph's
    warm-up run and replays and nothing else."""
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import _capture
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.serving import ModelRepository, StagedLoadError

    vocab = cut.get("vocab_size", BERT_VOCAB)
    rs = np.random.RandomState(SEED + 9)
    rows = [rs.randint(0, vocab, n).astype(np.int32)
            for n in (20, 50, 64, 65, 100, 128)]
    nets = {"v1": serve_bert_net(ctx, SEED, **cut),
            "v2": serve_bert_net(ctx, SEED + 1, **cut)}
    want = {}
    for version, net in nets.items():
        for i, r in enumerate(rows):
            b = next(b for (b,) in REPO_BUCKETS if len(r) <= b)
            padded = np.zeros((1, b), np.int32)
            padded[0, :len(r)] = r
            want[version, i] = [w.cpu().numpy() for w in _predict(
                mx, net, mx.nd.array(padded, dtype="int32", ctx=ctx))]
    layers = cut.get("num_layers", BERT_LAYERS)
    # v3, refused below, built here: anything its set-up launches stays
    # out of the counts
    bad = serve_bert_net(ctx, SEED + 2, **cut)
    _predict(mx, bad, mx.nd.array(np.zeros((1, REPO_BUCKETS[0][0])),
                                  dtype="int32", ctx=ctx))
    captures, replays = [], collections.Counter()
    real_capture, real_replay = _capture.Graph.capture, _capture.Graph.replay

    def counted(self, fn):
        captures.append(self)
        return real_capture(self, fn)

    def counted_replay(self):
        replays[id(self)] += 1
        return real_replay(self)

    engine_kw = dict(ctx=ctx, dtype="int32", max_batch=SERVE_MAX_BATCH,
                     max_wait_ms=SERVE_WAIT_MS)
    repo = ModelRepository(keep=1)
    stop, outcomes, errors = threading.Event(), [], []

    def client():
        i = 0
        while not stop.is_set():
            try:
                fut = repo.submit("bert", rows[i % len(rows)])
                outcomes.append((fut.version, i % len(rows),
                                 fut.result(timeout=120)))
            except BaseException as e:  # noqa: BLE001 - checked below
                errors.append(e)
                return
            i += 1

    _capture.Graph.capture = counted
    _capture.Graph.replay = counted_replay
    thread = threading.Thread(target=client)
    k1_before = _kernels.LAUNCHES["flash_fwd"]
    try:
        t0 = time.perf_counter()
        repo.load("bert", nets["v1"], list(REPO_BUCKETS), version="v1",
                  **engine_kw)
        v1_load_s = time.perf_counter() - t0
        thread.start()
        time.sleep(0.3)
        t1 = time.perf_counter()
        repo.load("bert", nets["v2"], list(REPO_BUCKETS), version="v2",
                  **engine_kw)
        v2_load_s = time.perf_counter() - t1
        time.sleep(0.3)
        n_capt = len(captures)
        t2 = time.perf_counter()
        restored = repo.rollback("bert")
        rollback_ms = (time.perf_counter() - t2) * 1e3
        rollback_captures = len(captures) - n_capt
        time.sleep(0.3)
        with torch.no_grad():  # the pad id's embedding: every row reads it
            bad.word_embed.weight.data().data[0, 0] = float("nan")
        refused = False
        try:
            repo.load("bert", bad, list(REPO_BUCKETS), version="v3",
                      **engine_kw)
        except StagedLoadError:
            refused = True
        live_after = repo.live_version("bert")
        time.sleep(0.2)
    finally:
        stop.set()
        if thread.is_alive():
            thread.join(timeout=300)
        _capture.Graph.capture = real_capture
        _capture.Graph.replay = real_replay
        models = repo.models()
        repo.close()
    k1 = _kernels.LAUNCHES["flash_fwd"] - k1_before
    k1_want = sum((1 + replays[id(g)]) * g.launches["flash_fwd"]
                  for g in captures)
    k1_per_graph = sorted({g.launches["flash_fwd"] for g in captures})
    check(not errors, f"requests failed across the swaps: {errors[:1]!r}")
    worst_own, nearest_other = 0.0, float("inf")
    for version, i, out in outcomes:
        other = "v2" if version == "v1" else "v1"
        for got, mine, theirs in zip(out, want[version, i],
                                     want[other, i]):
            scale = float(np.abs(mine).max())
            worst_own = max(worst_own, float(np.abs(got - mine).max())
                            / scale)
            nearest_other = min(nearest_other, float(
                np.abs(got - theirs).max()) / scale)
    by_version = {v: sum(1 for o in outcomes if o[0] == v)
                  for v in ("v1", "v2")}
    say("serve-repo", requests=len(outcomes), by_version=by_version,
        v1_load_s=f"{v1_load_s:.3f}", v2_load_s=f"{v2_load_s:.3f}",
        rollback_ms=f"{rollback_ms:.3f}", restored=restored.version,
        rollback_captures=rollback_captures, captures=len(captures),
        replays=sum(replays.values()), flash_fwd_launches=k1,
        flash_fwd_per_graph=k1_per_graph, nan_refused=refused,
        live_after_nan=live_after, models=models,
        worst_rel_own_version=f"{worst_own:.3e}",
        nearest_rel_other_version=f"{nearest_other:.3e}",
        tol_rel=REPO_RTOL)
    check(by_version["v1"] > 0 and by_version["v2"] > 0,
          f"traffic did not see both versions: {by_version}")
    check(worst_own <= REPO_RTOL, "a served answer differs from its "
          "version's forward")
    check(nearest_other > 100 * REPO_RTOL, "the two versions' answers "
          "cannot be told apart")
    check(restored.version == "v1" and rollback_captures == 0,
          "rollback captured a graph or restored another version")
    check(refused and live_after == "v1",
          "the NaN version was not refused, or v1 stopped serving")
    check(k1_per_graph == [layers] and k1 == k1_want,
          f"K1 launches across the swaps: {k1}, expected {k1_want} "
          f"({layers} per graph, got {k1_per_graph})")


# ---------------------------------------------------------------------------
# phases 7f-7g: Transformer-base MT (Vaswani et al. 2017), trained
# ---------------------------------------------------------------------------

# "Attention Is All You Need", Table 3 row "base": 6 + 6 layers, d_model
# 512, d_ff 2048, 8 heads; §5.1's shared BPE vocabulary of about 37000
# tokens; the JAX package's max_length 512. Adam with the paper's beta1
# 0.9, beta2 0.98, eps 1e-9 at lr 1e-4. Batch 32 x source 128 / target
# 120 tokens: 4096 + 3840 tokens a step
TRANSFORMER = dict(src_vocab=37000, tgt_vocab=37000, num_layers=6,
                   units=512, hidden_size=2048, num_heads=8, max_length=512)
TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT = 32, 128, 120
TRANSFORMER_ADAM = {"learning_rate": 1e-4, "beta1": 0.9, "beta2": 0.98,
                    "epsilon": 1e-9}


def transformer_setup(ctx, **cut):
    """Transformer-base at its published widths (``cut`` overrides them
    for a rehearsal on the host), Normal(0.02) weights from seed SEED,
    and one fixed batch of source and target tokens and labels from numpy
    seed SEED, with deferred shapes resolved by one forward. Cuts, all
    for parity: dropout 0 (the paper has 0.1), no label smoothing and no
    lr warm-up schedule (the JAX module trains with plain softmax
    cross-entropy), one fixed batch; depth not cut."""
    import mxnet_tpu_torch as mx

    cfg = dict(TRANSFORMER, **cut)
    torch.manual_seed(SEED)  # the position table's own init="normal"
    t0 = time.perf_counter()
    net = mx.models.Transformer(dropout=0.0, **cfg)
    net.initialize(init=mx.initializer.Normal(0.02, seed=SEED), ctx=ctx)
    rs = np.random.RandomState(SEED)
    B, S, T = TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT
    src = mx.nd.array(rs.randint(0, cfg["src_vocab"], (B, S)),
                      dtype="int32", ctx=ctx)
    tgt = mx.nd.array(rs.randint(0, cfg["tgt_vocab"], (B, T)),
                      dtype="int32", ctx=ctx)
    y = mx.nd.array(rs.randint(0, cfg["tgt_vocab"], (B, T))
                    .astype(np.float32), ctx=ctx)
    net(src, tgt)
    mx.nd.waitall()
    n_params = sum(p.data().size for p in net.collect_params().values())
    say("transformer-model", config='"Transformer-base (Vaswani et al. '
        '2017 Table 3 base, vocab 37000)"', params=n_params, batch=B,
        src_len=S, tgt_len=T, dtype="float32",
        init_s=f"{time.perf_counter() - t0:.2f}", ctx=ctx)
    return net, src, tgt, y


def _transformer_fwd_bwd(mx, net, src, tgt, y):
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = sce(net(src, tgt), y)
    loss.backward()
    return loss.data.detach().mean()


def _relu_masks(net, sink):
    """Forward hooks on every ReLU activation block of ``net`` that
    append its output's mask (``out > 0``) to ``sink``; returns the hook
    handles."""
    handles = []

    def hook(block, args, out):
        sink.append(out.data > 0)

    def attach(block):
        if getattr(block, "_act_type", None) == "relu":
            handles.append(block.register_forward_hook(hook))

    net.apply(attach)
    return handles


def _checked_flash_calls(errs):
    """Wrap K1's and K2's launchers so that each call on the path is also
    held against the plain version on the same tensors (the worst error
    relative to the largest |value| kept in ``errs``); returns a function
    that unwraps them."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    fwd, bwd = fa._cuda_flash_fwd, fa._cuda_flash_bwd

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def checked_fwd(q, k, v, scale, causal, window):
        out, lse = fwd(q, k, v, scale, causal, window)
        want = fa._torch_flash_fwd(q, k, v, scale, causal, window)
        errs["k1"] = max(errs.get("k1", 0.0), rel(out, want[0]),
                         rel(lse, want[1]))
        errs["k1_calls"] = errs.get("k1_calls", 0) + 1
        return out, lse

    def checked_bwd(q, k, v, out, lse, g, scale, causal, window):
        grads = bwd(q, k, v, out, lse, g, scale, causal, window)
        want = fa._torch_flash_bwd(q, k, v, out, lse, g, scale, causal,
                                   window)
        errs["k2"] = max([errs.get("k2", 0.0)] + [
            rel(a, b) for a, b in zip(grads, want)])
        errs["k2_calls"] = errs.get("k2_calls", 0) + 1
        return grads

    fa._cuda_flash_fwd, fa._cuda_flash_bwd = checked_fwd, checked_bwd

    def undo():
        fa._cuda_flash_fwd, fa._cuda_flash_bwd = fwd, bwd

    return undo


def transformer_parity_phase(ctx, **cut):
    """Transformer-base with the kernels against attention swapped for
    the plain versions:

    1. one forward + backward with the kernels, every K1 and K2 call also
       held against its plain version on the same tensors (FLASH_TOL),
       then one with ``PlainFlash``: the loss within 1e-5 relative. The
       gradients of these two runs are printed and not gated: the
       decoder's FFN is a ReLU, so a pre-activation within rounding of 0
       takes the other side of the mask when attention sums in another
       order, and each such flip moves its weight's gradient by a whole
       token's term (about 1e-2 of the largest in one layer on the H100,
       no kernel at fault; the flipped masks are counted through forward
       hooks);
    2. one forward with the kernels, then its backward twice over the same
       graph: with K2, and with the plain backward. The masks are the
       same, so every gradient must agree within TRAIN_GRAD_RTOL of its
       layer's largest;
    then a ``hybridize()``d net against an eager one from the same seed,
    bit for bit expected (the same kernels in the same order): loss 1e-5,
    gradients TRAIN_GRAD_RTOL."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import apply
    from mxnet_tpu_torch.ops import flash_attention as fa

    net, src, tgt, y = transformer_setup(ctx, **cut)
    params = net.collect_params()
    masks = {"kernels": [], "plain": []}

    def run(tag):
        handles = _relu_masks(net, masks[tag])
        try:
            loss = float(_transformer_fwd_bwd(mx, net, src, tgt, y))
        finally:
            for h in handles:
                h.detach()
        return loss, _grads(params)

    errs = {}
    undo = _checked_flash_calls(errs)
    try:
        loss_k, grads_k = run("kernels")
    finally:
        undo()
    kernel_op = mx.nd.flash_attention
    mx.nd.flash_attention = lambda q, k, v, causal=False, **kw: apply(
        PlainFlash.apply, q, k, v, causal)
    try:
        loss_p, grads_p = run("plain")
    finally:
        mx.nd.flash_attention = kernel_op
    torch.cuda.synchronize()
    flips = sum(int((a != b).sum()) for a, b in
                zip(masks["kernels"], masks["plain"]))
    units = sum(a.numel() for a in masks["kernels"])
    two_fwd, two_fwd_name = _layer_grad_errors(grads_p, grads_k)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del grads_p, masks

    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(src, tgt), y)
    loss.backward(retain_graph=True)
    grads_k2 = _grads(params)
    repeat = all(torch.equal(a, b) for a, b in zip(grads_k2.values(),
                                                   grads_k.values()))
    kernel_bwd = fa._cuda_flash_bwd
    fa._cuda_flash_bwd = fa._torch_flash_bwd
    try:
        loss.backward()
    finally:
        fa._cuda_flash_bwd = kernel_bwd
    grads_pb = _grads(params)
    worst, worst_name = _layer_grad_errors(grads_pb, grads_k2)
    layers = len(net.encoder)
    k1, k2 = errs.get("k1", float("inf")), errs.get("k2", float("inf"))
    say("transformer-parity", loss_kernels=f"{loss_k:.7f}",
        loss_plain=f"{loss_p:.7f}", loss_rel=f"{loss_rel:.3e}",
        k1_calls=errs.get("k1_calls", 0), k1_worst_rel=f"{k1:.2e}",
        k2_calls=errs.get("k2_calls", 0), k2_worst_rel=f"{k2:.2e}",
        relu_mask_flips=flips, relu_units=units,
        grad_rel_two_forwards=f"{two_fwd:.3e}",
        two_forwards_param=two_fwd_name,
        grad_rel_same_forward=f"{worst:.3e}", worst_param=worst_name,
        tol_rel=TRAIN_GRAD_RTOL, kernel_grads_repeat=repeat,
        params=len(grads_k))
    check(np.isfinite(loss_k) and loss_rel <= 1e-5,
          "[transformer-parity] kernel loss disagrees with plain attention")
    check(errs.get("k1_calls", 0) == 3 * layers
          and errs.get("k2_calls", 0) == 3 * layers,
          f"[transformer-parity] {errs} kernel calls, not {3 * layers} each")
    check(k1 <= FLASH_TOL[torch.float32] and k2 <= FLASH_TOL[torch.float32],
          f"[transformer-parity] a kernel call on the path disagrees with "
          f"its plain version: {errs}")
    check(worst <= TRAIN_GRAD_RTOL, f"[transformer-parity] {worst_name} "
          f"gradient of the plain backward disagrees with K2's: {worst}")
    del net, grads_k, grads_k2, grads_pb, loss
    gc.collect()
    torch.cuda.empty_cache()

    eager, src, tgt, y = transformer_setup(ctx, **cut)
    loss_e = float(_transformer_fwd_bwd(mx, eager, src, tgt, y))
    grads_e = _grads(eager.collect_params())
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    hyb, src, tgt, y = transformer_setup(ctx, **cut)
    hyb.hybridize()
    loss_h = float(_transformer_fwd_bwd(mx, hyb, src, tgt, y))
    grads_h = _grads(hyb.collect_params())
    worst, worst_name = _layer_grad_errors(grads_h, grads_e)
    bitwise = loss_h == loss_e and all(
        torch.equal(a, b) for a, b in zip(grads_h.values(), grads_e.values()))
    loss_rel = abs(loss_h - loss_e) / abs(loss_e)
    entries = list(hyb._cached_graph._cache.values())
    say("transformer-hybrid-parity", loss_eager=f"{loss_e:.7f}",
        loss_hybrid=f"{loss_h:.7f}", loss_rel=f"{loss_rel:.3e}",
        worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
        tol_rel=TRAIN_GRAD_RTOL, bitwise=bitwise, params=len(grads_e),
        entries=len(entries), graphed=[e.graphed for e in entries],
        fwd_graph_launches=dict(entries[0]._fwd.launches)
        if entries and entries[0].graphed else {},
        bwd_graph_launches=dict(entries[0]._bwd.launches)
        if entries and entries[0].graphed else {})
    check(np.isfinite(loss_h) and loss_rel <= 1e-5,
          "the hybridized Transformer's loss disagrees with the eager net's")
    check(worst <= TRAIN_GRAD_RTOL, f"hybridized Transformer {worst_name} "
          f"gradient disagrees with the eager net's: {worst}")
    del hyb, grads_e, grads_h, entries
    gc.collect()
    torch.cuda.empty_cache()


def _flash_shape_tally(tally):
    """Wrap K1's and K2's launchers so that each call is also tallied by
    (kernel, T, S, causal); returns a function that unwraps them. The
    kernels' own ``LAUNCHES`` counts are untouched."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    fwd, bwd = fa._cuda_flash_fwd, fa._launch_flash_bwd

    def tally_fwd(q, k, v, scale, causal, window):
        key = ("flash_fwd", q.shape[2], k.shape[2], bool(causal))
        tally[key] = tally.get(key, 0) + 1
        return fwd(q, k, v, scale, causal, window)

    def tally_bwd(kernel, q, k, *args, **kw):
        causal = args[-2] if len(args) >= 2 else kw.get("causal")
        key = (f"flash_bwd_{kernel}", q.shape[2], k.shape[2], bool(causal))
        tally[key] = tally.get(key, 0) + 1
        return bwd(kernel, q, k, *args, **kw)

    fa._cuda_flash_fwd, fa._launch_flash_bwd = tally_fwd, tally_bwd

    def undo():
        fa._cuda_flash_fwd, fa._launch_flash_bwd = fwd, bwd

    return undo


def transformer_train_phase(ctx, launches, steps=10, hybrid=False, **cut):
    """Transformer-base through the Gluon loop (Adam as the paper's): one
    warm-up step, ``steps`` timed steps, one profiled step. The loss must
    be finite and fall; K1 must launch 18 times per forward and K2's two
    kernels 18 times each per backward (6 encoder self, 6 decoder causal
    self and 6 decoder cross layers), and the flash kernels must be in
    the profile. Returns the launch counts and, per Transformer case of
    FLASH_CASES, the launches of each kernel at its shape, tallied as the
    eager loop calls the launchers. With ``hybrid`` the net is
    ``hybridize()``d and captured by one forward + backward before the
    counted steps (every step a replay of the captured graphs, the counts
    from the replays' accounting, no tally)."""
    import mxnet_tpu_torch as mx

    tag = "transformer-train-hybrid" if hybrid else "transformer-train"
    net, src, tgt, y = transformer_setup(ctx, **cut)
    if hybrid:
        net.hybridize()
        # the entry's capture (and its uncaptured warm-up run) before the
        # counted steps, as train_hybrid_phase's parity call does
        _transformer_fwd_bwd(mx, net, src, tgt, y)
    layers = len(net.encoder)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               dict(TRANSFORMER_ADAM))

    def step():
        loss = _transformer_fwd_bwd(mx, net, src, tgt, y)
        trainer.step(TRANSFORMER_BATCH)
        return loss

    tally = {}
    undo = _flash_shape_tally(tally) if not hybrid else (lambda: None)
    try:
        losses, counts, step_s, by_name, window_us = profiled_loop(
            step, launches, steps)
    finally:
        undo()
    n_steps = steps + 2
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    flash = sum(us for n, us in by_name.items() if "flash" in n)
    B, S, T = TRANSFORMER_BATCH, TRANSFORMER_SRC, TRANSFORMER_TGT
    say(tag, device_steps=n_steps,
        step_ms=f"{step_s * 1e3:.3f}",
        src_tokens_per_s=f"{B * S / step_s:.1f}",
        tgt_tokens_per_s=f"{B * T / step_s:.1f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        reserved_gb=f"{torch.cuda.memory_reserved() / 1e9:.2f}",
        profiled_busy_ms=f"{busy / 1e3:.3f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}",
        flash_share=f"{flash / busy:.4f}",
        flash_fwd=counts.get("flash_fwd", 0),
        flash_bwd_dq=counts.get("flash_bwd_dq", 0),
        flash_bwd_dkv=counts.get("flash_bwd_dkv", 0),
        by_shape={f"{k[0]}:T{k[1]}_S{k[2]}_c{int(k[3])}": v
                  for k, v in sorted(tally.items())})
    say_step_split(tag, by_name, busy)
    check(flash > 0, f"[{tag}] the profiler saw no flash kernel")
    check(all(np.isfinite(losses)), f"non-finite Transformer loss {losses}")
    check(losses[-1] < losses[0], f"Transformer loss did not fall: {losses}")
    per_step = 3 * layers
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts.get(name, 0) == per_step * n_steps,
              f"{name} launched {counts.get(name, 0)} times in {n_steps} "
              f"Transformer steps, not {per_step} per step")
        check(hybrid or sum(v for k, v in tally.items() if k[0] == name)
              == counts.get(name, 0), f"{name}'s shape tally {tally} does "
              "not add up to its launches")
    by_case = {}
    for case in ("transformer_enc", "transformer_dec_self",
                 "transformer_cross"):
        _, _, _, cT, cS, _, causal, _, _ = FLASH_CASES[case]
        by_case[case] = {name: tally.get((name, cT, cS, causal), 0)
                         for name in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")}
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return counts, by_case


# ---------------------------------------------------------------------------
# phase 8: the Trainer's fused multi-tensor update at BERT-base's widths
# ---------------------------------------------------------------------------

def _with_fused(on, fn, *args):
    """``fn(*args)`` with the port's MXTPU_FUSED_STEP switch set to
    ``on``."""
    from mxnet_tpu_torch import fusedstep

    prev = fusedstep.set_enabled(on)
    try:
        return fn(*args)
    finally:
        fusedstep.set_enabled(prev)


def _rel_to_own_max(got, want):
    """max |got - want| over max |want| (0 when both are all zero)."""
    got, want = got.detach(), want.detach()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    return diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf)


def update_profile(trainer, fused, steps=3):
    """Device ms, device events (kernel launches and copies) and
    ``torch._foreach_*`` calls per ``trainer.step`` on its own: the
    gradient buffers keep the last backward's values. One warm-up step,
    then ``steps`` steps in one profiler window."""
    from torch.profiler import ProfilerActivity, profile

    _with_fused(fused, trainer.step, BERT_BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _with_fused(fused, trainer.step, BERT_BATCH)
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    foreach = sum(e.name.startswith("aten::_foreach_") for e in events)
    return (sum(e.time_range.elapsed_us() for e in dev) / steps / 1e3,
            len(dev) / steps, foreach / steps)


def trainer_fused_phase(ctx, **cut):
    """The Trainer's fused Adam update (``MXTPU_FUSED_STEP``, the default)
    against its per-parameter path at BERT-base's widths (bench_bert's
    batch and Adam lr 1e-4 wd 0.01), on two nets built from the same
    seed:

    1. 3 steps of each from the same weights and batch. Each step's
       gradients come from the per-parameter run's forward and backward
       and are written into the fused net's buffers, so the comparison
       sees the update alone (an attention key bias has a zero gradient
       in exact arithmetic, so its float noise, and Adam's normalised
       step on it, would differ between two runs' backward passes).
       Every parameter and both Adam moments within FUSED_UPDATE_RTOL of
       their own largest magnitude;
    2. ``save_states`` after the fused run's step 2, then a fresh Trainer
       on the step-2 weights, ``load_states`` and step 3: its weights
       ``torch.equal`` to the uninterrupted run's;
    3. the update alone, profiled per path: device ms, device events and
       ``_foreach_*`` calls per step; the fused path must launch fewer
       kernels than there are parameters;
    4. the fused net cast to bfloat16 with ``multi_precision``: 2 fused
       steps through its own forward and backward; every weight equal to
       its fp32 master (state leaf 0) rounded to bfloat16, the loss
       finite.
    """
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _kernels

    mx.gluon.block.reset_names()
    net_e, x, y = bert_setup(ctx, **cut)
    mx.gluon.block.reset_names()
    net_f, _, _ = bert_setup(ctx, **cut)
    pe, pf = net_e.collect_params(), net_f.collect_params()
    check(list(pe.keys()) == list(pf.keys()) and all(
        torch.equal(p.data().data, pf[k].data().data)
        for k, p in pe.items()), "two BERT-base nets from one seed differ")
    tr_e = mx.gluon.Trainer(pe, "adam", dict(BERT_ADAM))
    tr_f = mx.gluon.Trainer(pf, "adam", dict(BERT_ADAM))
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR) as tmp:
        fname = os.path.join(tmp, "bert_adam.states")
        for step in range(3):
            _fwd_bwd(mx, net_e, x, y)
            for k, p in pe.items():
                pf[k].grad()._set_data(p.grad())
            _with_fused(False, tr_e.step, BERT_BATCH)
            _with_fused(True, tr_f.step, BERT_BATCH)
            if step == 1:
                tr_f.save_states(fname)
                at_2 = {k: p.data().data.clone() for k, p in pf.items()}
        check(isinstance(tr_f._fused, dict) and tr_e._fused is None
              and not tr_e._fused_states, "the two paths did not run")
        worst = {"param": (0.0, ""), "m": (0.0, ""), "v": (0.0, "")}
        for k, p in pe.items():
            m_e, v_e = (a.data for a in p._opt_state)
            m_f, v_f, t_f = tr_f._fused_states[k]
            check(int(t_f) == tr_e.optimizer._index_update_count[
                tr_e._param2idx[k]] == 3, f"{k}: step leaf {int(t_f)}")
            for what, got, want in (("param", pf[k].data().data,
                                     p.data().data),
                                    ("m", m_f, m_e), ("v", v_f, v_e)):
                rel = _rel_to_own_max(got, want)
                worst[what] = max(worst[what], (rel, k))
        at_3 = {k: p.data().data.clone() for k, p in pf.items()}
        for k, p in pf.items():
            p.data()._set_data(at_2[k])
        tr_r = mx.gluon.Trainer(pf, "adam", dict(BERT_ADAM))
        tr_r.load_states(fname)
        tr_r.step(BERT_BATCH)  # the buffers still hold step 3's gradients
        resumed = [k for k, p in pf.items()
                   if not torch.equal(p.data().data, at_3[k])]
        del at_2, at_3
    eager_ms, eager_ev, _ = update_profile(tr_e, False)
    fused_ms, fused_ev, fused_foreach = update_profile(tr_r, True)
    n_params = len(pf)
    say("trainer-fused", config="BERT-base Adam lr 1e-4 wd 0.01",
        params=n_params, steps=3,
        worst_param_rel=f"{worst['param'][0]:.3e}",
        worst_param=worst["param"][1], worst_m_rel=f"{worst['m'][0]:.3e}",
        worst_v_rel=f"{worst['v'][0]:.3e}", tol_rel=FUSED_UPDATE_RTOL,
        resumed_equal=not resumed,
        update_ms_eager=f"{eager_ms:.4f}",
        update_ms_fused=f"{fused_ms:.4f}",
        device_events_per_step_eager=f"{eager_ev:.1f}",
        device_events_per_step_fused=f"{fused_ev:.1f}",
        foreach_calls_per_step=f"{fused_foreach:.1f}")
    for what, (rel, k) in worst.items():
        check(rel <= FUSED_UPDATE_RTOL,
              f"fused update: {what} of {k} off by {rel:.3e}")
    check(not resumed, f"load_states + step 3 differs at {resumed[:3]}")
    check(fused_ev < n_params, f"the fused update made {fused_ev} device "
          f"events a step for {n_params} parameters")
    del net_e, pe, tr_e, tr_r
    torch.cuda.empty_cache()

    net_f.cast("bfloat16")
    tr_b = mx.gluon.Trainer(pf, "adam",
                            dict(BERT_ADAM, multi_precision=True))
    losses = []
    for _ in range(2):
        losses.append(float(_fwd_bwd(mx, net_f, x, y)))
        tr_b.step(BERT_BATCH)
    check(isinstance(tr_b._fused, dict), "bf16 + multi_precision fell back")
    off = [k for k, p in pf.items() if p.data().data.dtype != torch.bfloat16
           or not torch.equal(p.data().data, tr_b._fused_states[k][0].to(
               torch.bfloat16))]
    masters = {str(tr_b._fused_states[k][0].dtype) for k in pf.keys()}
    say("trainer-fused-bf16", steps=2, loss_first=f"{losses[0]:.5f}",
        loss_last=f"{losses[-1]:.5f}", masters=sorted(masters),
        weights_not_rounded_masters=len(off))
    check(all(np.isfinite(losses)), f"non-finite bf16 loss {losses}")
    check(masters == {"torch.float32"} and not off,
          f"bf16 weights not their rounded fp32 masters: {off[:3]}")
    return {"eager_ms": eager_ms, "fused_ms": fused_ms}


# ---------------------------------------------------------------------------
# phases 9 and 10: ResNet-50 v1 training through optimize_for
# ---------------------------------------------------------------------------

def resnet_setup(ctx, batch=RESNET_BATCH, size=RESNET_SIZE, spec=None,
                 model=None):
    """ResNet-50 v1 as bench_resnet builds it on an accelerator (``spec`` =
    (layers, channels, classes) builds a smaller ResNetV1 for a rehearsal
    on the host; ``model`` names another net of the zoo, built with
    ``get_model(model, classes=1000)`` unless ``spec`` gives its
    ``get_model`` keywords), Xavier weights from seed SEED, and its fixed
    batch (images and labels from numpy seed SEED). Returns the net, its
    ``optimize_for("tpu_fused_conv_bn")`` adapter, the batch, the fused
    convs and a builder of the same architecture."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    def build():
        if model is not None:
            return vision.get_model(model, **(spec or {"classes": 1000}))
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
        want = RESNET_FUSED if model is None else MOBILENET_FUSED[model]
        check(len(marked) == want, f"optimize_for marked {len(marked)} "
              f"convs of {model or 'ResNet-50'}, expected {want}")
    mx.nd.waitall()
    n_params = sum(p.data().size for p in net.collect_params().values())
    config = f"{model} ({spec or '1000 classes'})" if model is not None \
        else "ResNet-50 v1 (resnet50_v1, 1000 classes)" if spec is None \
        else f"ResNetV1{spec}"
    say("resnet-model" if model is None else "mobilenet-model",
        config=config, params=n_params,
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


def k5_grad_gate(kernel_rel, plain_rel, control_rel):
    """ResNet-50's gradient gate on K5. Each argument is a run's worst
    gradient distance to the run with K5 in float64 on the same forward:
    the kernels', K5's fp32 plain version's, and the TF32 control's (K5's
    plain version with float32 products on TF32). The kernel run may be no
    farther from exact arithmetic than the fp32 plain version, with
    RESNET_GRAD_RTOL as the floor; the control must fall outside, or the
    gate could not tell a TF32 kernel from an fp32-accurate one. Returns
    (passes, gate)."""
    gate = max(RESNET_GRAD_RTOL, plain_rel)
    return kernel_rel <= gate and control_rel > gate, gate


def _with_tf32(fn, *args, **kw):
    """``fn(*args, **kw)`` with float32 matmuls on TF32, restored after."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(*args, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _rel(got, ref, scale=None):
    """max |got - ref| relative to max |ref|, or to ``scale`` when given
    (None: 0)."""
    if ref is None:
        return 0.0
    if scale is None:
        scale = float(ref.double().abs().max())
    return float((got.double() - ref.double()).abs().max()) / max(
        scale, 1e-30)


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
    error relative to its largest |value|; each call is also held, with
    its fp32 plain version and the TF32 control (the plain version with
    its float32 products on TF32) beside it, against its plain version
    with the products and sums in float64: ``f64_fwd`` per shape (M, K,
    N), per run, the worst of y, ysum and yssq each; ``f64`` the same for
    K5, the worst of dW and of dX with its statistics. The plain versions
    launch no kernel of the port, so the launch counts stay the main
    path's.

    With ``sums_vs_terms`` (MobileNet's phases) each sum over the M rows
    of terms of both signs, K4's ysum and K5's dW, dscale and dbias, is
    judged against the largest sum of its terms' magnitudes instead of its
    own largest value: where a 1x1 conv reads a BatchNorm's output with
    relu off, as MobileNetV2's do, the rows of its input sum to beta (0 at
    initialisation) and dbias is 0 behind a training-mode BatchNorm, so
    those sums are 0 in exact arithmetic and float noise on every side;
    and dW = xa^T dY sums over the rows a dY whose columns the next
    BatchNorm centres against an xa that relu keeps positive
    (MobileNet v1), so dW is far below its terms."""

    def __init__(self, sums_vs_terms=False):
        from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

        self._fcbn = fcbn
        self.sums_vs_terms = sums_vs_terms
        self.worst = {"fused_fwd": 0.0, "fused_dw": 0.0, "fused_dx": 0.0}
        self.calls = {k: 0 for k in self.worst}
        # K4 calls with a prologue, by whether its relu is on, and by shape
        self.prologue = {"relu_off": 0, "relu_on": 0}
        self.prologue_shapes = {}
        self.f64 = {}
        self.f64_fwd = {}

    def _scales(self, kernel, refs, args):
        """Per output of ``kernel``, the magnitude its error is judged
        against: None for its own largest |value|, else (with
        ``sums_vs_terms``) the largest sum of |terms| of a column sum."""
        none = [None] * len(refs)
        if not self.sums_vs_terms:
            return none
        if kernel == "fused_fwd":  # y, ysum, yssq
            return [None, float(refs[0].double().abs().sum(0).max()), None]
        if kernel == "fused_dw":  # max over (k, n) of sum_m |xa| |dY|
            f = self._fcbn
            x, _, y, scale, shift, dy, dsum, dssq, relu = args
            xa = x.float() if scale is None \
                else f._prologue(x, scale, shift, relu, torch.float32)
            d_y = f._form_dy(y, dy, dsum, dssq, torch.float32, torch.float32)
            return [float(torch.matmul(xa.abs().t(), d_y.abs()).max())]
        if kernel == "fused_dx" and args[3] is not None:  # dx, dscale, dbias
            dxa = refs[0].double() / args[3].double()
            return [None, float((dxa * args[0].double()).abs().sum(0).max()),
                    float(dxa.abs().sum(0).max())]
        return none

    def _note(self, kernel, outs, refs, args):
        self.calls[kernel] += 1
        for g, r, sc in zip(outs, refs, self._scales(kernel, refs, args)):
            if r is not None:
                self.worst[kernel] = max(self.worst[kernel],
                                         _rel(g, r, sc))

    def _note_f64(self, args, runs):
        f = self._fcbn
        exact = f._torch_fused_bwd(*args, exact=True)
        runs["tf32_control"] = _with_tf32(f._torch_fused_bwd, *args)
        shape = (args[0].shape[0], args[0].shape[1], args[1].shape[1])
        rec = self.f64.setdefault(shape, {"calls": 0})
        rec["calls"] += 1
        dx_refs = (exact[0],) + exact[2:]
        scales = {"dw": self._scales("fused_dw", exact[1:2], args),
                  "dx": self._scales("fused_dx", dx_refs, args)}
        for run, (dx, dw, dsc, dbi) in runs.items():
            for out, got, ref in (("dw", (dw,), exact[1:2]),
                                  ("dx", (dx, dsc, dbi), dx_refs)):
                key = f"{run}_{out}"
                rec[key] = max([rec.get(key, 0.0)] + [
                    _rel(g, r, sc) for g, r, sc in zip(got, ref, scales[out])
                    if r is not None])

    def _note_f64_fwd(self, args, runs):
        f = self._fcbn
        exact = f._torch_fused_fwd(*args, exact=True)
        runs["tf32_control"] = _with_tf32(f._torch_fused_fwd, *args)
        shape = (args[0].shape[0], args[0].shape[1], args[1].shape[1])
        rec = self.f64_fwd.setdefault(shape, {"calls": 0})
        rec["calls"] += 1
        scales = self._scales("fused_fwd", exact, args)
        for run, outs in runs.items():
            for out, got, ref, sc in zip(("y", "ysum", "yssq"), outs, exact,
                                         scales):
                key = f"{run}_{out}"
                rec[key] = max(rec.get(key, 0.0), _rel(got, ref, sc))

    def __enter__(self):
        f = self._fcbn
        self._saved = (f._fused_fwd, f._fused_bwd)
        fwd, bwd = self._saved

        def fwd_checked(*args):
            if args[2] is not None:
                self.prologue["relu_on" if args[4] else "relu_off"] += 1
                shape = (args[0].shape[0], args[0].shape[1],
                         args[1].shape[1])
                self.prologue_shapes[shape] = \
                    self.prologue_shapes.get(shape, 0) + 1
            out = fwd(*args)
            plain = f._torch_fused_fwd(*args)
            self._note("fused_fwd", out, plain, args)
            self._note_f64_fwd(args, {"kernel": out, "plain_fp32": plain})
            return out

        def bwd_checked(*args):
            dx, dw, dsc, dbi = bwd(*args)
            rdx, rdw, rsc, rbi = f._torch_fused_bwd(*args)
            self._note("fused_dw", (dw,), (rdw,), args)
            self._note("fused_dx", (dx, dsc, dbi), (rdx, rsc, rbi), args)
            self._note_f64(args, {"kernel": (dx, dw, dsc, dbi),
                                  "plain_fp32": (rdx, rdw, rsc, rbi)})
            return dx, dw, dsc, dbi

        f._fused_fwd, f._fused_bwd = fwd_checked, bwd_checked
        return self

    def __exit__(self, *exc):
        self._fcbn._fused_fwd, self._fcbn._fused_bwd = self._saved
        return False


def _f64_report(check_name, records, tag="resnet-parity"):
    """Print each shape's record of a ``_CheckedCalls`` float64 check and
    return them merged: the calls summed, every distance its worst."""
    every = {"calls": 0}
    for (M, K, N), rec in sorted(records.items()):
        say(tag, check=check_name, shape=f"M{M}_K{K}_N{N}",
            calls=rec["calls"],
            **{k: f"{rec[k]:.3e}" for k in rec if k != "calls"})
        for k, v in rec.items():
            every[k] = every.get(k, 0) + v if k == "calls" \
                else max(every.get(k, 0.0), v)
    return every


def _swapped_ops(forward, exact=False, tf32=False):
    """``nd`` operators for ``_contrib_fused_matmul_stats`` and
    ``_contrib_fused_scaled_matmul_stats`` whose forward is ``forward(x,
    w, scale, shift, relu)`` and whose backward is K5's plain version
    (``exact``: its products and sums in float64, outputs cast back to
    fp32; ``tf32``: its float32 products on TF32, the gate's control)."""
    from mxnet_tpu_torch.ndarray.ndarray import apply
    from mxnet_tpu_torch.ops.fused_conv_bn import _torch_fused_bwd

    class Swapped(torch.autograd.Function):
        @staticmethod
        def forward(ctx_, a, scale, shift, w, relu):
            out = forward(a, w, scale, shift, relu)
            ctx_.save_for_backward(a, scale, shift, w, out[0])
            ctx_.relu = relu
            return out

        @staticmethod
        def backward(ctx_, dy, dsum, dssq):
            a, scale, shift, w, out = ctx_.saved_tensors
            args = (a, w, out, scale, shift, dy, dsum, dssq, ctx_.relu)
            dx, dw, dsc, dbi = _with_tf32(_torch_fused_bwd, *args) if tf32 \
                else _torch_fused_bwd(*args, exact=exact)
            if scale is not None:
                dsc, dbi = dsc.to(scale.dtype), dbi.to(shift.dtype)
            return dx, dsc, dbi, dw, None

    return {"_contrib_fused_matmul_stats": lambda a, w: apply(
                Swapped.apply, a, None, None, w, False),
            "_contrib_fused_scaled_matmul_stats":
                lambda a, scale, shift, w, relu=True: apply(
                    Swapped.apply, a, scale, shift, w, bool(relu))}


def _conv_bias_noise(grads):
    """The conv biases before a training-mode BatchNorm: their gradient is
    zero in exact arithmetic, float noise on both sides, judged against
    their conv's weight gradient."""
    return {k for k in grads if "conv2d" in k and k.endswith("_bias")}


def _worst_vs(grads, ref, noise):
    """``_grad_errors`` with each of ``noise`` judged against its conv's
    weight gradient."""
    worst, worst_name = _grad_errors(grads, ref, noise)
    for k in noise:
        w = k[:-len("bias")] + "weight"
        rel = float((grads[k] - ref[k]).abs().max()) / max(
            float(ref[w].abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, k
    return worst, worst_name


def _layer_l2(grads, ref):
    """The worst layer's gradient distance, ``|g - ref| / |ref|`` in the
    L2 norm over the layer's parameters (a conv's weight and bias, a
    BatchNorm's gamma and beta), and that layer: MobileNet's gradient
    gate. At Xavier init MobileNet's single gradient elements are noise:
    on MobileNet 1.0 at batch 128 the stem BatchNorm's beta moves 9.1e-3
    of its gamma's largest between K5's fp32 plain version and float64
    (cuBLAS's rounding alone), while each layer's gradient as a whole is
    fixed to 1.3e-5 by fp32 arithmetic and TF32 moves it 1.3e-3."""
    layers = {}
    for name, want in ref.items():
        layer = name.rsplit("_", 1)[0]
        diff, norm = layers.get(layer, (0.0, 0.0))
        layers[layer] = (diff + float((grads[name].double()
                                       - want.double()).pow(2).sum()),
                         norm + float(want.double().pow(2).sum()))
    worst, worst_name = 0.0, ""
    for layer, (diff, norm) in layers.items():
        rel = (diff / max(norm, 1e-300)) ** 0.5
        if rel > worst:
            worst, worst_name = rel, layer
    return worst, worst_name


def _swapped_run(mx, fused, x, y, ops, expect, launches):
    """One step with ``ops`` (``_swapped_ops``) in place of the fused
    operators; the kernels launched must be ``expect``. Returns the
    loss."""
    kernel_ops = {name: getattr(mx.nd, name) for name in ops}
    for name, op in ops.items():
        setattr(mx.nd, name, op)
    launches.clear()
    try:
        loss = float(_resnet_fwd_bwd(mx, fused, x, y))
    finally:
        for name, op in kernel_ops.items():
            setattr(mx.nd, name, op)
    got = {k: v for k, v in launches.items() if v}
    check(got == expect, f"the swapped run launched {got}, not {expect}")
    return loss


def k5_anchor_runs(mx, net, fused, x, y, launches, n):
    """The gradient gate's runs on the eager net: one step each with K5
    swapped for its plain version in fp32, in float64 and on TF32 (K4
    kept, so each sees the kernel run's forward): ``{run: (loss,
    grads)}``."""
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    k4 = fcbn._fused_fwd
    params = net.collect_params()
    return {run: (_swapped_run(mx, fused, x, y, ops, {"fused_fwd": n},
                               launches), _grads(params))
            for run, ops in (("plain_fp32", _swapped_ops(k4)),
                             ("float64", _swapped_ops(k4, exact=True)),
                             ("tf32_control", _swapped_ops(k4, tf32=True)))}


def resnet_parity_phase(net, fused, x, y, marked, build, launches, ctx,
                        tag="resnet-parity", prologue=None, table=None,
                        sums_vs_terms=False, grad_dist=None):
    """ResNet-50 through optimize_for with the kernels against the same
    net with K4/K5 swapped, in this script only, for their plain versions,
    and against the un-fused net, all in training mode with cuDNN's
    deterministic algorithms.

    - Every K4/K5 call of the kernel run is also held against its plain
      version on the same tensors (FUSED_TOL), and each K5 call against
      K5's plain version with the products and sums in float64, within
      FUSED_TOL of the largest value, the fp32 plain version's and the TF32
      control's distances printed beside it (the control must fall
      outside); each K4 call likewise against K4's plain version in
      float64, for y, ysum and yssq.
    - Gradients (k5_grad_gate): runs with K5 swapped for its plain version
      in float64, in fp32 and on TF32 (K4 kept, so every backward pass
      sees the same forward activations and the loss is the same); the
      kernel run must be no farther from the float64 run than the fp32
      plain version is, RESNET_GRAD_RTOL at least, each weight's gradient
      relative to its own largest |grad|, and the TF32 control must fail
      that gate. The kernel run against the fp32 plain version is printed:
      it measures summation order (bit-equal only for a kernel that adds
      in cuBLAS's order). With K4 swapped too the forward rounds
      otherwise, and at Xavier init this net's training-mode gradient is
      chaotic at fp32
      rounding: every relu that a rounding moves across zero changes the
      backward, and BatchNorm's backward leaves a small residual of large
      cancelling terms. That run's gradient difference is printed beside
      ``chaos_floor``, the kernel run against itself with its input moved
      by one rounding.
    - Losses: with K4/K5 swapped, within RESNET_LOSS_RTOL; the un-fused
      net, within UNFUSED_LOSS_RTOL (its gradient difference printed).

    MobileNet's phases run the same checks (``tag`` names the lines): with
    ``prologue`` the K4 calls with a prologue must be that many, all with
    relu off, and with ``table`` ((M, K, N, calls, prologue calls), ...)
    the K4 calls of the forward, and those with a prologue, must have
    exactly those shapes and counts;
    ``sums_vs_terms`` is ``_CheckedCalls``', and ``grad_dist(grads, ref)``
    measures the gradient gate's distances (``_layer_l2``; by default the
    worst element, each against its own largest |grad|, a conv bias before
    a BatchNorm against its weight's)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    params = net.collect_params()
    n = len(marked)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches.clear()
        with _CheckedCalls(sums_vs_terms) as calls:
            loss_k = float(_resnet_fwd_bwd(mx, fused, x, y))
        counts = dict(launches)
        lim = FUSED_TOL[torch.float32][0]
        say(tag, check="every_call_vs_plain",
            calls=calls.calls, k4_prologue_calls=calls.prologue,
            worst_rel={k: f"{v:.2e}" for k, v in calls.worst.items()},
            tol_rel=lim)
        if prologue is not None:
            check(calls.prologue == {"relu_off": prologue, "relu_on": 0},
                  f"K4 ran its prologue {calls.prologue} times in one "
                  f"forward, not {prologue} with relu off")
        if table is not None:
            shapes = {k: rec["calls"] for k, rec in calls.f64_fwd.items()}
            want = {(M, K, N): c for M, K, N, c, _ in table}
            check(shapes == want, f"the forward's K4 shapes {shapes} are "
                  f"not the table's {want}")
            want = {(M, K, N): p for M, K, N, _, p in table if p}
            check(calls.prologue_shapes == want, "the forward's prologue "
                  f"calls {calls.prologue_shapes} are not the table's "
                  f"{want}")
        for k in ("fused_fwd", "fused_dw", "fused_dx"):
            check(counts.get(k, 0) == n and calls.calls[k] == n,
                  f"{k} launched {counts.get(k, 0)} times in one step of "
                  f"{n} fused convs")
            check(calls.worst[k] <= lim, f"{k} disagrees with its plain "
                  f"version on the main path's tensors: {calls.worst[k]:.3e}")
        every = _f64_report("k5_calls_vs_float64", calls.f64, tag)
        control = min(every["tf32_control_dw"], every["tf32_control_dx"])
        say(tag, check="k5_calls_vs_float64", shape="all",
            tol_rel=lim, **{k: every[k] if k == "calls" else f"{every[k]:.3e}"
                            for k in every},
            control_room=f"{control / lim:.1f}")
        check(every["calls"] == n, f"{every['calls']} K5 calls held against "
              f"float64, not {n}")
        for out in ("dw", "dx"):
            check(every[f"kernel_{out}"] <= lim, f"K5 {out} is farther than "
                  f"{lim} from float64: {every[f'kernel_{out}']:.3e}")
        check(control > lim, f"the TF32 control is within {lim} of float64 "
              f"({control:.3e}): the per-call check has no teeth")
        every = _f64_report("k4_calls_vs_float64", calls.f64_fwd, tag)
        outs = ("y", "ysum", "yssq")
        control = max(every.get(f"tf32_control_{o}", 0.0) for o in outs)
        say(tag, check="k4_calls_vs_float64", shape="all",
            tol_rel=lim, **{k: every[k] if k == "calls" else f"{every[k]:.3e}"
                            for k in every},
            control_room=f"{control / lim:.1f}")
        check(every["calls"] == n, f"{every['calls']} K4 calls held against "
              f"float64, not {n}")
        for out in outs:
            check(every[f"kernel_{out}"] <= lim, f"K4 {out} is farther than "
                  f"{lim} from float64: {every[f'kernel_{out}']:.3e}")
        check(control > lim, f"the K4 TF32 control is within {lim} of "
              f"float64 ({control:.3e}): the per-call check has no teeth")
        grads_k = _grads(params)
        noise = _conv_bias_noise(grads_k)
        dist = grad_dist or (lambda g, r: _worst_vs(g, r, noise))
        runs = k5_anchor_runs(mx, net, fused, x, y, launches, n)
        loss_b, grads_b = runs["plain_fp32"]
        loss_e, grads_e = runs["float64"]
        worst, worst_name = dist(grads_b, grads_k)
        kern, kern_name = dist(grads_k, grads_e)
        plain, plain_name = dist(grads_b, grads_e)
        ctl, ctl_name = dist(runs["tf32_control"][1], grads_e)
        passes, gate = k5_grad_gate(kern, plain, ctl)
        say(tag, vs="float64_K5_same_forward",
            loss_kernels=f"{loss_k:.7f}", loss_float64_k5=f"{loss_e:.7f}",
            worst_grad_rel=f"{kern:.3e}", worst_param=kern_name,
            plain_fp32_k5_grad_rel=f"{plain:.3e}", plain_param=plain_name,
            tf32_control_grad_rel=f"{ctl:.3e}", tf32_control_param=ctl_name,
            gate=f"{gate:.3e}", control_room=f"{ctl / gate:.1f}",
            tol_floor=RESNET_GRAD_RTOL, params=len(grads_k))
        say(tag, vs="plain_K5_same_forward",
            loss_kernels=f"{loss_k:.7f}", loss_plain_k5=f"{loss_b:.7f}",
            worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
            tol_grad=RESNET_GRAD_RTOL, params=len(grads_k))
        check(all(loss == loss_k for loss, _ in runs.values()),
              "the same forward gave another loss: "
              f"{ {k: v[0] for k, v in runs.items()} } vs {loss_k}")
        check(passes, f"K5 gradient gate {gate:.3e}: the kernel run is "
              f"{kern:.3e} from the float64 run ({kern_name}), the TF32 "
              f"control {ctl:.3e}, which must fall outside")
        del runs, grads_b, grads_e

        loss_p = _swapped_run(
            mx, fused, x, y, _swapped_ops(fcbn._torch_fused_fwd), {},
            launches)
        chaos, chaos_name = _grad_errors(_grads(params), grads_k, noise)
        xp = NDArray(x.data * (1.0 + 2.0 ** -24 * torch.randn(
            x.shape, generator=torch.Generator(x.data.device).manual_seed(
                SEED), device=x.data.device)))
        _resnet_fwd_bwd(mx, fused, xp, y)
        floor, floor_name = _grad_errors(_grads(params), grads_k, noise)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        say(tag, vs="plain_K4_K5", loss_kernels=f"{loss_k:.7f}",
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
        say(tag, vs="unfused_net", loss_fused=f"{loss_k:.7f}",
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


def resnet_train_phase(net, fused, x, y, marked, launches, steps=10,
                       tag="resnet-train", sgd=RESNET_SGD):
    """The Gluon loop with bench_resnet's settings (``sgd``: MobileNet's
    phases pass MOBILENET_SGD): one warm-up step, ``steps`` timed steps
    (host clock around synchronised work), one profiled step (its forward
    + backward and its SGD update in two profiler windows), whose kernels
    must include K4 and K5's. The launch counts are read over exactly
    these steps. ``tag`` names the printed lines."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile

    batch = x.shape[0]
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", dict(sgd))
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
    for g in ("k4", "k5_dw", "k5_dx"):
        check(groups.get(g, 0.0) > 0, f"[{tag}] the profiler saw no {g}")
    say(tag, device_steps=n_steps, step_ms=f"{step_s * 1e3:.3f}",
        images_per_s=f"{batch / step_s:.2f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        reserved_gb=f"{torch.cuda.memory_reserved() / 1e9:.2f}",
        profiled_busy_ms=f"{busy / 1e3:.3f}",
        profiled_idle_share=f"{1 - busy / window_us:.4f}",
        fused_fwd=counts.get("fused_fwd", 0),
        fused_dw=counts.get("fused_dw", 0),
        fused_dx=counts.get("fused_dx", 0))
    split = tag.replace("-train", "-step")
    say(f"{split}-split", **{g: f"{us / 1e3:.3f}ms/{us / busy:.4f}"
                             for g, us in sorted(groups.items(),
                                                 key=lambda kv: -kv[1])})
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"{split}-kernel", ms_per_step=f"{us / 1e3:.4f}",
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


def resnet_train_hybrid_phase(ctx, launches, steps=10, prefix="resnet",
                              sgd=RESNET_SGD, grad_dist=None, **setup):
    """ResNet-50 through ``optimize_for`` and ``hybridize()``d: two nets
    from the same seed, one eager and one hybridized, one forward +
    backward each with cuDNN's deterministic algorithms. The loss within
    RESNET_LOSS_RTOL and the running statistics within it of each one's
    largest value, bit for bit expected; the gradients bit for bit, or
    else held to K5's float64 anchor as ``k5_grad_gate`` holds the
    kernel run (``k5_anchor_runs`` on the eager net). Then
    ``hybridize()`` again, so that the training graphs are captured with
    cuDNN's default algorithms as ``[resnet-train]`` runs them, one
    capturing forward + backward, and the Gluon loop as
    ``resnet_train_phase`` runs it, every step a replay: one captured
    recording entry, K4/K5-dW/dX once per fused conv per step from the
    replays' launch accounting. Then ``recapture_checks``. MobileNetV2's
    phase passes ``prefix`` "mobilenet", its ``sgd``, ``grad_dist``
    (``_layer_l2``, as ``resnet_parity_phase`` takes it) and ``setup``
    (``model=...``)."""
    import mxnet_tpu_torch as mx

    eager, efused, x, y, marked, _ = resnet_setup(ctx, **setup)
    net, fused, _, _, _, _ = resnet_setup(ctx, **setup)
    fused.hybridize()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss_e = float(_resnet_fwd_bwd(mx, efused, x, y))
        loss_h = float(_resnet_fwd_bwd(mx, fused, x, y))
        grads_e = _grads(eager.collect_params())
        grads_h = _grads(net.collect_params())
        stats = [{k: p.data().data for k, p in n.collect_params().items()
                  if "running" in k} for n in (eager, net)]
        stats_rel = max(_rel(b, a) for a, b in zip(stats[0].values(),
                                                   stats[1].values()))
        stats_bitwise = all(torch.equal(a, b) for a, b in zip(
            stats[0].values(), stats[1].values()))
        noise = _conv_bias_noise(grads_e)
        dist = grad_dist or (lambda g, r: _worst_vs(g, r, noise))
        worst, worst_name = dist(dict(zip(grads_e, grads_h.values())),
                                 grads_e)
        bitwise = loss_h == loss_e and worst == 0.0
        loss_rel = abs(loss_h - loss_e) / abs(loss_e)
        gate, passes = {}, bitwise
        if not bitwise:
            runs = k5_anchor_runs(mx, eager, efused, x, y, launches,
                                  len(marked))
            grads_f64 = runs["float64"][1]
            kern, _ = dist(dict(zip(grads_e, grads_h.values())), grads_f64)
            plain, _ = dist(runs["plain_fp32"][1], grads_f64)
            ctl, _ = dist(runs["tf32_control"][1], grads_f64)
            passes, limit = k5_grad_gate(kern, plain, ctl)
            gate = dict(hybrid_vs_f64=f"{kern:.3e}",
                        plain_vs_f64=f"{plain:.3e}",
                        tf32_control=f"{ctl:.3e}", gate=f"{limit:.3e}")
            del runs, grads_f64
        say(f"{prefix}-train-hybrid-parity", loss_eager=f"{loss_e:.7f}",
            loss_hybrid=f"{loss_h:.7f}", loss_rel=f"{loss_rel:.3e}",
            running_stats_rel=f"{stats_rel:.3e}",
            running_stats_bitwise=stats_bitwise,
            worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
            bitwise=bitwise, **gate)
        check(np.isfinite(loss_h) and loss_rel <= RESNET_LOSS_RTOL,
              "the hybridized ResNet-50 loss disagrees with the eager net's")
        check(stats_rel <= RESNET_LOSS_RTOL, "the hybridized net's running "
              f"statistics disagree with the eager net's: {stats_rel:.3e}")
        check(passes, "the hybridized gradients fail K5's "
              f"float64 gate: {gate}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del eager, efused, grads_e, grads_h, stats
    fused.hybridize()
    _resnet_fwd_bwd(mx, fused, x, y)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = resnet_train_phase(net, fused, x, y, marked, launches, steps,
                                tag=f"{prefix}-train-hybrid", sgd=sgd)
    entries = list(net._cached_graph._cache.values())
    say(f"{prefix}-train-hybrid-entries", entries=len(entries),
        recording=[e.recording for e in entries],
        graphed=[e.graphed for e in entries],
        replays=[e.gen for e in entries],
        fwd_graph_launches=dict(entries[0]._fwd.launches),
        bwd_graph_launches=dict(entries[0]._bwd.launches))
    check(len(entries) == 1 and entries[0].recording and entries[0].graphed,
          f"{len(entries)} entries captured, not one recording entry")
    recapture_checks(f"{prefix}-train-hybrid", net,
                     lambda xb, yb: _resnet_fwd_bwd(mx, fused, xb, yb), x, y)
    return counts


# ---------------------------------------------------------------------------
# phase 10c: the rest of gluon.nn at users' widths
# ---------------------------------------------------------------------------

# name: (layer given the nn module, input shape); widths users run: a
# text/audio conv stack, video convs and pools, a decoder's upsampling,
# a style-transfer net's padding and instance norm, ResNet-stage norms
# and activations
NN_LAYERS = {
    "Conv1D": (lambda nn: nn.Conv1D(256, 3, padding=1), (32, 128, 1024)),
    "Conv3D": (lambda nn: nn.Conv3D(64, 3), (8, 32, 16, 56, 56)),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(
        128, 4, strides=2, padding=1), (32, 256, 512)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        256, 4, strides=2, padding=1), (32, 512, 28, 28)),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(
        32, 4, strides=2, padding=1, output_padding=0), (4, 64, 8, 28, 28)),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2, ceil_mode=True),
                  (32, 256, 1023)),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, padding=1,
                                          count_include_pad=False),
                  (32, 256, 1024)),
    "GlobalMaxPool1D": (lambda nn: nn.GlobalMaxPool1D(), (32, 256, 1024)),
    "GlobalAvgPool1D": (lambda nn: nn.GlobalAvgPool1D(), (32, 256, 1024)),
    "MaxPool3D": (lambda nn: nn.MaxPool3D((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                  (8, 64, 16, 56, 56)),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(3, 2, 1, ceil_mode=True,
                                          count_include_pad=False),
                  (8, 64, 16, 56, 56)),
    "GlobalMaxPool3D": (lambda nn: nn.GlobalMaxPool3D(),
                        (8, 256, 8, 14, 14)),
    "GlobalAvgPool3D": (lambda nn: nn.GlobalAvgPool3D(),
                        (8, 256, 8, 14, 14)),
    "ReflectionPad2D": (lambda nn: nn.ReflectionPad2D(3),
                        (16, 64, 128, 128)),
    "SyncBatchNorm": (lambda nn: nn.SyncBatchNorm(), (32, 256, 56, 56)),
    "InstanceNorm": (lambda nn: nn.InstanceNorm(scale=True),
                     (16, 64, 128, 128)),
    "GroupNorm": (lambda nn: nn.GroupNorm(32), (32, 256, 56, 56)),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.2), (32, 256, 56, 56)),
    "PReLU": (lambda nn: nn.PReLU(in_channels=256), (32, 256, 56, 56)),
    "ELU": (lambda nn: nn.ELU(), (32, 256, 56, 56)),
    "SELU": (lambda nn: nn.SELU(), (32, 256, 56, 56)),
    "Swish": (lambda nn: nn.Swish(), (32, 256, 56, 56)),
    "Lambda": (lambda nn: nn.Lambda("relu"), (32, 256, 56, 56)),
    "HybridLambda": (lambda nn: nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, act_type="elu", slope=0.5)),
        (32, 256, 56, 56)),
}


def _nn_layer_run(mx, block, x, head):
    """A recorded forward and a backward of ``head``: the output, the
    input's gradient and each trainable parameter's gradient."""
    x.attach_grad()
    with mx.autograd.record():
        out = block(x)
    out.backward(head)
    return [out.data, x.grad.data] + [
        p.grad().data for p in block.collect_params().values()
        if p.grad_req != "null"]


def nn_layers_phase(ctx, launches, layers=None):
    """Each layer of the rest of ``gluon.nn`` (the 1-D and 3-D convs, the
    transposed convs, the 1-D and 3-D pools, ReflectionPad2D,
    SyncBatchNorm, InstanceNorm, GroupNorm, the activations, Lambda and
    HybridLambda, the last hybridized and so captured) at a width users
    run: one forward and backward of a seeded head gradient on the card,
    against the same block loaded from its ``.params`` on the host in
    float64; the output, the input's gradient and every parameter's
    gradient within NN_LAYER_RTOL of its largest |value|. These layers are
    plain PyTorch (cuDNN and ATen): no kernel of the port launches, and
    each line says so."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _kernels

    cpu = mx.cpu()
    worst_all = 0.0
    with tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR) as tmp:
        for name, (factory, shape) in (layers or NN_LAYERS).items():
            rs = np.random.RandomState(SEED)
            xn = rs.randn(*shape).astype(np.float32)
            torch.manual_seed(SEED)
            block = factory(mx.gluon.nn)
            block.initialize(ctx=ctx)
            x = mx.nd.array(xn, ctx=ctx)
            block(x)  # resolve deferred shapes (predict mode)
            path = os.path.join(tmp, f"{name}.params")
            block.save_parameters(path)
            host = factory(mx.gluon.nn)
            host.load_parameters(path, ctx=cpu)
            host.cast("float64")
            if name == "HybridLambda":
                block.hybridize()
            hn = rs.randn(*block(x).shape).astype(np.float32)
            launches.clear()
            t0 = time.perf_counter()
            got = _nn_layer_run(mx, block, x, mx.nd.array(hn, ctx=ctx))
            torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
            ours = {k: v for k, v in launches.items() if v}
            want = _nn_layer_run(
                mx, host, mx.nd.array(xn, ctx=cpu, dtype="float64"),
                mx.nd.array(hn, ctx=cpu, dtype="float64"))
            errs = [_rel(g.cpu(), w) for g, w in zip(got, want)]
            worst = max(errs)
            worst_all = max(worst_all, worst)
            say("nn-layers", layer=name, shape=tuple(shape),
                out_shape=tuple(got[0].shape),
                params=len(got) - 2, worst_rel=f"{worst:.3e}",
                out_rel=f"{errs[0]:.3e}", dx_rel=f"{errs[1]:.3e}",
                tol_rel=NN_LAYER_RTOL, card_first_call_s=f"{dev_s:.3f}",
                kernels="none (plain PyTorch: cuDNN and ATen)"
                if not ours else ours,
                captured=name == "HybridLambda")
            check(len(got) == len(want), f"{name}: gradients differ in "
                  "number between the card and the host")
            check(worst <= NN_LAYER_RTOL, f"{name} on the card disagrees "
                  f"with the host's float64: {worst:.3e}")
            check(not ours, f"{name} launched the port's kernels {ours}")
            del block, host, got, want, x
            gc.collect()
            torch.cuda.empty_cache()
    return worst_all


# ---------------------------------------------------------------------------
# phase 10d: the classification zoo at full width, eager and hybridized
# ---------------------------------------------------------------------------

def _dropouts(block, rate=None):
    """Every Dropout's rate under ``block``, set to ``rate`` if given
    (a list of rates: each Dropout in walk order)."""
    found = []

    def walk(b):
        if hasattr(b, "_rate"):
            found.append(b)
        for c in b._children.values():
            walk(c)

    walk(block)
    old = [b._rate for b in found]
    if rate is not None:
        for b, r in zip(found, rate if isinstance(rate, list)
                        else [rate] * len(found)):
            b._rate = r
    return old


def zoo_phase(ctx, launches, nets=ZOO_NETS, batch=ZOO_BATCH, steps=5,
              classes=1000, params=ZOO_PARAMS):
    """Each family's canonical net at full width, built with ``get_model``
    on the card, Xavier weights from seed SEED, a batch of ``batch``
    images and labels from numpy seed SEED, fp32:

    - its parameter count equals the JAX package's (ZOO_PARAMS);
    - two nets from the same seed, one eager and one ``hybridize()``d,
      each Dropout at rate 0 (a captured graph draws its own random
      numbers): one forward + backward + SGD step each with cuDNN's
      deterministic algorithms; the loss within ZOO_LOSS_RTOL and each
      gradient within ZOO_GRAD_RTOL of its layer's largest (bit for bit
      expected), the loss finite;
    - with the Dropout rates restored (0.5 in AlexNet, VGG, SqueezeNet,
      Inception) and the hybridized net captured anew: ``steps`` timed
      steps of each net after a warm-up (host clock around synchronised
      work) and one profiled step: ms and images/s of an eager step and a
      replayed step, the device's busy ms and idle share of each.
    Each net and its graphs are freed (``gc.collect()``) before the next
    is built."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    sgd = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    rows = {}
    for name, size in nets:
        rs = np.random.RandomState(SEED)
        x = mx.nd.array(rs.rand(batch, 3, size, size).astype(np.float32),
                        ctx=ctx)
        y = mx.nd.array(rs.randint(0, classes, (batch,)).astype(np.float32),
                        ctx=ctx)
        pair, rates = [], None
        for hybrid in (False, True):
            torch.manual_seed(SEED)
            net = vision.get_model(name, classes=classes)
            net.initialize(init=mx.initializer.Xavier(seed=SEED), ctx=ctx)
            net(x[0:2])  # resolve deferred shapes (predict mode)
            rates = _dropouts(net, 0.0)
            if hybrid:
                net.hybridize()
            pair.append((net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                               dict(sgd))))
        n_params = sum(p.data().size
                       for p in pair[0][0].collect_params().values())

        def step(net, trainer):
            loss = _resnet_fwd_bwd(mx, net, x, y)
            trainer.step(batch)
            return loss

        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            losses, grads = [], []
            for net, trainer in pair:
                loss = _resnet_fwd_bwd(mx, net, x, y)
                grads.append(_grads(net.collect_params()))
                trainer.step(batch)
                losses.append(float(loss))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        worst, worst_name = _layer_grad_errors(grads[1], grads[0])
        bitwise = losses[0] == losses[1] and worst == 0.0
        loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
        del grads
        timing = {}
        for (net, trainer), kind in zip(pair, ("eager", "replay")):
            _dropouts(net, rates)
            if kind == "replay":
                net.hybridize()  # capture anew with the restored rates
            out = profiled_loop(lambda: step(net, trainer), launches, steps)
            step_s, by_name, window_us = out[2], out[3], out[4]
            busy = sum(by_name.values())
            timing[kind] = (step_s, busy, window_us, out[0])
        say("zoo", net=name, image=size, batch=batch, params=n_params,
            jax_params=params[name], loss_eager=f"{losses[0]:.7f}",
            loss_hybrid=f"{losses[1]:.7f}", loss_rel=f"{loss_rel:.3e}",
            worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
            bitwise=bitwise, dropout_in_parity=0.0,
            dropout_in_timing=sorted(set(rates)) or None,
            **{f"{k}_step_ms": f"{t[0] * 1e3:.3f}"
               for k, t in timing.items()},
            **{f"{k}_images_per_s": f"{batch / t[0]:.2f}"
               for k, t in timing.items()},
            **{f"{k}_busy_ms": f"{t[1] / 1e3:.3f}"
               for k, t in timing.items()},
            **{f"{k}_idle_share": f"{1 - t[1] / t[2]:.4f}"
               for k, t in timing.items()},
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        check(n_params == params[name], f"{name} has {n_params} parameters, "
              f"the JAX package's {params[name]}")
        check(np.isfinite(losses[0]) and loss_rel <= ZOO_LOSS_RTOL,
              f"the hybridized {name} loss {losses[1]} disagrees with the "
              f"eager net's {losses[0]}")
        check(worst <= ZOO_GRAD_RTOL, f"hybridized {name} gradient "
              f"{worst_name} disagrees with the eager net's: {worst:.3e}")
        check(all(np.isfinite(t[3]).all() for t in timing.values()),
              f"{name}: non-finite training loss")
        rows[name] = {k: t[0] * 1e3 for k, t in timing.items()}
        del pair, net, trainer, x, y
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 11 and 12: Llama-3-8B widths through SPMDTrainStep(mesh=None)
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


# ---------------------------------------------------------------------------
# phase 8d: BERT-base pretraining as the reference defines the model
# ---------------------------------------------------------------------------

BERT_PRETRAIN_PARAMS = 133547324  # tools/zoo_param_counts.py --side jax
MASK_P, MASK_ID = 0.15, 103  # BERT's masking rate; [MASK] in its vocab
PRETRAIN_GROUPS = (("flash_k1_k2", ("mxtpu_flash",)),
                   ("fp32_products", ("gemm", "gemv")),
                   ("softmax_mlm", ("softmax", "logsumexp")),
                   ("dropout_random", ("distribution", "philox", "rand",
                                       "bernoulli", "dropout")),
                   ("layer_norm", ("layer_norm",)),
                   ("embedding_index", ("index", "embedding", "gather",
                                        "scatter")),
                   ("reductions", ("reduce",)),
                   ("elementwise", ("elementwise", "unrolled")))


def pretrain_loss(mod, net, ids, types, mask, nsp_labels, mask_id=MASK_ID):
    """BERT's pretraining loss through ``mod``'s operators (``mod`` is
    either package, so ``tests/test_torch_bert_pretrain.py`` holds the
    port's to the JAX package's): the positions where ``mask`` is 1
    replaced by ``mask_id`` (``nd.where``), the MLM cross-entropy over
    them (``nd.log_softmax``, ``nd.pick``, weighted by the mask) plus the
    NSP cross-entropy (``nd.softmax_cross_entropy``), both means.
    Returns the loss and the MLM logits."""
    nd = mod.nd
    inputs = nd.where(mask, nd.ones_like(ids) * mask_id, ids)
    _, _, nsp, mlm = net(inputs, types)
    lsm = nd.log_softmax(mlm, axis=-1)
    ce = -nd.pick(lsm, ids.astype("float32"), axis=-1)
    mlm_loss = (ce * mask).sum() / mask.sum()
    nsp_loss = nd.softmax_cross_entropy(nsp, nsp_labels) / ids.shape[0]
    return mlm_loss + nsp_loss, mlm


def mlm_hits(mod, mlm, ids, mask):
    """Top-1 and top-5 hits of the MLM head over the masked positions
    (``nd.argmax``, ``nd.topk``, ``nd.broadcast_equal``), unrecorded."""
    nd = mod.nd
    with mod.autograd.pause():
        lab = ids.astype("float32")
        top1 = nd.broadcast_equal(nd.argmax(mlm, axis=-1), lab)
        top5 = nd.topk(mlm, axis=-1, k=5)
        hit5 = nd.broadcast_equal(top5, nd.expand_dims(lab, axis=-1)) \
            .sum(axis=-1)
        return float((top1 * mask).sum().asscalar()), \
            float((hit5 * mask).sum().asscalar())


def _pretrain_batch(mx, ctx, x, seed=None):
    """One step's random part from ``mx.random``: 15% of the positions
    masked (``uniform < 0.15``) and NSP labels (``randint(0, 2)``)."""
    if seed is not None:
        mx.random.seed(seed)
    B, T = x.shape
    mask = mx.nd.random.uniform(shape=(B, T), ctx=ctx) < MASK_P
    nsp = mx.nd.random.randint(0, 2, shape=(B,), ctx=ctx).astype("float32")
    return mask, nsp


def _restore(params, saved):
    with torch.no_grad():
        for p, t in zip(params.values(), saved):
            p.data().data.copy_(t)


def bert_pretrain_phase(ctx, launches, x, steps=10, **cut):
    """BERT-base as the reference defines it (``models.bert_base()``:
    dropout 0.1, pooler, NSP classifier, MLM decoder; ``cut`` overrides
    widths for a rehearsal on the host), Normal(0.02) weights from SEED,
    ``x`` (bert_setup's batch, 64 x 128) with token types 0 then 1, Adam
    lr 1e-4 wd 0.01, fp32; each step draws its mask and NSP labels from
    ``mx.random``:

    1. at dropout 0, one step's loss and gradients with K1/K2 against the
       plain versions (loss 1e-5, gradients TRAIN_GRAD_RTOL of their
       layer's largest);
    2. two runs of ``steps`` steps from ``mx.random.seed(SEED)`` give
       losses equal bit for bit, eager and ``hybridize()``d (the graphs
       captured before the seed); a run from seed SEED + 1 other losses;
    3. two replays of the captured graph draw different dropout masks,
       and the same seed before each draws the same ones;
    4. ``nd.Dropout(p=0.1)`` keeps 0.9 +- 1e-3 of a (64, 128, 768)
       activation under ``train_mode()``; the masks' share is 0.15 +-
       1e-3 over 256 of them;
    5. the loss is finite and falls over the run;
    6. K1 and K2 launch once per layer per pass (12 a step).
    Prints the parameter count (against the JAX package's), ms per step
    and sequences/s eager and replayed, busy ms, idle share and the split
    of busy time (PRETRAIN_GROUPS), and the MLM accuracy after the run."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    net = mx.models.bert_base(**cut)
    net.initialize(init=mx.initializer.Normal(0.02, seed=SEED), ctx=ctx)
    B, T = x.shape
    types = mx.nd.array(np.repeat((np.arange(T) >= T // 2)[None], B, 0),
                        dtype="int32", ctx=ctx)
    net(x, types)
    params = net.collect_params()
    n_params = sum(p.data().size for p in params.values())
    layers = cut.get("num_layers", BERT_LAYERS)
    say("bert-pretrain-model", config="BERT-base (bert_12_768_12, vocab "
        "30522, dropout 0.1, pooler + NSP + MLM heads)", params=n_params,
        jax_params=BERT_PRETRAIN_PARAMS, batch=B, seq=T,
        init_s=f"{time.perf_counter() - t0:.2f}")
    if not cut:
        check(n_params == BERT_PRETRAIN_PARAMS, f"BERT-base has {n_params} "
              f"parameters, the JAX package's {BERT_PRETRAIN_PARAMS}")
    saved = [p.data().data.detach().clone() for p in params.values()]

    # 1. parity at dropout 0, kernels against plain attention
    rates = _dropouts(net, 0.0)
    mask, nsp = _pretrain_batch(mx, ctx, x, seed=SEED)

    def fwd_bwd():
        with mx.autograd.record():
            loss, _ = pretrain_loss(mx, net, x, types, mask, nsp)
        loss.backward()
        return float(loss.asscalar()), _grads(params)

    loss_k, grads_k = fwd_bwd()
    kernel_op = mx.nd.flash_attention
    from mxnet_tpu_torch.ndarray.ndarray import apply
    mx.nd.flash_attention = lambda q, k, v, causal=False, **kw: apply(
        PlainFlash.apply, q, k, v, causal)
    try:
        loss_p, grads_p = fwd_bwd()
    finally:
        mx.nd.flash_attention = kernel_op
    worst, worst_name = _layer_grad_errors(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    say("bert-pretrain-parity", dropout=0.0, loss_kernels=f"{loss_k:.7f}",
        loss_plain=f"{loss_p:.7f}", loss_rel=f"{loss_rel:.3e}",
        worst_grad_rel=f"{worst:.3e}", worst_param=worst_name,
        tol_rel=TRAIN_GRAD_RTOL)
    check(np.isfinite(loss_k) and loss_rel <= 1e-5,
          "[bert-pretrain] kernel loss disagrees with plain attention")
    check(worst <= TRAIN_GRAD_RTOL, f"[bert-pretrain] {worst_name} "
          f"gradient disagrees with plain attention: {worst}")
    del grads_k, grads_p
    _dropouts(net, rates)
    _restore(params, saved)

    # 4. the rates the stream gives
    with mx.autograd.train_mode():
        act = mx.nd.ones((B, T, cut.get("units", 768)), ctx=ctx)
        kept = float((mx.nd.Dropout(act, p=0.1) != 0).mean().asscalar())
    share = float(mx.nd.mean(mx.nd.random.uniform(
        shape=(256, B, T), ctx=ctx) < MASK_P).asscalar())
    say("bert-pretrain-rates", dropout_kept=f"{kept:.6f}", want_kept=0.9,
        mask_share=f"{share:.6f}", want_share=MASK_P, tol=1e-3,
        mask_positions=256 * B * T)
    check(abs(kept - 0.9) <= 1e-3, f"Dropout(0.1) kept {kept}")
    check(abs(share - MASK_P) <= 1e-3, f"the masks cover {share}")

    def run(seed, n, hybrid, profile=True):
        """``n`` steps from ``mx.random.seed(seed)`` on the saved
        weights with a fresh Trainer."""
        _restore(params, saved)
        trainer = mx.gluon.Trainer(params, "adam", dict(BERT_ADAM))
        mx.random.seed(seed)
        state = {}

        def step():
            m, y = _pretrain_batch(mx, ctx, x)
            with mx.autograd.record():
                loss, mlm = pretrain_loss(mx, net, x, types, m, y)
            loss.backward()
            trainer.step(B)
            state.update(mlm=mlm, mask=m)
            return loss.data.detach()

        if not profile:
            return [float(step()) for _ in range(n)], None, None, None, state
        losses, counts, step_s, by_name, window_us = profiled_loop(
            step, launches, n - 2)
        return losses, counts, step_s, (by_name, window_us), state

    rows = {}
    for hybrid in (False, True):
        tag = "bert-pretrain-hybrid" if hybrid else "bert-pretrain"
        if hybrid:
            net.hybridize()
            run(SEED + 7, 1, True, profile=False)  # capture before the seed
            entries = list(net._cached_graph._cache.values())
            check(len(entries) == 1 and entries[0].recording,
                  f"{len(entries)} entries after the capture")
        a, counts, step_s, (by_name, window_us), state = run(SEED, steps,
                                                             hybrid)
        b = run(SEED, steps, hybrid, profile=False)[0]
        busy = sum(by_name.values())
        flash = sum(us for n, us in by_name.items() if "flash" in n)
        n_steps = steps
        say(tag, steps=steps, step_ms=f"{step_s * 1e3:.3f}",
            sequences_per_s=f"{B / step_s:.2f}",
            loss_first=f"{a[0]:.6f}", loss_last=f"{a[-1]:.6f}",
            repeat_bitwise=a == b, profiled_busy_ms=f"{busy / 1e3:.3f}",
            profiled_idle_share=f"{1 - busy / window_us:.4f}",
            flash_share=f"{flash / max(busy, 1e-9):.4f}",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            flash_fwd=counts.get("flash_fwd", 0),
            flash_bwd_dq=counts.get("flash_bwd_dq", 0),
            flash_bwd_dkv=counts.get("flash_bwd_dkv", 0))
        say_step_split(tag, by_name, busy, groups=PRETRAIN_GROUPS)
        top1, top5 = mlm_hits(mx, state["mlm"], x, state["mask"])
        masked = float(state["mask"].sum().asscalar())
        say(f"{tag}-mlm", masked=int(masked), top1=f"{top1 / masked:.4f}",
            top5=f"{top5 / masked:.4f}")
        check(busy > 0 and flash > 0, f"[{tag}] no flash kernel profiled")
        check(a == b, f"[{tag}] two runs from one seed differ: {a} {b}")
        check(all(np.isfinite(a)), f"[{tag}] non-finite loss {a}")
        check(a[-1] < a[0], f"[{tag}] loss did not fall: {a}")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(counts.get(name, 0) == layers * n_steps,
                  f"[{tag}] {name} launched {counts.get(name, 0)} times in "
                  f"{n_steps} steps of {layers} layers")
        rows[hybrid] = (a, counts)
        if not hybrid:
            other = run(SEED + 1, 2, False, profile=False)[0]
            say("bert-pretrain-seed", seed=SEED + 1,
                losses=[f"{v:.6f}" for v in other])
            check(other[0] != a[0] and other[1] != a[1],
                  "seeds SEED and SEED + 1 gave the same losses")

    # 3. two replays draw different masks; a seed before each repeats them
    entries = list(net._cached_graph._cache.values())
    outs = []
    for seed in (SEED, None, SEED):
        if seed is not None:
            mx.random.seed(seed)
        with mx.autograd.record():
            loss, mlm = pretrain_loss(mx, net, x, types, mask, nsp)
        loss.backward()
        outs.append(mlm.data.detach().clone())
    after = list(net._cached_graph._cache.values())
    same_seed = torch.equal(outs[0], outs[2])
    differ = not torch.equal(outs[0], outs[1])
    say("bert-pretrain-replays", replays=[e.gen for e in after],
        entries=len(after), new_masks_differ=differ,
        reseeded_equal=same_seed)
    check(after == entries and all(e.graphed for e in after),
          "the replays captured a new graph")
    check(differ, "two replays drew the same dropout masks")
    check(same_seed, "a seed before a replay did not repeat its masks")
    del outs, saved
    return rows[False][1]


# ---------------------------------------------------------------------------
# phase 8f: AMP, the K-step superstep, checkpoint and resume
# ---------------------------------------------------------------------------

SS_K = 4  # [bert-amp-superstep]'s K
SS_GROUPS = 3  # supersteps of the main run
SS_TAIL = 2  # single steps after them (a short last group of the ring)
# test_bf16_fp32_loss_trajectory_parity's allowance (rel, abs)
BF16_DRIFT = (0.08, 0.05)
# this cell's own limits on bf16 against fp32 over the main run's 14
# steps: each loss within 0.2 (about three times the worst drift read on
# the card, 0.0614), and the part of the masters' update that the weight
# decay does not explain pointing the fp32 run's way. Adam's coupled
# decay (wd * w, ~2e-4 at Normal(0.02)) outweighs most gradients, so the
# whole update is 0.991 of the way along -sign(w) (the card's reading)
# whatever the gradients; its rest is the gradients' work
BF16_LOSS_ABS, BF16_RESIDUAL_COS = 0.2, 0.9
# one superstep against four hybridized trainer.steps (bit for bit
# expected): each loss within 2^-8 of its own value, each fp32 weight or
# master within 1e-5 of its tensor's largest
SS_LOSS_RTOL, SS_WEIGHT_RTOL = 2.0 ** -8, 1e-5
CKPT_EVERY = 4
RESNET_AMP_K = 2
RESNET_AMP_SGD = {"learning_rate": 0.005, "momentum": 0.9,
                  "multi_precision": True}
AMP_GROUPS = (("flash_k1_k2", ("mxtpu_flash",)),
              ("products", ("gemm", "gemv", "xmma", "nvjet", "cutlass")),
              ("softmax_mlm", ("softmax", "logsumexp")),
              ("dropout_random", ("distribution", "philox", "rand",
                                  "bernoulli", "dropout")),
              ("layer_norm", ("layer_norm",)),
              ("embedding_index", ("index", "embedding", "gather",
                                   "scatter")),
              ("foreach_update", ("foreach", "multi_tensor")),
              ("reductions", ("reduce",)),
              ("elementwise", ("elementwise", "unrolled")))
RESNET_AMP_GROUPS = (("k4", ("fcbn::(anonymous namespace)::fwd_kernel",)),
                     ("k5_dw", ("fcbn::(anonymous namespace)::dw_kernel",)),
                     ("k5_dx", ("fcbn::(anonymous namespace)::dx_kernel",)),
                     ("conv_cudnn", ("conv", "cudnn", "sm90_xmma",
                                     "implicit")),
                     ("products", ("gemm", "nvjet", "cutlass")),
                     ("foreach_update", ("foreach", "multi_tensor")),
                     ("bn_elementwise", ("batch_norm", "bn_", "elementwise",
                                         "unrolled", "reduce")))


def lowp_kernel_time_phase(dev, gen):
    """K1 and K2's two kernels in bfloat16 at BERT-base's training shape
    and K4 and K5's two kernels in float16 at ResNet-50's nine 1x1 shapes
    (per step, 30 calls), the low-precision types of
    ``[bert-amp-superstep]`` and ``[resnet-amp-fp16]``, timed with CUDA
    events beside their bounds, their plain versions and one library call
    in the same type (SDPA's forward, SDPA's backward for each K2 row, as
    the fp32 rows; for K4/K5 torch.matmul of the bare product). The bound
    is the function's: the larger of the bytes at 2 bytes an element and
    the operations over the 16-bit tensor cores' 989 TFLOP/s. The kernels
    multiply as 3xTF32 whatever the storage type; that cost (3 x
    operations over 495 TFLOP/s) is printed beside it as
    ``tf32x3_ops_ms``, not as the bound. Each output is held against the
    plain version first (FLASH_TOL and FUSED_TOL of the type)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    def bound16(ops, nbytes):
        """(bound ms, bound by, bytes ms, 3xTF32 ms) of a 16-bit call."""
        t_ops = ops / PEAK_OPS[torch.bfloat16] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
                else "bytes", t_bytes, tf32x3_ms(ops))

    B, H, KVH, T, S, D, causal, window, _ = FLASH_CASES["bert_base"]
    q, k, v, g = flash_inputs(gen, dev, B, H, KVH, T, S, D, torch.bfloat16)
    scale = D ** -0.5
    out, lse = fa._cuda_flash_fwd(q, k, v, scale, causal, window)
    po, plse = fa._torch_flash_fwd(q, k, v, scale, causal, window)
    err = float((out.float() - po.float()).abs().max()
                / po.float().abs().max())
    check(err <= FLASH_TOL[torch.bfloat16], f"K1 bf16 off by {err:.3e}")
    bwd = fa._bwd_operands(q, k, v, out, lse, g)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    work = flash_work(B, H, KVH, T, S, D, causal, window, 2)
    runs = {"flash_fwd": (
        lambda: fa._cuda_flash_fwd(q, k, v, scale, causal, window),
        lambda: fa._torch_flash_fwd(q, k, v, scale, causal, window)),
        "flash_bwd_dq": (lambda: fa._launch_flash_bwd(
            "dq", *bwd[:-1], delta, bwd[-1], (dq,), scale, causal, window),
            lambda: fa._torch_flash_bwd(q, k, v, po, plse, g, scale,
                                        causal, window)),
        "flash_bwd_dkv": (lambda: fa._launch_flash_bwd(
            "dkv", *bwd[:-1], delta, bwd[-1], (dk, dv), scale, causal,
            window), lambda: fa._torch_flash_bwd(
                q, k, v, po, plse, g, scale, causal, window))}
    qs, ks, vs = (t.clone().requires_grad_() for t in (
        q, k.repeat_interleave(H // KVH, 1),
        v.repeat_interleave(H // KVH, 1)))
    # SDPA's bf16 backward (cuDNN's) takes longer to enqueue through
    # autograd than to run: both library calls are timed queued behind a
    # spin, so that the host's rate does not set them
    with torch.no_grad():
        lib_fwd, lib_fwd_us = queued_ms(
            lambda: sdpa(qs, ks, vs, is_causal=causal), 50)
    lib_bwd, lib_bwd_us = sdpa_bwd_ms(qs, ks, vs, g, causal, 20,
                                      timer=queued_ms)
    for name, (kern, plain) in runs.items():
        ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 20)
        lib_ms, lib_us = (lib_fwd, lib_fwd_us) if name == "flash_fwd" \
            else (lib_bwd, lib_bwd_us)
        bound, by, t_bytes, t_tf32x3 = bound16(*work[name])
        say("kernel-time-lowp", kernel=name,
            shape=f"B{B}_H{H}_T{T}_S{S}_D{D}_bf16", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
            library_enqueue_us=f"{lib_us:.1f}",
            over_library=f"{ms / lib_ms:.4f}",
            bound_ms=f"{bound:.5f}", bound_by=by,
            bytes_bound_ms=f"{t_bytes:.5f}",
            tf32x3_ops_ms=f"{t_tf32x3:.5f}",
            bound_share=f"{bound / ms:.4f}",
            note='"plain_ms and library_ms of each K2 row are the whole '
            'backward"')
    del q, k, v, g, out, lse, po, plse, bwd, dq, dk, dv, qs, ks, vs
    # ms, plain, library, bound, bytes bound, 3xTF32, ms bound by bytes
    total = {n: [0.0] * 7 for n in ("fused_fwd", "fused_dw", "fused_dx")}
    worst = 0.0
    for M, K, N, calls in RESNET_1X1:
        x, w, s, t, y, dy, ds, dq = fused_inputs(gen, dev, M, K, N,
                                                 torch.float16, False)
        got = fcbn._cuda_fused_fwd(x, w, s, t)[0].float()
        want = fcbn._torch_fused_fwd(x, w, s, t)[0].float()
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
        runs = {"fused_fwd": (lambda: fcbn._cuda_fused_fwd(x, w, s, t),
                              lambda: fcbn._torch_fused_fwd(x, w, s, t),
                              lambda: torch.matmul(x, w)),
                "fused_dw": (lambda: fcbn._cuda_fused_dw(
                    x, w, y, s, t, dy, ds, dq), lambda: fcbn._torch_fused_dw(
                    x, y, s, t, dy, ds, dq, False, w.dtype),
                    lambda: torch.matmul(x.t(), dy)),
                "fused_dx": (lambda: fcbn._cuda_fused_dx(
                    x, w, y, s, t, dy, ds, dq), lambda: fcbn._torch_fused_dx(
                    x, w, y, s, t, dy, ds, dq, False),
                    lambda: torch.matmul(dy, w.t()))}
        work = fused_work(M, K, N, item=2)
        for name, (kern, plain, lib) in runs.items():
            ms, plain_ms, lib_ms = (cuda_ms(kern, 20), cuda_ms(plain, 10),
                                    cuda_ms(lib, 20))
            bound, by, t_bytes, t_tf32x3 = bound16(*work[name])
            for i, v in enumerate((ms, plain_ms, lib_ms, bound, t_bytes,
                                   t_tf32x3, bound * (by == "bytes"))):
                total[name][i] += calls * v
        del x, w, s, t, y, dy
    check(worst <= FUSED_TOL[torch.float16][0],
          f"K4 fp16 off by {worst:.3e}")
    for name, (ms, plain_ms, lib_ms, bound, t_bytes, t_tf32x3,
               by_bytes) in total.items():
        say("kernel-time-lowp", kernel=name, shape="resnet50_step_30_calls"
            "_fp16", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            matmul_product_only_ms=f"{lib_ms:.4f}",
            over_library=f"{ms / lib_ms:.4f}",
            bound_ms=f"{bound:.4f}",
            bound_by="bytes" if 2 * by_bytes > bound else "operations",
            bytes_bound_ms=f"{t_bytes:.4f}",
            tf32x3_ops_ms=f"{t_tf32x3:.4f}",
            bound_share=f"{bound / ms:.4f}", k4_rel_err=f"{worst:.2e}")


def _pretrain_block(mx, net):
    """A HybridBlock over ``net`` taking ids and token types stacked on
    axis 1, ``(B, 2, T)``, and returning the NSP and MLM logits: the one
    input a ``Superstep`` iteration gives its block."""

    class Pretrain(mx.gluon.HybridBlock):
        def __init__(self, inner, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.net = inner

        def hybrid_forward(self, F, x):
            out = self.net(x[:, 0], x[:, 1])
            return out[-2], out[-1]

    return Pretrain(net)


def pretrain_xy_loss(mx):
    """``pretrain_loss``'s arithmetic over the packed label block ``y``
    (``(B, 2T + 1)``: the true ids, the mask, the NSP label), the form a
    ``Superstep`` loss takes: ``loss_fn(block(x), y)``."""

    def loss_fn(out, y):
        nsp, mlm = out
        T = mlm.shape[1]
        ids, mask, nsp_y = y[:, :T], y[:, T:2 * T], y[:, 2 * T]
        ce = -mx.nd.pick(mx.nd.log_softmax(mlm, axis=-1), ids, axis=-1)
        return (ce * mask).sum() / mask.sum() + \
            mx.nd.softmax_cross_entropy(nsp, nsp_y) / mlm.shape[0]

    return loss_fn


def pretrain_host_batches(n, B, T, vocab, seed=SEED):
    """``n`` host batches of the pretraining task from numpy seed
    ``seed``: x ``(B, 2, T)`` int32 (ids with 15% of the positions masked
    to MASK_ID, token types 0 then 1), y ``(B, 2T + 1)`` float32."""
    rs = np.random.RandomState(seed)
    types = np.repeat((np.arange(T) >= T // 2)[None], B, 0)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (B, T))
        mask = (rs.rand(B, T) < MASK_P).astype(np.float32)
        x = np.stack([np.where(mask > 0, MASK_ID, ids), types], 1)
        y = np.concatenate([ids, mask, rs.randint(0, 2, (B, 1))], 1)
        out.append((x.astype(np.int32), y.astype(np.float32)))
    return out


def bert_amp_setup(ctx, amp_dtype="bfloat16", dropout=0.1, **cut):
    """``[bert-pretrain]``'s BERT-base (heads, Normal(0.02) from SEED),
    wrapped by ``_pretrain_block``, converted to ``amp_dtype`` (None:
    fp32), hybridized, with Adam lr 1e-4 wd 0.01 ``multi_precision``."""
    import mxnet_tpu_torch as mx

    torch.manual_seed(SEED)
    net = mx.models.bert_base(dropout=dropout, **cut)
    net.initialize(init=mx.initializer.Normal(0.02, seed=SEED), ctx=ctx)
    block = _pretrain_block(mx, net)
    if amp_dtype is not None:
        mx.amp.convert_model(block, amp_dtype)
    block.hybridize()
    trainer = mx.gluon.Trainer(block.collect_params(), "adam",
                               dict(BERT_ADAM, multi_precision=True))
    return block, trainer


def _stack_dev(mx, ctx, batches):
    from mxnet_tpu_torch.gluon.data import stack_batches

    xs = stack_batches([mx.nd.array(x, dtype="int32", ctx=ctx)
                        for x, _ in batches])
    ys = stack_batches([mx.nd.array(y, ctx=ctx) for _, y in batches])
    return xs, ys


def _masters(trainer, block):
    """Every parameter's fp32 value: its master under
    ``multi_precision``, else itself."""
    out = {}
    for k, p in block._collect_params_with_prefix().items():
        st = trainer._fused_states.get(p.name)
        w = p.data().data
        out[k] = st[0] if st and w.dtype != torch.float32 else w.float()
    return out


class _KernelTypes:
    """Inside: the storage type of every K1, K2, K4 and K5 launch is
    recorded by kernel name (``seen``), captured launches included."""

    def __enter__(self):
        from mxnet_tpu_torch.ops import flash_attention as fa
        from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

        self.seen = collections.defaultdict(set)
        self._fa, self._fcbn = fa, fcbn
        self._orig = (fa._cuda_flash_fwd, fa._launch_flash_bwd,
                      fcbn._launch)
        codes = {v: k for k, v in fcbn._DTYPE_CODES.items()}

        def fwd(q, *a, **kw):
            self.seen["flash_fwd"].add(str(q.dtype))
            return self._orig[0](q, *a, **kw)

        def bwd(kernel, q, *a, **kw):
            self.seen[f"flash_bwd_{kernel}"].add(str(q.dtype))
            return self._orig[1](kernel, q, *a, **kw)

        def launch(lib, name, *a):
            if name in ("mxtpu_fused_fwd", "mxtpu_fused_dw",
                        "mxtpu_fused_dx"):
                self.seen[name[len("mxtpu_"):]].add(str(codes[a[0]]))
            return self._orig[2](lib, name, *a)

        fa._cuda_flash_fwd, fa._launch_flash_bwd, fcbn._launch = \
            fwd, bwd, launch
        return self

    def __exit__(self, *exc):
        (self._fa._cuda_flash_fwd, self._fa._launch_flash_bwd,
         self._fcbn._launch) = self._orig
        return False


def _profile_superstep(fn, k=1):
    """One superstep ``fn()`` of ``k`` steps under torch.profiler: device
    microseconds a step (the superstep's over ``k``) by kernel name, and
    the host-clock window a step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6 / k
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / k
    return by_name, window_us


def _timed_supersteps(step, n):
    """Host-clock and device (CUDA events) ms of each of ``n`` supersteps
    ``step()``, each synchronised."""
    host, dev = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return host, dev


def bert_amp_superstep_phase(ctx, launches, **cut):
    """BERT-base pretraining (``[bert-pretrain]``'s net, heads, batch 64 x
    128, Adam lr 1e-4 wd 0.01) under ``amp.init("bfloat16")`` +
    ``convert_model`` with Adam's fp32 masters (``multi_precision``), fed
    from host batches through ``SuperstepRing(k=4)`` into
    ``gluon.Superstep(k=4)`` by ``run()``: three supersteps, then a tail
    of two single steps. Checks:

    a. at dropout 0, one superstep against four hybridized
       ``trainer.step``s on the same batches: losses within SS_LOSS_RTOL,
       fp32 weights and masters within SS_WEIGHT_RTOL of their tensor's
       largest (bit for bit expected, and said);
    b. over 8 steps the bf16 losses follow an fp32 run's (no AMP, the same
       seed and batches, the same ring and ``run()``) within BF16_DRIFT;
       over all 14 within BF16_LOSS_ABS; and the fp32 masters' update
       over the 14 (from their first values), less its projection on a
       weight decay's direction (-sign of the first weights), has a
       cosine of at least BF16_RESIDUAL_COS with the fp32 run's;
    c. K1 and K2 launched in bfloat16 inside the graph (the capture's
       launch accounting, each launch's storage type recorded);
    d. one graph launch per superstep, and ``ss.step`` makes no host
       synchronisation (``torch.cuda.set_sync_debug_mode("error")``);
    e. two runs from one seed repeat bit for bit (losses and weights).

    Reports ms a step on the device and the host clock, the idle share
    and the split of one profiled superstep (AMP_GROUPS), peak memory,
    beside ``[bert-pretrain]``'s fp32 152.443 ms replayed (PR 15)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import SuperstepRing

    layers = cut.get("num_layers", BERT_LAYERS)
    B, T = BERT_BATCH if not cut else 8, BERT_SEQ if not cut else 16
    vocab = cut.get("vocab_size", BERT_VOCAB)
    n = SS_K * SS_GROUPS + SS_TAIL
    batches = pretrain_host_batches(n, B, T, vocab)
    loss_fn = pretrain_xy_loss(mx)
    mx.amp.init("bfloat16")
    try:
        # a. one superstep against four hybridized trainer.steps, dropout 0
        ref, ref_tr = bert_amp_setup(ctx, dropout=0.0, **cut)
        ref_losses = []
        for x, y in batches[:SS_K]:
            xd = mx.nd.array(x, dtype="int32", ctx=ctx)
            yd = mx.nd.array(y, ctx=ctx)
            with mx.autograd.record():
                loss = loss_fn(ref(xd), yd)
            loss.backward()
            ref_tr.step(B)
            ref_losses.append(loss.data.detach().float().reshape(()))
        ref_losses = torch.stack(ref_losses)
        ref_w = _masters(ref_tr, ref)
        blk, tr = bert_amp_setup(ctx, dropout=0.0, **cut)
        ss = mx.gluon.Superstep(blk, loss_fn, tr, k=SS_K)
        got = ss.step(*_stack_dev(mx, ctx, batches[:SS_K]), B).data
        got_w = _masters(tr, blk)
        torch.cuda.synchronize()
        loss_rel = float(((got - ref_losses).abs()
                          / ref_losses.abs()).max())
        w_rel = max(_rel(got_w[k], ref_w[k]) for k in ref_w)
        mine = blk._collect_params_with_prefix()
        bitwise = torch.equal(got, ref_losses) and all(
            torch.equal(got_w[k], ref_w[k]) for k in ref_w) and all(
            torch.equal(mine[k].data().data, p.data().data)
            for k, p in ref._collect_params_with_prefix().items())
        say("bert-amp-superstep-parity", dropout=0.0, k=SS_K,
            loss_rel=f"{loss_rel:.3e}", tol_loss=f"{SS_LOSS_RTOL:.3e}",
            weight_rel=f"{w_rel:.3e}", tol_weight=SS_WEIGHT_RTOL,
            bitwise=bitwise, replays=ss.replays)
        check(loss_rel <= SS_LOSS_RTOL and w_rel <= SS_WEIGHT_RTOL,
              "[bert-amp-superstep] a superstep disagrees with four "
              "hybridized steps")
        check(ss.replays == 1, f"{ss.replays} replays for one superstep")
        del ref, ref_tr, blk, tr, ss, ref_w, got_w
        gc.collect()
        torch.cuda.empty_cache()

        # the main run: dropout 0.1, the ring, run(); twice from one seed
        runs = []
        for rep in range(2):
            blk, tr = bert_amp_setup(ctx, **cut)
            ss = mx.gluon.Superstep(blk, loss_fn, tr, k=SS_K)
            mx.random.seed(SEED)
            launches.clear()
            torch.cuda.reset_peak_memory_stats()
            with _KernelTypes() as kt:
                ring = SuperstepRing(batches, SS_K, device=ctx)
                t0 = time.perf_counter()
                losses = ss.run(ring, B)
                run_s = time.perf_counter() - t0
            graph = ss._plan["graph"]
            glaunch = dict(graph.launches) if graph is not None else {}
            runs.append((losses, [
                p.data().data.clone() for _, p in sorted(
                    blk._collect_params_with_prefix().items())]))
            if rep == 0:
                bf16_masters = {k: v.clone() for k, v in
                                _masters(tr, blk).items()}
                bf16_types = {k: p.data().data.dtype for k, p in
                              blk._collect_params_with_prefix().items()}
                counts = dict(launches)
                say("bert-amp-superstep-run", steps=len(losses),
                    supersteps=SS_GROUPS, tail=SS_TAIL, replays=ss.replays,
                    run_s=f"{run_s:.2f}",
                    losses=[f"{v:.5f}" for v in losses],
                    graph_launches=glaunch,
                    kernel_types={k: sorted(v) for k, v in
                                  kt.seen.items()},
                    launches=counts,
                    peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
                check(len(losses) == n and all(np.isfinite(losses)),
                      f"[bert-amp-superstep] losses {losses}")
                check(ss.replays == SS_GROUPS, f"{ss.replays} graph "
                      f"launches for {SS_GROUPS} supersteps")
                for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                    check(glaunch.get(name, 0) == layers * SS_K,
                          f"the graph launches {name} "
                          f"{glaunch.get(name, 0)} times, not "
                          f"{layers * SS_K}")
                    check(kt.seen.get(name) == {"torch.bfloat16"},
                          f"{name} ran in {kt.seen.get(name)}")
                    # n steps; the graph's warm-up iteration and the
                    # tail's entry's warm-up; forward only, the one-row
                    # predict pass that resolves deferred shapes
                    want = layers * (n + 2 + (name == "flash_fwd"))
                    check(counts.get(name, 0) == want, f"{name} "
                          f"launched {counts.get(name, 0)} times, not "
                          f"{want}, in {n} steps of {layers} layers")
                # d. one replay and no host synchronisation per superstep
                xs, ys = _stack_dev(mx, ctx, batches[:SS_K])
                torch.cuda.synchronize()
                before = ss.replays
                torch.cuda.set_sync_debug_mode("error")
                try:
                    ss.step(xs, ys, B)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                check(ss.replays == before + 1, "a superstep replayed "
                      f"{ss.replays - before} times")
                host, dev = _timed_supersteps(lambda: ss.step(xs, ys, B),
                                              5)
                by_name, window_us = _profile_superstep(
                    lambda: ss.step(xs, ys, B), SS_K)
                busy = sum(by_name.values())
                say("bert-amp-superstep", k=SS_K, batch=B, seq=T,
                    step_ms_host=f"{min(host) / SS_K:.3f}-"
                    f"{max(host) / SS_K:.3f}",
                    step_ms_device=f"{min(dev) / SS_K:.3f}-"
                    f"{max(dev) / SS_K:.3f}",
                    sequences_per_s=f"{B * SS_K / (min(host) / 1e3):.2f}",
                    profiled_busy_ms_per_step=f"{busy / 1e3:.3f}",
                    profiled_idle_share=f"{1 - busy / window_us:.4f}",
                    fp32_replayed_ms_pr15=152.443,
                    no_host_sync=True, replays=ss.replays)
                say_step_split("bert-amp-superstep", by_name, busy,
                               groups=AMP_GROUPS)
                del xs, ys
            del blk, tr, ss, ring, graph
            gc.collect()
            torch.cuda.empty_cache()
        (la, wa), (lb, wb) = runs
        same = la == lb and all(torch.equal(a, b) for a, b in zip(wa, wb))
        say("bert-amp-superstep-repeat", seed=SEED, bitwise=same)
        check(same, "[bert-amp-superstep] two runs from one seed differ")
        del runs, wa, wb
    finally:
        mx.amp.disable()
    # b. fp32 over the same steps against bf16's
    blk, tr = bert_amp_setup(ctx, amp_dtype=None, **cut)
    with mx.autograd.predict_mode():  # resolve the deferred shapes
        blk(mx.nd.array(batches[0][0][:1], dtype="int32", ctx=ctx))
    # the first weights, as Normal(0.02, seed=SEED) draws them in both
    # runs; the bf16 run's first masters are these rounded to bf16
    w0 = {k: p.data().data.clone()
          for k, p in blk._collect_params_with_prefix().items()}
    ss = mx.gluon.Superstep(blk, loss_fn, tr, k=SS_K)
    mx.random.seed(SEED)
    l32 = ss.run(SuperstepRing(batches, SS_K, device=ctx), B)
    m32 = _masters(tr, blk)
    # Gram matrix of the fp32 update, the bf16 update and the decay's
    # direction s, summed over every parameter
    gram = torch.zeros(3, 3, dtype=torch.float64,
                       device=next(iter(w0.values())).device)
    for k, w in w0.items():
        vecs = torch.stack([
            (m32[k] - w).double().reshape(-1),
            (bf16_masters[k] - w.to(bf16_types[k]).float()).double()
            .reshape(-1), -torch.sign(w).double().reshape(-1)])
        gram += vecs @ vecs.t()
    g = gram.tolist()
    cos = g[0][1] / (g[0][0] * g[1][1]) ** 0.5
    cos_wd = g[0][2] / (g[0][0] * g[2][2]) ** 0.5
    # r = d - (d.s / s.s) s for each update d: their dot products
    r = [[g[i][j] - g[i][2] * g[j][2] / g[2][2] for j in (0, 1)]
         for i in (0, 1)]
    cos_r = r[0][1] / (r[0][0] * r[1][1]) ** 0.5
    rel, ab = BF16_DRIFT
    drift = [abs(b - a) for a, b in zip(l32, la)]
    say("bert-amp-superstep-fp32", losses_fp32=[f"{v:.5f}" for v in l32],
        losses_bf16=[f"{v:.5f}" for v in la],
        worst_drift_8=f"{max(drift[:2 * SS_K]):.5f}",
        worst_drift_all=f"{max(drift):.5f}", rel=rel, abs=ab,
        abs_limit_all=BF16_LOSS_ABS, update_cos=f"{cos:.6f}",
        update_cos_weight_decay_alone=f"{cos_wd:.6f}",
        residual_cos=f"{cos_r:.6f}", residual_cos_limit=BF16_RESIDUAL_COS,
        residual_share=f"{(r[0][0] / g[0][0]) ** 0.5:.5f}",
        update_norm_ratio=f"{(g[1][1] / g[0][0]) ** 0.5:.5f}")
    check(all(abs(b - a) <= ab + rel * abs(a)
              for a, b in zip(l32[:2 * SS_K], la[:2 * SS_K])),
          "[bert-amp-superstep] bf16 losses left the fp32 trajectory")
    check(len(l32) == len(la) and max(drift) <= BF16_LOSS_ABS,
          f"[bert-amp-superstep] a bf16 loss {max(drift):.4f} from fp32's")
    check(cos_r >= BF16_RESIDUAL_COS,
          f"[bert-amp-superstep] beyond the weight decay, the bf16 update's"
          f" cosine with fp32's is {cos_r:.4f}")
    del blk, tr, ss, w0, m32, bf16_masters, bf16_types
    gc.collect()
    torch.cuda.empty_cache()


def checkpoint_resume_phase(ctx, **cut):
    """``[bert-amp-superstep]``'s net (bf16, dropout 0.1) with a
    ``CheckpointManager`` every CKPT_EVERY steps: three supersteps of K =
    4 on device-resident batches (the checkpoints at steps 4, 8 and 12);
    then a fresh net and trainer in the same process ``load_checkpoint``
    step 8 and run superstep 3 again. Its loss, weights, fp32 masters and
    Adam's m, v and t must equal the uninterrupted run's bit for bit, and
    ``verify`` must pass on every committed step. Reports the
    checkpoint's bytes, the snapshot's host time in the loop and the
    writer thread's time."""
    import shutil

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import resilience

    B, T = BERT_BATCH if not cut else 8, BERT_SEQ if not cut else 16
    vocab = cut.get("vocab_size", BERT_VOCAB)
    batches = pretrain_host_batches(SS_K * SS_GROUPS, B, T, vocab,
                                    seed=SEED + 1)
    loss_fn = pretrain_xy_loss(mx)
    root = os.path.join(ROOT, ".chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    mx.amp.init("bfloat16")
    try:
        blocks = [_stack_dev(mx, ctx, batches[i:i + SS_K])
                  for i in range(0, len(batches), SS_K)]
        blk, tr = bert_amp_setup(ctx, **cut)
        mgr = resilience.CheckpointManager(root, every_n_steps=CKPT_EVERY,
                                           keep=3, net=blk, trainer=tr,
                                           install_sigterm=False).attach()
        ss = mx.gluon.Superstep(blk, loss_fn, tr, k=SS_K)
        mx.random.seed(SEED)
        step_ms = []
        for g, (xs, ys) in enumerate(blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ss.step(xs, ys, B)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if g == 1:
                check(mgr.flush(), "the checkpoint writer did not drain")
        check(mgr.flush(), "the checkpoint writer did not drain")
        want_loss = out.data.clone()
        want = {k: p.data().data.clone()
                for k, p in blk._collect_params_with_prefix().items()}
        want_st = {k: tuple(t.clone() for t in st) for k, p in
                   blk._collect_params_with_prefix().items()
                   for st in [tr._fused_states.get(p.name)] if st}
        mgr.close()
        steps = resilience.list_checkpoints(root)
        problems = [p for _, path in steps for p in resilience.verify(path)]
        with open(os.path.join(steps[-1][1], "MANIFEST.json")) as f:
            nbytes = json.load(f)["payload_bytes"]
        del blk, tr, ss
        gc.collect()
        torch.cuda.empty_cache()

        blk2, tr2 = bert_amp_setup(ctx, **cut)
        t0 = time.perf_counter()
        rep = resilience.load_checkpoint(
            os.path.join(root, "step_%010d" % (2 * SS_K)), net=blk2,
            trainer=tr2)
        load_s = time.perf_counter() - t0
        ss2 = mx.gluon.Superstep(blk2, loss_fn, tr2, k=SS_K)
        got_loss = ss2.step(*blocks[2], B).data
        torch.cuda.synchronize()
        got = {k: p.data().data
               for k, p in blk2._collect_params_with_prefix().items()}
        got_st = {k: st for k, p in
                  blk2._collect_params_with_prefix().items()
                  for st in [tr2._fused_states.get(p.name)] if st}
        same_w = all(torch.equal(got[k], w) for k, w in want.items())
        same_st = set(got_st) == set(want_st) and all(
            len(got_st[k]) == len(s) and all(
                torch.equal(a, b) for a, b in zip(got_st[k], s))
            for k, s in want_st.items())
        same_loss = torch.equal(got_loss, want_loss)
        say("checkpoint-resume", every=CKPT_EVERY,
            committed=[s for s, _ in steps], resumed_step=rep.step,
            verify_problems=len(problems), checkpoint_bytes=nbytes,
            snapshot_ms=[f"{v * 1e3:.2f}" for v in mgr.snapshot_seconds],
            writer_s=[f"{v:.2f}" for v in mgr.write_seconds],
            load_s=f"{load_s:.2f}",
            superstep_ms=[f"{v:.1f}" for v in step_ms],
            loss_bitwise=same_loss, weights_bitwise=same_w,
            adam_m_v_t_and_masters_bitwise=same_st)
        check(not problems, f"verify: {problems[:3]}")
        check([s for s, _ in steps] == [4, 8, 12],
              f"committed steps {[s for s, _ in steps]}")
        check(rep.step == 2 * SS_K, f"resumed at step {rep.step}")
        check(same_loss and same_w and same_st, "[checkpoint-resume] the "
              "resumed superstep differs from the uninterrupted run")
    finally:
        mx.amp.disable()
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def resnet_amp_fp16_phase(ctx, launches, batch=RESNET_BATCH,
                          size=RESNET_SIZE, spec=None, settle=12):
    """ResNet-50 v1 at batch 128 x 224 x 224 built as ``resnet_setup``
    builds it, under ``amp.init("float16")``: ``convert_model``,
    ``init_trainer`` (the reference's default scaler: 65536, factor 2,
    window 2000), then ``optimize_for("tpu_fused_conv_bn")``, hybridized,
    so K4/K5 run in float16; SGD momentum 0.9 lr 0.005
    ``multi_precision``; ``Superstep(k=2)`` on seeded batches. At the
    default scale the summed losses' gradients overflow float16 in both
    packages, and the scaler backs off on its own: supersteps run until
    two in a row have no overflow (at most ``settle``), reported as they
    come. Then
    three supersteps with ``chaos.configure("nan@superstep:2")``
    poisoning slot 0 of the second. Checks: that iteration's overflow
    flag is 1, the other iteration's 0 and the weights moved (it
    applied); the scale halves across it and the overflow total counts
    it once; K4/K5 ran in float16, 30 launches of each an iteration in
    the graph; the trainable weights stay finite (BatchNorm's running
    statistics take the poisoned batch's NaN, as the reference's
    superstep carries them: ROADMAP C20). Reports ms a step (device,
    host) beside fp32's 162.1-163.4 ms."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import stack_batches
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.resilience import chaos

    mx.amp.init("float16")
    try:
        torch.manual_seed(SEED)
        net = vision.resnet50_v1(classes=1000) if spec is None else \
            vision.ResNetV1(vision.BottleneckV1, *spec)
        net.initialize(init=mx.initializer.Xavier(seed=SEED), ctx=ctx)
        rs = np.random.RandomState(SEED)
        xs = [mx.nd.array(rs.rand(batch, 3, size, size).astype(np.float32),
                          ctx=ctx).astype("float16")
              for _ in range(2 * RESNET_AMP_K)]
        ys = [mx.nd.array(rs.randint(0, 10, (batch,)).astype(np.float32),
                          ctx=ctx) for _ in range(2 * RESNET_AMP_K)]
        blocks = [(stack_batches(xs[i:i + RESNET_AMP_K]),
                   stack_batches(ys[i:i + RESNET_AMP_K]))
                  for i in range(0, len(xs), RESNET_AMP_K)]
        mx.amp.convert_model(net)
        net(xs[0][0:2])
        fused = net.optimize_for(backend="tpu_fused_conv_bn")
        fused.hybridize()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              dict(RESNET_AMP_SGD))
        mx.amp.init_trainer(tr)
        scaler = tr._amp_loss_scaler
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        ss = mx.gluon.Superstep(fused, loss_fn, tr, k=RESNET_AMP_K)
        trained = [p for _, p in sorted(net.collect_params().items())
                   if p.grad_req != "null"]
        settling = []
        # the graph is captured at the first superstep: the launchers'
        # storage types are recorded from there on
        kt = _KernelTypes().__enter__()
        try:
            for g in range(settle):
                ss.step(*blocks[g % 2], batch)
                settling.append(([int(v) for v in
                                  ss.last_overflow.tolist()],
                                 scaler.loss_scale))
                if len(settling) > 1 and not any(settling[-1][0]) \
                        and not any(settling[-2][0]):
                    break
            say("resnet-amp-fp16-settle", init_scale=65536.0,
                supersteps=[f"{f}@{sc}" for f, sc in settling],
                natural_overflows=scaler.overflow_total)
            check(not any(settling[-1][0]), "the scaler did not settle "
                  f"in {settle} supersteps: {settling}")
            chaos.configure("nan@superstep:2")
            flags, scales, totals = [], [scaler.loss_scale], \
                [scaler.overflow_total]
            launches.clear()
            for g in range(3):
                before = [p.data().data.clone() for p in trained] \
                    if g == 1 else None
                losses = ss.step(*blocks[g % 2], batch)
                flags.append([int(v) for v in ss.last_overflow.tolist()])
                scales.append(scaler.loss_scale)
                totals.append(scaler.overflow_total)
                if g == 1:
                    moved = any(not torch.equal(b, p.data().data)
                                for b, p in zip(before, trained))
                    del before
            fired = chaos.fired()
        finally:
            chaos.reset()
            kt.__exit__(None, None, None)
        counts = dict(launches)
        graph = ss._plan["graph"]
        glaunch = dict(graph.launches) if graph is not None else {}
        finite = all(torch.isfinite(p.data().data.float()).all()
                     for p in trained)
        stats_finite = sum(
            bool(torch.isfinite(p.data().data.float()).all())
            for k, p in net.collect_params().items() if "running" in k)
        say("resnet-amp-fp16-run", k=RESNET_AMP_K, flags=flags,
            scales=scales, overflow_totals=totals, fired=fired,
            last_losses=[f"{v:.5f}" for v in losses.data.float().tolist()],
            kernel_types={k: sorted(v) for k, v in kt.seen.items()},
            graph_launches=glaunch, launches=counts,
            trained_weights_finite=finite,
            running_stats_finite=f"{stats_finite}/"
            f"{sum('running' in k for k in net.collect_params())}")
        poisoned = flags[1]
        check(poisoned[0] == 1, f"the poisoned iteration's flag is "
              f"{poisoned[0]}")
        check(poisoned[1] == 0 and moved, "the other iteration of the "
              "poisoned superstep did not apply")
        check(scales[2] == scales[1] / 2, f"the scale went {scales[1]} -> "
              f"{scales[2]} across the poisoned superstep")
        check(totals[2] == totals[1] + 1, f"overflow total {totals[1]} -> "
              f"{totals[2]}")
        check(finite, "a trained weight is not finite")
        if spec is None:
            for name in ("fused_fwd", "fused_dw", "fused_dx"):
                check(glaunch.get(name, 0) == RESNET_FUSED * RESNET_AMP_K,
                      f"the graph launches {name} {glaunch.get(name, 0)} "
                      "times")
                check(counts.get(name, 0) == 3 * RESNET_FUSED
                      * RESNET_AMP_K, f"{name} launched "
                      f"{counts.get(name, 0)} times in 3 supersteps")
                check(kt.seen.get(name) == {"torch.float16"},
                      f"{name} ran in {kt.seen.get(name)}")
        host, dev = _timed_supersteps(lambda: ss.step(*blocks[0], batch), 5)
        by_name, window_us = _profile_superstep(
            lambda: ss.step(*blocks[0], batch), RESNET_AMP_K)
        busy = sum(by_name.values())
        say("resnet-amp-fp16", batch=batch, image=size,
            step_ms_host=f"{min(host) / RESNET_AMP_K:.3f}-"
            f"{max(host) / RESNET_AMP_K:.3f}",
            step_ms_device=f"{min(dev) / RESNET_AMP_K:.3f}-"
            f"{max(dev) / RESNET_AMP_K:.3f}",
            images_per_s=f"{batch * RESNET_AMP_K / (min(host) / 1e3):.1f}",
            profiled_busy_ms_per_step=f"{busy / 1e3:.3f}",
            profiled_idle_share=f"{1 - busy / window_us:.4f}",
            fp32_hybrid_ms="162.1-163.4",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            loss_scale=scaler.loss_scale)
        say_step_split("resnet-amp-fp16", by_name, busy,
                       groups=RESNET_AMP_GROUPS)
        del net, fused, tr, ss, xs, ys, blocks, graph, trained
    finally:
        mx.amp.disable()
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8e: the nd operators on the card against the host in float64
# ---------------------------------------------------------------------------

ND_TOL = {"elementwise": 1e-6, "reduction": 1e-5, "product": 1e-5,
          "shape": 1e-6, "potrf": 1e-4}  # relative to the output's largest

_SMOOTH = ("sin", "cos", "tanh", "sinh", "cosh", "arctan", "arcsinh", "exp",
           "expm1", "sigmoid", "erf", "softsign", "square", "negative",
           "degrees", "radians")
_POSITIVE = ("sqrt", "rsqrt", "log", "log10", "log1p", "log2", "reciprocal",
             "cbrt", "rcbrt", "gammaln", "gamma")
_BINARY = ("broadcast_add", "broadcast_sub", "broadcast_mul",
           "broadcast_div", "broadcast_power", "broadcast_maximum",
           "broadcast_minimum", "broadcast_hypot", "arctan2")
_NONDIFF = ("sign", "rint", "round", "ceil", "floor", "trunc", "fix",
            "logical_not", "isnan", "isinf", "isfinite", "broadcast_mod",
            "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
            "broadcast_greater_equal", "broadcast_lesser",
            "broadcast_lesser_equal", "broadcast_logical_and",
            "broadcast_logical_or", "broadcast_logical_xor")


def _nd_cases(B=64, T=128, C=768, H=3072, V=30522, N=1024):
    """name -> (family, input makers over a torch.Generator (float32
    tensors on the generator's device), attrs,
    gradient checked) at BERT-base's widths (batch B, sequence T, units C,
    hidden H, vocabulary V; N rows of a loss). The gradient is checked
    where ``tests/test_gradient_sweep.py`` has a spec for the name."""
    S = (B, T, C)
    VR = (B * T, V)
    u = (lambda lo, hi, shape=S: lambda g: torch.rand(
        shape, generator=g, device=g.device) * (hi - lo) + lo)
    sgn = (lambda shape=S: lambda g: (torch.rand(
        shape, generator=g, device=g.device) * 0.8 + 0.2) * torch.where(
        torch.rand(shape, generator=g, device=g.device) < 0.5, -1.0, 1.0))
    rows = (lambda shape=(S[0] * S[1], S[2]): u(-1, 1, shape))
    ri = (lambda lo, hi, shape: lambda g: torch.randint(
        lo, hi, shape, generator=g, device=g.device).float())
    cases = {}
    for n in _SMOOTH:
        cases[n] = ("elementwise", [u(-1, 1)], {}, True)
    for n in _POSITIVE:
        cases[n] = ("elementwise", [u(0.3, 1.5)], {}, True)
    cases["tan"] = ("elementwise", [u(-0.6, 0.6)], {}, True)
    for n in ("arcsin", "arccos", "arctanh"):
        cases[n] = ("elementwise", [u(-0.8, 0.8)], {}, True)
    cases["arccosh"] = ("elementwise", [u(1.3, 2.5)], {}, True)
    cases["erfinv"] = ("elementwise", [u(-0.7, 0.7)], {}, True)
    for n in ("abs", "relu"):
        cases[n] = ("elementwise", [sgn()], {}, True)
    cases["smooth_l1"] = ("elementwise", [sgn()], {"scalar": 1.5}, True)
    cases["clip"] = ("elementwise", [sgn()], {"a_min": -0.5, "a_max": 0.5},
                     True)
    for n in _BINARY:
        lhs = u(0.3, 1.5) if n == "broadcast_power" else (
            sgn() if n == "broadcast_hypot" else u(-1, 1))
        rhs = sgn((1, 1, S[2])) if n in ("broadcast_div", "broadcast_hypot") \
            else u(0.3, 1.5, (1, 1, S[2]))
        cases[n] = ("elementwise", [lhs, rhs], {}, True)
    for n in _NONDIFF:
        a = ri(-1, 2, S) if "round" not in n else u(-3, 3)
        b = ri(-1, 2, (1, 1, S[2]))
        if n.startswith("broadcast_"):
            args = [a, b] if n != "broadcast_mod" else [u(-3, 3),
                                                        u(0.3, 1.5,
                                                          (1, 1, S[2]))]
        else:
            args = [a]
        cases[n] = ("elementwise", args, {}, False)
    cases["cast"] = ("elementwise", [u(-1, 1)], {"dtype": "float16"}, False)
    for n in ("sum", "mean", "nansum", "max", "min", "norm", "prod",
              "nanprod"):
        make = u(0.99, 1.01) if n in ("prod", "nanprod") else u(-1, 1)
        cases[n] = ("reduction", [make], {"axis": -1}, True)
    cases["cumsum"] = ("reduction", [u(-1, 1)], {"axis": 2}, True)
    for n in ("softmax", "log_softmax", "softmin"):
        cases[n] = ("reduction", [u(-4, 4, VR)], {"axis": -1}, True)
    cases["softmax_cross_entropy"] = (
        "reduction", [u(-4, 4, (N, VR[1])), ri(0, VR[1], (N,))], {}, True)
    cases["SoftmaxOutput"] = (
        "reduction", [u(-4, 4, (N, VR[1])), ri(0, VR[1], (N,))],
        {"normalization": "batch"}, True)
    cases["argmax_channel"] = ("shape", [u(-4, 4, (N, 1000))], {}, False)
    cases["argmax"] = ("shape", [u(-4, 4, VR)], {"axis": -1}, False)
    cases["argmin"] = ("shape", [u(-4, 4, VR)], {"axis": -1}, False)
    cases["topk"] = ("shape", [u(-4, 4, VR)], {"k": 5}, False)
    cases["sort"] = ("shape", [u(-4, 4, VR)], {}, True)
    cases["argsort"] = ("shape", [u(-4, 4, VR)], {}, False)
    cases["dot"] = ("product", [rows(), u(-1, 1, (C, H))], {}, True)
    cases["batch_dot"] = ("product", [u(-1, 1, (C, T, 64)),
                                      u(-1, 1, (C, T, 64))],
                          {"transpose_b": True}, True)
    cases["matmul"] = ("product", [rows(), u(-1, 1, (C, C))], {}, True)
    cases["linalg_gemm2"] = ("product", [u(-1, 1, (12, 4 * T, 64)),
                                         u(-1, 1, (12, 4 * T, 64))],
                             {"transpose_b": True, "alpha": 0.125}, True)
    cases["linalg_gemm"] = ("product", [rows(), u(-1, 1, (C, C)),
                                        u(-1, 1, (B * T, C))],
                            {"beta": 0.5}, True)
    cases["linalg_syrk"] = ("product", [u(-1, 1, (C, H))], {}, True)
    cases["khatri_rao"] = ("product", [u(-1, 1, (B, 32)),
                                       u(-1, 1, (T, 32))], {}, True)

    def spd(g):
        a = torch.rand((C // 3, C // 3), generator=g, device=g.device) - 0.5
        return a @ a.T / (C // 3) + torch.eye(C // 3, device=g.device)

    cases["linalg_potrf"] = ("potrf", [spd], {}, True)
    shp = {"reshape": {"shape": (0, -1)}, "flatten": {},
           "transpose": {"axes": (1, 0, 2)}, "swapaxes": {"dim1": 0,
                                                         "dim2": 2},
           "expand_dims": {"axis": 1}, "flip": {"axis": 1},
           "slice_axis": {"axis": 2, "begin": 64, "end": C // 2 + 128},
           "tile": {"reps": (1, 1, 2)}, "repeat": {"repeats": 2, "axis": 0},
           "broadcast_axis": {"axis": 0, "size": 2},
           "slice": {"begin": (0, 1, 0), "end": S,
                     "step": (1, 2, 3)}, "identity": {},
           "diag": {}}
    for n, attrs in shp.items():
        src = u(-1, 1, (1,) + S[1:]) if n == "broadcast_axis" else \
            (u(-1, 1, (C, C)) if n == "diag" else u(-1, 1))
        cases[n] = ("shape", [src], attrs, True)
    cases["take"] = ("shape", [u(-1, 1, (V, C)), ri(0, V, (S[0], S[1]))],
                     {}, True)
    cases["pick"] = ("shape", [u(-1, 1, VR), ri(0, VR[1], (VR[0],))],
                     {"axis": -1}, True)
    cases["Embedding"] = ("shape", [ri(0, V, (S[0], S[1])), u(-1, 1, (V, C))],
                          {"input_dim": V, "output_dim": C}, True)
    cases["one_hot"] = ("shape", [ri(0, 1000, (S[0], S[1]))],
                        {"depth": 1000}, False)
    cases["where"] = ("shape", [ri(0, 2, S), u(-1, 1), u(-1, 1)], {}, True)
    cases["concat"] = ("shape", [u(-1, 1), u(-1, 1)], {"dim": 2}, True)
    cases["stack"] = ("shape", [u(-1, 1), u(-1, 1)], {"axis": 0}, True)
    cases["split"] = ("shape", [u(-1, 1)], {"num_outputs": 3, "axis": 2},
                      True)
    cases["pad"] = ("shape", [u(-1, 1, (8, B, 56, 56))],
                    {"mode": "reflect",
                     "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)}, True)
    cases["SequenceMask"] = ("shape", [u(-1, 1, (S[1], S[0], S[2])),
                                       ri(1, S[1] + 1, (S[0],))],
                             {"use_sequence_length": True}, True)
    lens = ri(1, S[1] + 1, (S[0],))
    cases["SequenceLast"] = ("shape", [u(-1, 1, (S[1], S[0], S[2])), lens],
                             {"use_sequence_length": True}, True)
    cases["SequenceReverse"] = ("shape", [u(-1, 1, (S[1], S[0], S[2])),
                                          lens],
                                {"use_sequence_length": True}, True)
    more = {"squeeze": ([u(-1, 1, (B, 1, C))], {"axis": 1}),
            "reshape_like": ([u(-1, 1), u(-1, 1, (B * T, C))], {}),
            "broadcast_to": ([u(-1, 1, (1, T, C))],
                             {"shape": S}),
            "broadcast_like": ([u(-1, 1, (1, T, C)), u(-1, 1)], {}),
            "slice_like": ([u(-1, 1), u(-1, 1, (B // 2, T // 2, C))],
                           {"axes": (0, 1)}),
            "split_v2": ([u(-1, 1)], {"indices": (C // 8, C // 2), "axis": 2}),
            "_slice_basic": ([u(-1, 1)], {"index": (
                "tuple", ("slice", 3, 60, 2), ("int", 5))}),
            "stop_gradient": ([u(-1, 1)], {}),
            "identity_with_attr_like_rhs": ([u(-1, 1), u(-1, 1)], {}),
            "zeros_like": ([u(-1, 1)], {}), "ones_like": ([u(-1, 1)], {}),
            "full_like": ([u(-1, 1)], {"fill_value": 2.5}),
            "shape_array": ([u(-1, 1)], {}), "size_array": ([u(-1, 1)], {}),
            "boolean_mask": ([u(-1, 1, (B * T, C)), lambda g: (torch.rand(
                (B * T,), generator=g, device=g.device) < 0.5).float()], {}),
            "gather_nd": ([u(-1, 1, S), lambda g: torch.stack(
                [torch.randint(0, B, (B * T // 2,), generator=g,
                               device=g.device),
                 torch.randint(0, T, (B * T // 2,), generator=g,
                               device=g.device)]).float()],
                {}),
            "scatter_nd": ([u(-1, 1, (B * T // 2, C)), lambda g: (
                lambda p: torch.stack([p // T, p % T]).float())(
                    torch.randperm(B * T, generator=g,
                                   device=g.device)[:B * T // 2])],
                {"shape": S})}
    for n, (makers, attrs) in more.items():
        cases[n] = ("shape", makers, attrs, n not in (
            "stop_gradient", "zeros_like", "ones_like", "full_like",
            "shape_array", "size_array", "boolean_mask", "scatter_nd"))
    cases["LayerNorm"] = ("reduction", [u(-2, 2), u(0.5, 1.5, (C,)),
                                        u(-1, 1, (C,))], {}, True)
    cases["L2Normalization"] = ("reduction", [u(-1, 1)],
                                {"mode": "instance"}, True)
    cases["FullyConnected"] = ("product", [u(-1, 1), u(-1, 1, (H, C)),
                                           u(-1, 1, (H,))],
                               {"num_hidden": H, "flatten": False}, True)
    cases["LRN"] = ("reduction", [u(-1, 1, (B // 2, B, 56, 56))],
                    {"nsize": 5}, True)
    return cases


def _nd_run(name, arrays, attrs, grad, dev, dtype, heads=None):
    """The op through ``ops.dispatch.invoke`` on ``dev`` in ``dtype``
    (floats; indices stay integral in value): outputs, and with ``grad``
    the gradients of the outputs weighted by ``heads`` (random in
    [0.5, 1.5), made on the device when None), and the heads."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.dispatch import invoke

    nds = [mx.nd.NDArray(a.to(device=dev, dtype=dtype)) for a in arrays]
    if grad:
        for a in nds:
            a.attach_grad()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    used = []
    with mx.autograd.record(train_mode=False):
        res = invoke(name, *nds, **attrs)
        outs = list(res) if isinstance(res, (list, tuple)) else [res]
        head = None
        for i, o in enumerate(outs):
            if not (grad and o.data.is_floating_point()):
                continue
            w = heads[len(used)].to(device=dev, dtype=o.data.dtype) \
                if heads is not None else (torch.rand(
                    o.shape, generator=gen, device=dev) + 0.5).to(
                        o.data.dtype)
            used.append(w)
            term = (o.data * w).sum()
            head = term if head is None else head + term
    out = [o.data.detach() for o in outs]
    if head is None:
        return out, [], used
    mx.autograd.backward([mx.nd.NDArray(head)])
    return out, [a.grad.data for a in nds], used


# ops whose result rows depend on their input rows alone (axis 0): the
# host recomputes every STRIDE-th row of the card's full-size call
_ROWWISE_ACT = set(_SMOOTH + _POSITIVE + _NONDIFF[:11]) | {
    "tan", "arcsin", "arccos", "arctanh", "arccosh", "erfinv", "abs",
    "relu", "smooth_l1", "clip", "cast", "sum", "mean", "nansum", "max",
    "min", "norm", "prod", "nanprod", "cumsum", "L2Normalization"}
_ROWWISE_VOCAB = {"softmax", "log_softmax", "softmin", "argmax", "argmin",
                  "topk", "sort", "argsort", "pick"}


def _nd_err(got, want):
    """Largest |got - want| over want's largest |value| (exact compare for
    integral outputs)."""
    got = got.detach().to("cpu", torch.float64)
    want = want.detach().to("cpu", torch.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = float(want.abs().max()) if want.numel() else 1.0
    return float((got - want).abs().max()) / max(scale, 1e-30) \
        if want.numel() else 0.0


def nd_op_check(name, case, dev):
    """One op of ``_nd_cases`` on ``dev`` in float32 against the host in
    float64 (``nd_ops_phase``); fails through ``check``. Returns the
    family, the output and gradient errors and the host's row stride."""
    family, makers, attrs, grad = case
    g = torch.Generator(device=dev).manual_seed(zlib_crc(name))
    inputs = [m(g) for m in makers]  # float32 on the card
    card_out, card_grad, heads = _nd_run(name, inputs, attrs, grad, dev,
                                         torch.float32)
    host = inputs
    k = 8 if name in _ROWWISE_ACT else (64 if name in _ROWWISE_VOCAB else 0)
    if k and host[0].shape[0] >= 4 * k:
        host = [h[::k] for h in host]
        card_out = [o[::k] for o in card_out]
        card_grad = [c[::k] for c in card_grad]
        heads = [w[::k] for w in heads]
    else:
        k = 0
    ref_out, ref_grad, _ = _nd_run(name, [h.cpu() for h in host], attrs,
                                   grad, torch.device("cpu"), torch.float64,
                                   heads=[w.cpu() for w in heads])
    tol = ND_TOL[family]
    grad_tol = 10 * tol  # a backward adds a reduction of its own
    errs = [_nd_err(c, r) for c, r in zip(card_out, ref_out)]
    gerrs = [_nd_err(c, r) for c, r in zip(card_grad, ref_grad)]
    exact = [not r.is_floating_point() for r in ref_out]
    bad = any((e > 0 if ex else e > tol) for e, ex in zip(errs, exact)) \
        or any(e > grad_tol for e in gerrs)
    if bad:
        say("nd-ops-fail", op=name, family=family, out_err=errs,
            grad_err=gerrs, tol=tol, grad_tol=grad_tol,
            kernels="none (plain PyTorch)")
    check(not bad, f"[nd-ops] {name} on the card disagrees with the host's "
          f"float64: outputs {errs}, gradients {gerrs}")
    return family, errs, gerrs, k


def nd_ops_phase(dev, names=None, dims=None, draws_n=1_000_000):
    """Each operator name this slice ports (the registry names of the JAX
    package's ``ops/math.py``, ``ops/shape_ops.py`` and ``ops/nn.py``
    that ``_nd_cases`` lists, the rest being aliases of these) on the card
    at a width users run: BERT-base's activation (64, 128, 768), its MLM
    logits (8192, 30522) for softmax, log_softmax, topk, sort, argmax,
    its projection shapes for the products. Forward, and where
    ``tests/test_gradient_sweep.py`` has a spec the first-order gradient,
    against the same op on the host in float64 from the same inputs,
    within ND_TOL of the output's largest per family (products,
    reductions 1e-5; element-wise 1e-6; index and shape results exact;
    ``linalg_potrf`` 1e-4 on a 256 x 256 SPD matrix of condition ~2; a
    gradient 10 times its family's, its backward adding a reduction of
    its own). An op whose result rows depend on their own input rows
    alone (``_ROWWISE_ACT``, ``_ROWWISE_VOCAB``) runs at full size on the
    card and the host recomputes every 8th (64th for the logits) row in
    float64, its head gradient rows with it. Then
    ``test_higher_order_grad.py``'s second-order cases at (64, 128, 768)
    and the samplers' moments over 1e6 draws. Plain PyTorch: no kernel of
    the port runs, and each line says so."""
    import mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    dims = dims or {}
    cases = _nd_cases(**dims)
    if names is not None:
        cases = {n: cases[n] for n in names}
    worst, rows = {}, {}
    for name, case in cases.items():
        family, errs, gerrs, k = nd_op_check(name, case, dev)
        if k:
            rows[name] = k
        worst[family] = max(worst.get(family, 0.0), *errs, *gerrs, 0.0)
    torch.cuda.empty_cache()
    say("nd-ops", ops=len(cases), host_row_stride=sorted(set(rows.values())),
        host_subsampled=len(rows), worst_rel=worst,
        tol=ND_TOL, seconds=f"{time.perf_counter() - t0:.1f}",
        kernels="none (plain PyTorch)")

    # second order (test_higher_order_grad.py) at a BERT-base activation
    t1 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    act = (dims.get("B", 64), dims.get("T", 128), dims.get("C", 768))
    x_host = (torch.rand(act, generator=g, dtype=torch.float64) * 2 - 1) \
        .float().double()
    errs = {}
    for name, shift in (("sin", 0.0), ("cos", 0.0), ("exp", 0.0),
                        ("log", 2.0), ("sigmoid", 0.0), ("relu", 0.0),
                        ("tanh", 0.0), ("pow4", 0.0)):
        got = []
        for d, dt in ((dev, torch.float32), (torch.device("cpu"),
                                            torch.float64)):
            x = mx.nd.NDArray((x_host + shift).to(device=d, dtype=dt))
            x.attach_grad()
            with mx.autograd.record():
                y = x ** 4 if name == "pow4" else getattr(mx.nd, name)(x)
                g1 = mx.autograd.grad(y, x, create_graph=True,
                                      retain_graph=True)
                if name == "pow4":
                    g1 = mx.autograd.grad(g1, x, create_graph=True,
                                          retain_graph=True)
            g1.backward()
            got.append(x.grad.data)
        errs[name] = _nd_err(got[0], got[1])
    say("nd-ops-second-order", shape=act, worst_rel=max(errs.values()),
        tol=1e-5, seconds=f"{time.perf_counter() - t1:.1f}",
        kernels="none (plain PyTorch)",
        **{k: f"{v:.2e}" for k, v in errs.items()})
    check(all(v <= 1e-5 for v in errs.values()),
          f"[nd-ops] second-order gradients off: {errs}")

    # the samplers' moments over 1e6 draws, on the card's stream
    mx.random.seed(SEED)
    n = draws_n
    rnd = mx.nd.random
    ctx = mx.Context(dev)
    draws = {
        "uniform": (rnd.uniform(2.0, 5.0, shape=(n,), ctx=ctx), 3.5, 0.75),
        "normal": (rnd.normal(1.0, 2.0, shape=(n,), ctx=ctx), 1.0, 4.0),
        "randint": (rnd.randint(0, 10, shape=(n,), ctx=ctx), 4.5, 8.25),
        "gamma": (rnd.gamma(2.0, 2.0, shape=(n,), ctx=ctx), 4.0, 8.0),
        "exponential": (rnd.exponential(2.0, shape=(n,), ctx=ctx), 2.0,
                        4.0),
        "poisson": (rnd.poisson(3.0, shape=(n,), ctx=ctx), 3.0, 3.0),
        "bernoulli": (mx.random.bernoulli(0.3, shape=(n,), ctx=ctx), 0.3,
                      0.21),
        "multinomial": (rnd.multinomial(mx.nd.array(
            [0.1, 0.2, 0.3, 0.4], ctx=ctx), shape=n), 2.0, 1.0),
    }
    moments = {}
    for name, (arr, mean, var) in draws.items():
        v = arr.data.double()
        m, s2 = float(v.mean()), float(v.var())
        ok_mean = abs(m - mean) <= 6 * (var / n) ** 0.5
        ok_var = abs(s2 - var) <= 0.02 * var
        moments[name] = f"{m:.5f}/{s2:.5f}"
        check(ok_mean and ok_var, f"[nd-ops] {name} moments {m}, {s2}: "
              f"want {mean}, {var}")
    perm = rnd.shuffle(mx.nd.arange(0, n, ctx=ctx, dtype="float32")).data
    check(torch.equal(perm.sort().values, torch.arange(
        n, device=dev, dtype=torch.float32)), "shuffle lost elements")
    say("nd-ops-random", draws=n, moments=moments, tol="6 se (mean), "
        "2% (variance)", kernels="none (plain PyTorch)")


# ---------------------------------------------------------------------------
# phase 10h: the data path (RecordIO, the image pipelines, the prefetcher)
# ---------------------------------------------------------------------------

DATA_IMAGES = 1024
DATA_SIZE = 256
DATA_BATCH = 128
DATA_SHAPE = (3, 224, 224)
IMAGENET_MEAN = (123.68, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
DATA_TOL = 1e-5  # a decoded, cropped, normalised batch against mx.image's
DATA_STEPS = 16
GLUON_STEPS = 8


def smooth_images(seed=SEED):
    """DATA_IMAGES seeded smooth RGB images of DATA_SIZE x DATA_SIZE (a
    colour gradient, three discs, a bar and faint noise, so the codecs
    see a photograph's compression ratio rather than white noise's), each
    with a label in 0..999."""
    rs = np.random.RandomState(seed)
    size = DATA_SIZE
    yy, xx = (np.mgrid[0:size, 0:size].astype(np.float32) / size)
    noise = rs.normal(0, 6, (size, size, 3)).astype(np.float32)
    for _ in range(DATA_IMAGES):
        f32 = np.float32
        img = (rs.uniform(0, 255, 3).astype(f32)
               + rs.uniform(-120, 120, 3).astype(f32) * xx[..., None]
               + rs.uniform(-120, 120, 3).astype(f32) * yy[..., None])
        for _ in range(3):
            cy, cx = rs.uniform(0, 1, 2)
            r = rs.uniform(0.05, 0.3)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[disc] = 0.4 * img[disc] + 0.6 * rs.uniform(0, 255, 3)
        y0, x0 = rs.randint(0, size - 32, 2)
        img[y0:y0 + rs.randint(8, 32), x0:] = rs.uniform(0, 255, 3)
        img += np.roll(noise, rs.randint(size), axis=0)
        yield np.clip(img, 0, 255).astype(np.uint8), int(rs.randint(1000))


def write_packs(root):
    """The JPEG pack (``recordio.pack_img``, quality 95) and the raw
    uint8 HWC pack of the same images, each with its ``.idx``; returns
    their paths and the bytes of each record file."""
    import mxnet_tpu_torch as mx

    rec = mx.recordio
    paths = {k: (os.path.join(root, f"{k}.rec"), os.path.join(root,
                                                              f"{k}.idx"))
             for k in ("jpeg", "raw")}
    w_jpg = rec.MXIndexedRecordIO(paths["jpeg"][1], paths["jpeg"][0], "w")
    w_raw = rec.MXIndexedRecordIO(paths["raw"][1], paths["raw"][0], "w")
    t0 = time.perf_counter()
    for i, (img, label) in enumerate(smooth_images()):
        hdr = rec.IRHeader(0, float(label), i, 0)
        w_jpg.write_idx(i, rec.pack_img(hdr, img, quality=95, img_fmt=".jpg"))
        w_raw.write_idx(i, rec.pack(hdr, img.tobytes()))
    w_jpg.close()
    w_raw.close()
    sizes = {k: os.path.getsize(p[0]) for k, p in paths.items()}
    say("data-records", images=DATA_IMAGES, size=DATA_SIZE,
        jpeg_bytes=sizes["jpeg"], raw_bytes=sizes["raw"],
        jpeg_bytes_per_image=sizes["jpeg"] // DATA_IMAGES,
        compression=f"{sizes['raw'] / sizes['jpeg']:.2f}",
        write_s=f"{time.perf_counter() - t0:.2f}")
    return paths


def _iter_kwargs(rec, threads, **kw):
    args = dict(path_imgrec=rec, data_shape=DATA_SHAPE,
                batch_size=DATA_BATCH, rand_crop=True, rand_mirror=True,
                shuffle=True, preprocess_threads=threads, seed=SEED,
                mean_r=IMAGENET_MEAN[0], mean_g=IMAGENET_MEAN[1],
                mean_b=IMAGENET_MEAN[2], std_r=IMAGENET_STD[0],
                std_g=IMAGENET_STD[1], std_b=IMAGENET_STD[2])
    args.update(kw)
    return args


def data_recordio_phase(rec):
    """``mx.io.ImageRecordIter`` over the JPEG pack (module docstring,
    phase 10h). Returns a function that makes a fresh training iterator, and its
    route."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.io.io import _NativeImageRecordIter

    threads = os.cpu_count()
    try:
        _native.get_lib()
        build_error = None
    except mx.MXNetError as e:
        build_error = str(e)
    if build_error is None:
        route = "native"

        def make(**kw):
            return mx.io.ImageRecordIter(**_iter_kwargs(rec, threads, **kw))

        check(isinstance(make(), _NativeImageRecordIter),
              "ImageRecordIter did not take the native pipeline")
    else:
        missing = [h for h in ("jpeglib.h", "png.h", "libjpeg", "libpng")
                   if h in build_error]
        say("data-native-build", built=False, missing=missing,
            error=f'"{build_error.splitlines()[-1][:200]}"')
        check(bool(missing), "the native data plane failed to build for "
              f"another reason than a missing codec (libjpeg, libpng): "
              f"{build_error[:500]}")
        try:
            mx.io.ImageRecordIter(**_iter_kwargs(rec, threads))
            quiet = True
        except mx.MXNetError as e:
            quiet = str(e) != build_error
        check(not quiet, "ImageRecordIter went on without the native "
              "library instead of raising its build error")
        route = "python-aug_list"

        def make(**kw):
            args = _iter_kwargs(rec, threads, **kw)
            aug = mx.image.CreateAugmenter(
                DATA_SHAPE, rand_crop=args["rand_crop"],
                rand_mirror=args["rand_mirror"],
                mean=np.array(IMAGENET_MEAN), std=np.array(IMAGENET_STD))
            return mx.io.ImageRecordIter(aug_list=aug, **args)

    # a centre-cropped batch against mx.image on the same records (one
    # pipeline thread: several deliver the records in the order they end)
    it = make(rand_crop=False, rand_mirror=False, shuffle=False,
              preprocess_threads=1)
    batch = next(iter(it))
    got = batch.data[0].asnumpy()
    reader = mx.recordio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "r")
    mean = np.array(IMAGENET_MEAN, np.float32)
    std = np.array(IMAGENET_STD, np.float32)
    worst, labels_ok = 0.0, True
    for i in range(DATA_BATCH):
        hdr, payload = mx.recordio.unpack(reader.read_idx(i))
        img, _ = mx.image.center_crop(mx.image.imdecode(payload), (224, 224))
        want = ((img.asnumpy().astype(np.float32) - mean) / std).transpose(
            2, 0, 1)
        worst = max(worst, float(np.abs(got[i] - want).max()))
        labels_ok &= float(batch.label[0].asnumpy()[i, 0]) == float(hdr.label)
    reader.close()
    if hasattr(it, "close"):
        it.close()
    epochs = []
    it = make()
    for epoch in range(2):
        t0 = time.perf_counter()
        n, shapes, finite = 0, set(), True
        for b in it:
            x = b.data[0].asnumpy()
            shapes.add(x.shape)
            finite &= bool(np.isfinite(x).all())
            n += DATA_BATCH - (b.pad or 0)
        epochs.append((n, time.perf_counter() - t0, shapes, finite))
        it.reset()
    if hasattr(it, "close"):
        it.close()
    say("data-recordio", route=route, iterator=type(it).__name__,
        preprocess_threads=threads, cores=os.cpu_count(),
        batch=DATA_BATCH, centre_crop_vs_mx_image=f"{worst:.2e}",
        labels_equal=labels_ok,
        epoch1_images_per_s=f"{epochs[0][0] / epochs[0][1]:.2f}",
        epoch2_images_per_s=f"{epochs[1][0] / epochs[1][1]:.2f}",
        images=[e[0] for e in epochs])
    check(worst <= DATA_TOL, f"a centre-cropped batch is {worst:.2e} from "
          "the records decoded and normalised by mx.image")
    check(labels_ok, "the batch's labels differ from the records'")
    for n, _, shapes, finite in epochs:
        check(n == DATA_IMAGES and shapes == {(DATA_BATCH,) + DATA_SHAPE}
              and finite, f"an epoch gave {n} images of {shapes}")
    return make, route


def _copy_stream_split(prof):
    """(device ms of each image batch's host-to-device copy, the copies'
    streams, the streams of every other device event) in a profiled
    window; a batch's copy is a host-to-device copy over 0.05 ms (the
    label copies take microseconds)."""
    copies, copy_streams, other = [], set(), set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "HtoD" in e.name:
            copy_streams.add(e.device_resource_id)
            if e.time_range.elapsed_us() > 50:
                copies.append(e.time_range.elapsed_us() / 1e3)
        else:
            other.add(e.device_resource_id)
    return copies, copy_streams, other


def _fed_steps(mx, fused, trainer, batches, steps, launches, tag):
    """``steps`` ResNet-50 steps on ``batches`` (an iterator of (x, y)
    device batches): the host-clock step, the wait in ``next()``, the
    losses, the launch counts over exactly these steps, then one
    profiled window of 6 more steps (more than the prefetcher's depth
    plus one, so that the batches staged while the profiler started are
    used up inside it): busy ms, idle share, each batch copy's device ms
    and the copies' streams against the step's streams."""
    from torch.profiler import ProfilerActivity, profile

    def one():
        t0 = time.perf_counter()
        x, y = next(batches)
        wait = time.perf_counter() - t0
        loss = _resnet_fwd_bwd(mx, fused, x, y)
        trainer.step(x.shape[0])
        return loss, wait

    torch.cuda.synchronize()
    launches.clear()
    losses, wait = [], 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, w = one()
        losses.append(loss)
        wait += w
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = dict(launches)
    window = 6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(window):
            losses.append(one()[0])
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    busy = sum(_device_us(prof).values())
    copies, copy_streams, other = _copy_stream_split(prof)
    check(busy > 0, f"[{tag}] the profiler saw no device time")
    return dict(step_ms=step_s * 1e3, wait_ms=wait / steps * 1e3,
                busy_ms=busy / window / 1e3,
                idle=1 - busy / window_us,
                copy_ms=float(np.mean(copies)) if copies else 0.0,
                copies=len(copies), copy_streams=copy_streams,
                step_streams=other, losses=[float(v) for v in losses],
                counts=counts)


def _labelled(prefetcher, keep=None):
    """Endless (x, y) device batches from a DevicePrefetcher, a new epoch
    after each end; ``keep`` receives the first staged batch."""
    while True:
        for b in prefetcher:
            if type(b).__name__ == "DataBatch":
                x, y = b.data[0], b.label[0]
            else:
                x, y = b
            if keep is not None and not keep:
                keep.append((x, y))
            yield x, y.reshape((-1,))


def resnet_train_data_phase(ctx, launches, make_iter, route,
                            steps=DATA_STEPS):
    """ResNet-50 (phase 10b's net, hybridized, through ``optimize_for``)
    fed by ``make_iter()`` through ``DevicePrefetcher(device=ctx,
    depth=2)`` (module docstring, phase 10h). Returns the net's fused
    block and trainer for ``data_gluon_phase``."""
    import mxnet_tpu_torch as mx

    net, fused, x, y, marked, _ = resnet_setup(ctx)
    fused.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(RESNET_SGD))
    host_first = []
    it = make_iter()

    def source():
        while True:  # epochs back to back, reset between them
            for b in it:
                if not host_first:
                    host_first.append((b.data[0].data.clone(),
                                       b.label[0].data.clone()))
                yield b
            it.reset()

    pf = mx.gluon.data.DevicePrefetcher(source(), device=ctx, depth=2)
    staged = []
    batches = _labelled(pf, keep=staged)
    xb, yb = next(batches)  # the capturing step
    _resnet_fwd_bwd(mx, fused, xb, yb)
    trainer.step(DATA_BATCH)
    torch.cuda.synchronize()
    equal = (torch.equal(staged[0][0].data.cpu(), host_first[0][0])
             and torch.equal(staged[0][1].data.cpu(), host_first[0][1]))
    fed = _fed_steps(mx, fused, trainer, batches, steps, launches,
                     "resnet-train-data")
    pf.close()
    if hasattr(it, "close"):
        it.close()
    resident = _fed_steps(mx, fused, trainer, iter(lambda: (x, y), None),
                          steps, launches, "resnet-train-data-resident")
    nbytes = DATA_BATCH * (int(np.prod(DATA_SHAPE)) + 1) * 4
    losses = fed["losses"]
    say("resnet-train-data", route=route, steps=steps,
        staged_equals_host=equal, step_ms=f"{fed['step_ms']:.3f}",
        images_per_s=f"{DATA_BATCH / fed['step_ms'] * 1e3:.2f}",
        busy_ms=f"{fed['busy_ms']:.3f}", idle_share=f"{fed['idle']:.4f}",
        timed_idle_share=f"{1 - fed['busy_ms'] / fed['step_ms']:.4f}",
        prefetch_wait_ms_per_step=f"{fed['wait_ms']:.3f}",
        staged_bytes_per_step=nbytes,
        h2d_ms_per_batch=f"{fed['copy_ms']:.3f}", batch_copies=fed["copies"],
        h2d_gb_per_s=f"{nbytes / max(fed['copy_ms'], 1e-9) / 1e6:.2f}",
        copy_streams=sorted(fed["copy_streams"]),
        step_streams=sorted(fed["step_streams"]),
        resident_step_ms=f"{resident['step_ms']:.3f}",
        resident_busy_ms=f"{resident['busy_ms']:.3f}",
        resident_idle_share=f"{resident['idle']:.4f}",
        fed_over_resident=f"{fed['step_ms'] / resident['step_ms']:.3f}",
        loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
        fused_fwd=fed["counts"].get("fused_fwd", 0),
        fused_dw=fed["counts"].get("fused_dw", 0),
        fused_dx=fed["counts"].get("fused_dx", 0))
    check(equal, "a staged batch differs from its host batch")
    check(fed["copy_streams"] and not fed["copy_streams"]
          & fed["step_streams"], "the host-to-device copies did not run "
          "on a stream of their own")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    head, tail = np.mean(losses[:3]), np.mean(losses[-3:])
    check(tail < head, f"the loss did not fall: {losses}")
    for name in ("fused_fwd", "fused_dw", "fused_dx"):
        n = fed["counts"].get(name, 0)
        check(n == len(marked) * steps, f"{name} launched {n} times in "
              f"{steps} fed steps of {len(marked)} fused convs")
    return net, fused, trainer


class RawImage:
    """A raw record (``recordio.pack`` of ``size`` x ``size`` uint8 HWC
    bytes) to ``(image, label)``, the image a host NDArray read with
    ``np.frombuffer``; a class, so that DataLoader's worker processes can
    unpickle it."""

    def __init__(self, size):
        self.size = size

    def __call__(self, record):
        import mxnet_tpu_torch as mx

        hdr, body = mx.recordio.unpack(record)
        img = np.frombuffer(body, np.uint8).reshape(self.size, self.size, 3)
        return mx.nd.array(img, ctx=mx.cpu(), dtype="uint8"), hdr.label


def data_gluon_phase(ctx, launches, paths, fused, trainer, workers,
                     steps=GLUON_STEPS):
    """The Gluon data path over the JPEG pack and over the raw pack
    (module docstring, phase 10h)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import vision
    from mxnet_tpu_torch.gluon.data.vision import transforms

    tf = transforms.Compose([
        transforms.RandomResizedCrop(DATA_SHAPE[1]),
        transforms.RandomFlipLeftRight(),
        transforms.ToTensor(),
        transforms.Normalize(tuple(m / 255 for m in IMAGENET_MEAN),
                             tuple(s / 255 for s in IMAGENET_STD))])
    for tag, ds in (
            ("data-gluon", vision.ImageRecordDataset(paths["jpeg"][0])),
            ("data-gluon-raw", mx.gluon.data.RecordFileDataset(
                paths["raw"][0]).transform(RawImage(DATA_SIZE)))):
        loader = mx.gluon.data.DataLoader(
            ds.transform_first(tf), batch_size=DATA_BATCH, shuffle=True,
            num_workers=workers, pin_memory=True, device=ctx)
        try:
            rates = []
            for _ in range(2):
                t0 = time.perf_counter()
                n = 0
                for xb, yb in loader:
                    check(xb.shape == (DATA_BATCH,) + DATA_SHAPE
                          and xb.context == ctx, f"[{tag}] batch "
                          f"{xb.shape} on {xb.context}")
                    n += xb.shape[0]
                torch.cuda.synchronize()
                rates.append(n / (time.perf_counter() - t0))
                check(n == DATA_IMAGES, f"[{tag}] an epoch gave {n} images")

            def endless():
                while True:
                    for xb, yb in loader:
                        yield xb, yb.reshape((-1,))

            fed = _fed_steps(mx, fused, trainer, endless(), steps, launches,
                             tag)
        finally:
            loader._worker_pool.terminate()
        say(tag, workers=workers, pin_memory=True,
            epoch1_images_per_s=f"{rates[0]:.2f}",
            epoch2_images_per_s=f"{rates[1]:.2f}", steps=steps,
            step_ms=f"{fed['step_ms']:.3f}",
            images_per_s=f"{DATA_BATCH / fed['step_ms'] * 1e3:.2f}",
            busy_ms=f"{fed['busy_ms']:.3f}", idle_share=f"{fed['idle']:.4f}",
            timed_idle_share=f"{1 - fed['busy_ms'] / fed['step_ms']:.4f}",
            loader_wait_ms_per_step=f"{fed['wait_ms']:.3f}",
            h2d_ms_per_batch=f"{fed['copy_ms']:.3f}",
            batch_copies=fed["copies"],
            loss_last=f"{fed['losses'][-1]:.5f}")
        check(all(np.isfinite(fed["losses"])), f"[{tag}] non-finite loss")
        check(fed["copy_streams"] and not fed["copy_streams"]
              & fed["step_streams"], f"[{tag}] the host-to-device copies "
              "did not run on a stream of their own")


def _scaled(data, label):
    """examples/train_mnist_gluon.py's ``tf``: uint8 image to float32 in
    [0, 1], on the host."""
    import mxnet_tpu_torch as mx

    return (mx.nd.array(data, ctx=mx.cpu()).astype("float32") / 255.0,
            label)


def mnist_phase(ctx, epochs=3, batch=128):
    """BASELINE.json's first config through the port: the example's
    synthetic stand-in (2,048 images of 28 x 28 whose class draws a
    bright band, so the classes are separable), ``DataLoader`` ->
    hybridized MLP (Dense 256 relu, 128 relu, 10) -> ``Trainer`` SGD lr
    0.02 -> ``SoftmaxCrossEntropyLoss``, batch 128, ``epochs`` epochs on
    the card; validation accuracy (the example validates on the training
    set) must exceed 0.9."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    rng = np.random.RandomState(0)
    imgs = (rng.rand(2048, 28, 28, 1) * 255).astype(np.uint8)
    labels = rng.randint(0, 10, (2048,)).astype(np.int32)
    for i in range(2048):
        imgs[i, labels[i] * 2:labels[i] * 2 + 3] = 255
    train = gluon.data.ArrayDataset(
        mx.nd.array(imgs, ctx=mx.cpu(), dtype="uint8"),
        labels.astype(np.float32))
    train_loader = gluon.data.DataLoader(train.transform(_scaled), batch,
                                         shuffle=True)
    val_loader = gluon.data.DataLoader(train.transform(_scaled), batch)
    torch.manual_seed(SEED)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(256, activation="relu"),
            gluon.nn.Dense(128, activation="relu"), gluon.nn.Dense(10))
    net.initialize(init=mx.initializer.Xavier(seed=SEED), ctx=ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.02})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    accs, rates = [], []
    for _ in range(epochs):
        metric = mx.metric.Accuracy()
        t0, n = time.perf_counter(), 0
        for data, label in train_loader:
            data = data.as_in_context(ctx).reshape((data.shape[0], -1))
            label = label.as_in_context(ctx)
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            metric.update([label], [out])
            n += data.shape[0]
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
        accs.append(metric.get()[1])
    metric = mx.metric.Accuracy()
    for data, label in val_loader:
        data = data.as_in_context(ctx).reshape((data.shape[0], -1))
        metric.update([label.as_in_context(ctx)], [net(data)])
    val = metric.get()[1]
    say("mnist", epochs=epochs, batch=batch, optimizer="sgd", lr=0.02,
        train_accuracy=[f"{a:.4f}" for a in accs],
        samples_per_s=[f"{r:.1f}" for r in rates],
        validation_accuracy=f"{val:.4f}", ctx=ctx)
    check(val > 0.9, f"MNIST validation accuracy {val:.4f} <= 0.9")


def data_phases(ctx, launches):
    """Phase 10h: the records, then ``[data-recordio]``,
    ``[resnet-train-data]``, ``[data-gluon]`` and ``[mnist]``."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        paths = write_packs(root)
        make_iter, route = data_recordio_phase(paths["jpeg"][0])
        net, fused, trainer = resnet_train_data_phase(ctx, launches,
                                                      make_iter, route)
        workers = max(1, min(6, (os.cpu_count() or 2) - 2))
        data_gluon_phase(ctx, launches, paths, fused, trainer, workers)
        del net, fused, trainer
        gc.collect()
        torch.cuda.empty_cache()
        mnist_phase(ctx)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def zlib_crc(name):
    import zlib

    return zlib.crc32(name.encode())


# The two-rank world of phase 13 shares the machine's one card: NCCL
# 2.28.9 refuses two ranks of one communicator on one device ("Duplicate
# GPU detected", tools/dist_probe.py), so the world's backend is gloo,
# whose collectives take CUDA tensors through the host. Fixed here.
DIST_BACKEND = "gloo"
DIST_RANKS = 2
DIST_BATCH = 32  # per rank: the global batch is [bert-pretrain]'s 64
DIST_STEPS = 3
DIST_TIMEOUT_S = 420  # the world's hard limit, its start to its end
# the two ranks' summed gradient against one process's gradient of the
# whole batch, each within this of its layer's largest |gradient|
DIST_GRAD_RTOL = 1e-5
# each rank's losses against the one-process run's on its half, relative
DIST_LOSS_RTOL = 1e-5
# [dist-bert-zero]'s 0/ready against SPMDTrainStep(mesh=None) over the
# whole batch: the losses relative, and each parameter's update of the
# DIST_STEPS Adam steps as ||got - want|| / ||want||, but the attention's
# key biases: their gradient is zero in exact arithmetic (the softmax over
# the keys ignores the shift q.b_k), so Adam turns its rounding noise into
# steps of up to lr each, and they are held to 2 x DIST_STEPS x lr apart.
# Read on the H100: losses equal, worst update 5.2e-5 (a bias), key biases
# 3.9e-9 apart; a dropped 1/dp postscale reads 0.63 (host rehearsal)
DIST_ZERO_LOSS_RTOL = 1e-5
DIST_ZERO_UPDATE_RTOL = 1e-3
DIST_ZERO_RUNS = ((0, "ready"), (2, "ready"), (3, "ready"),
                  (0, "barrier"))
DIST_DIR = ".chip_smoke_dist"  # git-ignored; removed after the phase


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def dist_nccl_phase():
    """``[dist-nccl]``: a one-rank NCCL world on ``cuda:0`` through the
    environment contract, the store's rank and size, a barrier, and one
    ``all_reduce`` of a 64 MiB bucket timed (the store's own reductions
    are the identity in a world of one)."""
    import torch.distributed as dist

    import mxnet_tpu_torch as mx

    env = {"MXTPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "MXTPU_NUM_PROCESSES": "1", "MXTPU_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        backend = mx.kv.init_distributed()
        kv = mx.kv.create("dist_tpu_sync")
        t0 = time.perf_counter()
        kv.barrier()
        barrier_ms = (time.perf_counter() - t0) * 1e3
        bucket = torch.ones((64 << 20) // 4, device="cuda")
        ms = cuda_ms(lambda: dist.all_reduce(bucket), 10)
        ok = bool((bucket == 1).all())
        say("dist-nccl", backend=backend,
            nccl=".".join(map(str, torch.cuda.nccl.version())),
            rank=kv.rank, num_workers=kv.num_workers,
            barrier_ms=f"{barrier_ms:.3f}", all_reduce_64MiB_ms=f"{ms:.4f}",
            sum_ok=ok)
        check(backend == "nccl", f"[dist-nccl] backend {backend}")
        check(kv.rank == 0 and kv.num_workers == 1,
              "[dist-nccl] rank/num_workers of a one-rank world")
        check(ok, "[dist-nccl] a one-rank all_reduce changed its tensor")
    finally:
        mx.kv.shutdown_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_bert_batch(shape):
    """The global batch of phase 13 (``shape``: per-rank rows, sequence
    length and vocabulary), from numpy seed SEED: ids, token types (0
    then 1), the 15% MLM mask (position 1 always), NSP labels and the
    labels of the SPMD step's MLM loss."""
    B, T, vocab = DIST_RANKS * shape["batch"], shape["seq"], shape["vocab"]
    rs = np.random.RandomState(SEED)
    ids = rs.randint(0, vocab, (B, T)).astype(np.int32)
    types = np.repeat((np.arange(T) >= T // 2)[None], B, 0).astype(np.int32)
    mask = (rs.uniform(size=(B, T)) < MASK_P).astype(np.float32)
    mask[:, 1] = 1.0
    nsp = rs.randint(0, 2, (B,)).astype(np.float32)
    labels = rs.randint(0, vocab, (B, T)).astype(np.float32)
    return ids, types, mask, nsp, labels


def dist_bert_net(mx, ctx, **cut):
    """BERT-base as ``bert_pretrain_phase`` builds it, at dropout 0, with
    shapes resolved by one forward."""
    torch.manual_seed(SEED)
    net = mx.models.bert_base(dropout=0.0, **cut)
    net.initialize(init=mx.initializer.Normal(0.02, seed=SEED), ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 8), dtype="int32", ctx=ctx))
    return net


def _digest(tensors):
    """SHA-256 of the tensors' bytes, in order (bit-for-bit comparison of
    replicas across ranks)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _busy_share(step):
    """Run ``step()`` once under the profiler: (device-busy ms, the
    window's ms on the host clock)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, window


def _dist_trainer_run(mx, rank, ctx, launches, ref_path, shape):
    """``[dist-bert-trainer]`` in one rank; returns its readings."""
    net = dist_bert_net(mx, ctx, **shape["cut"])
    params = net.collect_params()
    ids, types, mask, nsp, _ = dist_bert_batch(shape)
    b = shape["batch"]
    rows = slice(rank * b, (rank + 1) * b)
    mine = [mx.nd.array(a[rows], dtype=a.dtype.name, ctx=ctx)
            for a in (ids, types, mask, nsp)]
    tr = mx.gluon.Trainer(params, "adam", dict(BERT_ADAM),
                          kvstore="dist_tpu_sync")
    out = {"losses": [], "step_ms": [], "allreduce_ms": []}
    torch.cuda.reset_peak_memory_stats()
    launches.clear()

    def step(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = pretrain_loss(mx, net, *mine)[0]
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.allreduce_grads()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i == 0:
            grads = [p.grad().data for p in params.values()]
            out["grad_digest"] = _digest(grads)
            ref = torch.load(ref_path, map_location=grads[0].device)
            worst, name = _layer_grad_errors(
                dict(zip(params.keys(), grads)), ref["grads"])
            out["grad_worst_rel"], out["grad_worst"] = worst, name
            out["ref_losses"] = [ls[rank] for ls in ref["losses"]]
            del ref
        tr.update(1)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["allreduce_ms"].append((t2 - t1) * 1e3)
        out["losses"].append(float(loss.asscalar()))

    for i in range(DIST_STEPS - 1):
        step(i)
    busy, window = _busy_share(lambda: step(DIST_STEPS - 1))
    out["busy_ms"], out["window_ms"] = busy, window
    out["launches"] = dict(launches)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["param_digest"] = _digest([p.data().data for p in params.values()])
    out["bytes_reduced"] = sum(p.grad().data.numel() * 4
                               for p in params.values()
                               if p.grad_req != "null")
    plans = tr._kvstore._bucket_plans
    out["buckets"] = sum(len(pl["plan"].buckets) for pl in plans.values())
    out["params"] = sum(p.data().size for p in params.values())
    del tr, net, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dist_spmd_step(mx, net, ctx, shape, mesh, **kw):
    """``[dist-bert-zero]``'s step on ``net`` (the MLM logits against the
    batch's labels, Adam) over ``mesh`` (None: one process), its state
    made, and the global batch on ``ctx``."""
    ids, _, _, _, labels = dist_bert_batch(shape)
    x = mx.nd.array(ids, dtype="int32", ctx=ctx)
    y = mx.nd.array(labels, ctx=ctx)
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = mx.parallel.SPMDTrainStep(
        net, lambda out, lab: sce(out[-1], lab), "adam",
        {"wd": BERT_ADAM["wd"]}, mesh, **kw)
    step.init_state()  # shapes are known: no predict pass in step 1
    return step, x, y


def _sorted_weights(net):
    return {k: p.data().data for k, p in sorted(net.collect_params().items())}


def _update_errors(got, want):
    """``got`` against ``want`` (parameter updates, dicts in the same
    order): the worst ||got - want|| / ||want|| of a parameter and its
    name, but the attention's key biases (DIST_ZERO_UPDATE_RTOL), and
    their largest |got - want|."""
    worst, worst_name, key_bias = 0.0, "", 0.0
    for (name, w), g in zip(want.items(), got.values()):
        d = (g - w).float()
        if name.endswith("attn_key_bias"):
            key_bias = max(key_bias, float(d.abs().max()))
            continue
        rel = float(d.norm()) / max(float(w.float().norm()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name, key_bias


def _dist_zero_run(mx, rank, ctx, launches, stage, overlap, shape,
                   ref_path=None):
    """One ``[dist-bert-zero]`` run in one rank; with ``ref_path``, its
    losses and parameter updates against the one-process run's there."""
    net = dist_bert_net(mx, ctx, **shape["cut"])
    mesh = mx.parallel.make_mesh({"dp": DIST_RANKS})
    step, x, y = _dist_spmd_step(mx, net, ctx, shape, mesh,
                                 zero_stage=stage, overlap=overlap)
    w0 = {k: w.clone() for k, w in _sorted_weights(net).items()} \
        if ref_path else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    out = {"losses": [], "step_ms": []}

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, y, lr=BERT_ADAM["learning_rate"], sync=False)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(loss))

    for _ in range(DIST_STEPS - 1):
        one()
    out["busy_ms"], out["window_ms"] = _busy_share(one)
    out["launches"] = dict(launches)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["report"] = step.zero_memory_report()
    out["buckets"] = len(step._plan.buckets)
    out["mode"] = f"{step._mode}/{step._overlap_mode}"
    step.sync_to_block()
    out["param_digest"] = _digest(list(_sorted_weights(net).values()))
    if ref_path:
        ref = torch.load(ref_path, map_location=x.data.device)
        got = {k: w - w0[k] for k, w in _sorted_weights(net).items()}
        (out["update_worst_rel"], out["update_worst"],
         out["key_bias_abs"]) = _update_errors(got, ref["delta"])
        out["ref_losses"] = ref["losses"]
        del ref, got, w0
    del step, net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _host_rehearsal():
    """Phase 13's rehearsal on the host (``device="cpu"``, README): the
    card's synchronisation and memory calls become no-ops. Never on the
    card."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, fn, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0


def dist_worker(out_dir, shape_json, device="gpu"):
    """One rank of phase 13's world (``--dist-worker``): joins it through
    the environment contract, runs ``[dist-bert-trainer]`` and every
    ``[dist-bert-zero]`` run and writes its readings as JSON. ``shape``:
    the per-rank batch, sequence, vocabulary and BERT's width overrides
    (``cut``, empty on the card); ``device`` "cpu" is the host
    rehearsal."""
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _kernels

    shape = json.loads(shape_json)
    if device == "cpu":
        _host_rehearsal()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = mx.kv.init_distributed(backend=DIST_BACKEND)
    rank = mx.kv.create("dist_tpu_sync").rank
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    res = {"rank": rank, "backend": backend,
           "device": str(mx.resolve_device(ctx))}
    res["trainer"] = _dist_trainer_run(
        mx, rank, ctx, _kernels.LAUNCHES,
        os.path.join(out_dir, "ref_grads.pt"), shape)
    ref_zero = os.path.join(out_dir, "ref_zero.pt")
    res["zero"] = {f"{s}/{o}": _dist_zero_run(
        mx, rank, ctx, _kernels.LAUNCHES, s, o, shape,
        ref_zero if (s, o) == DIST_ZERO_RUNS[0] else None)
        for s, o in DIST_ZERO_RUNS}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mx.kv.shutdown_distributed()


def _dist_reference_grads(ctx, path, shape):
    """One process's run of ``[dist-bert-trainer]`` over the whole batch:
    the pretraining loss of each rank's half, summed in one graph (the
    sum the two ranks' ``allreduce_grads`` forms), the same Adam through a
    Trainer without a store, DIST_STEPS steps. Saves the first step's
    gradients and each step's per-half losses to ``path``, then frees it
    all. Then ``[dist-bert-zero]``'s: ``SPMDTrainStep(mesh=None)`` over
    the whole batch, DIST_STEPS steps, its losses and each parameter's
    update saved beside ``path`` (``ref_zero.pt``)."""
    import mxnet_tpu_torch as mx

    net = dist_bert_net(mx, ctx, **shape["cut"])
    params = net.collect_params()
    batch = dist_bert_batch(shape)
    b = shape["batch"]
    halves = [[mx.nd.array(a[r * b:(r + 1) * b],
                           dtype=a.dtype.name, ctx=ctx) for a in batch[:4]]
              for r in range(DIST_RANKS)]
    tr = mx.gluon.Trainer(params, "adam", dict(BERT_ADAM), kvstore=None)
    out = {"losses": []}
    for i in range(DIST_STEPS):
        with mx.autograd.record():
            losses = [pretrain_loss(mx, net, *h)[0] for h in halves]
            total = losses[0]
            for loss in losses[1:]:
                total = total + loss
        total.backward()
        if i == 0:
            out["grads"] = {k: p.grad().data.clone()
                            for k, p in params.items()}
        tr.step(1)
        out["losses"].append([float(loss.asscalar()) for loss in losses])
    torch.save(out, path)
    del net, params, halves, total, tr, out
    gc.collect()
    torch.cuda.empty_cache()
    net = dist_bert_net(mx, ctx, **shape["cut"])
    step, x, y = _dist_spmd_step(mx, net, ctx, shape, None)
    w0 = {k: w.clone() for k, w in _sorted_weights(net).items()}
    losses = [float(step(x, y, lr=BERT_ADAM["learning_rate"], sync=False))
              for _ in range(DIST_STEPS)]
    step.sync_to_block()
    delta = {k: w - w0[k] for k, w in _sorted_weights(net).items()}
    torch.save({"losses": losses, "delta": delta},
               os.path.join(os.path.dirname(path), "ref_zero.pt"))
    del net, step, x, y, w0, delta
    gc.collect()
    torch.cuda.empty_cache()


def dist_bert_phases(smi, device="gpu", cut=None, timeout=DIST_TIMEOUT_S):
    """``[dist-bert-trainer]`` and ``[dist-bert-zero]`` (module
    docstring, phase 13): the reference gradient here, then the world of
    DIST_RANKS worker processes of this script; their readings printed
    and gated. ``device="cpu"`` and ``cut`` rehearse it on the host."""
    import shutil
    import signal

    import mxnet_tpu_torch as mx

    cut = cut or {}
    shape = {"batch": DIST_BATCH, "seq": BERT_SEQ,
             "vocab": cut.get("vocab_size", BERT_VOCAB), "cut": cut}
    out_dir = os.path.join(ROOT, DIST_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        t0 = time.perf_counter()
        _dist_reference_grads(mx.gpu(0) if device == "gpu" else mx.cpu(),
                              os.path.join(out_dir, "ref_grads.pt"), shape)
        ref_s = time.perf_counter() - t0
        port = _free_port()
        procs = []
        for r in range(DIST_RANKS):
            env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                       MXTPU_NUM_PROCESSES=str(DIST_RANKS),
                       MXTPU_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 out_dir, json.dumps(shape), device], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True))
        deadline = time.monotonic() + timeout
        logs = []
        for p in procs:
            try:
                text, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    try:
                        os.killpg(q.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                text, _ = p.communicate()
                text = (text or "") + f"\n[killed after {timeout} s]"
            logs.append((p.returncode, text))
        world_s = time.perf_counter() - t0 - ref_s
        for r, (rc, text) in enumerate(logs):
            if rc != 0 or not os.path.exists(
                    os.path.join(out_dir, f"rank{r}.json")):
                print(text[-6000:], flush=True)
            check(rc == 0, f"[dist-bert] rank {r} exited {rc}")
        res = []
        for r in range(DIST_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        for p in locals().get("procs", []):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        shutil.rmtree(out_dir, ignore_errors=True)
    _dist_gates(res, smi, ref_s, world_s, shape)


def _dist_gates(res, smi, ref_s, world_s, shape):
    layers = shape["cut"].get("num_layers", BERT_LAYERS)

    def loss_rel(t):
        return max(abs(a - b) / abs(b)
                   for a, b in zip(t["losses"], t["ref_losses"]))

    tr = [r["trainer"] for r in res]
    for r, t in zip(res, tr):
        per_step = {k: t["launches"].get(k, 0) / DIST_STEPS
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        say("dist-bert-trainer", rank=r["rank"], backend=r["backend"],
            device=r["device"], nvidia_smi=f'"{smi}"', params=t["params"],
            batch=f"{shape['batch']}x{shape['seq']}",
            losses="/".join(f"{v:.6f}" for v in t["losses"]),
            step_ms="/".join(f"{v:.1f}" for v in t["step_ms"]),
            allreduce_grads_ms="/".join(f"{v:.1f}" for v in
                                        t["allreduce_ms"]),
            bytes_reduced_per_step=t["bytes_reduced"],
            buckets_per_step=t["buckets"],
            busy_ms=f"{t['busy_ms']:.1f}",
            idle_share=f"{1 - t['busy_ms'] / t['window_ms']:.4f}",
            peak_gb=f"{t['peak_gb']:.2f}",
            k1_k2_per_step="/".join(f"{v:g}" for v in per_step.values()),
            one_process_losses="/".join(f"{v:.6f}" for v in
                                        t["ref_losses"]),
            loss_rel=f"{loss_rel(t):.3e}",
            grad_worst_rel=f"{t['grad_worst_rel']:.3e}",
            grad_worst=t["grad_worst"] or "-")
        check(loss_rel(t) <= DIST_LOSS_RTOL,
              f"[dist-bert-trainer] rank {r['rank']}: losses "
              f"{t['losses']} off the one-process run's {t['ref_losses']}")
        check(t["grad_worst_rel"] <= DIST_GRAD_RTOL,
              f"[dist-bert-trainer] rank {r['rank']}: summed gradient "
              f"{t['grad_worst']} off the one-process gradient by "
              f"{t['grad_worst_rel']}")
        check(all(v == layers for v in per_step.values()),
              f"[dist-bert-trainer] rank {r['rank']}: K1/K2 per step "
              f"{per_step}, want {layers}")
        check(all(np.isfinite(t["losses"])) and
              t["losses"][-1] < t["losses"][0],
              f"[dist-bert-trainer] losses {t['losses']}")
        check(r["backend"] == DIST_BACKEND, f"backend {r['backend']}")
    check(len({t["grad_digest"] for t in tr}) == 1,
          "[dist-bert-trainer] the ranks' summed gradients differ")
    check(len({t["param_digest"] for t in tr}) == 1,
          "[dist-bert-trainer] the ranks' parameters differ after "
          f"{DIST_STEPS} steps")
    say("dist-bert-world", ranks=DIST_RANKS, backend=DIST_BACKEND,
        reference_grad_s=f"{ref_s:.1f}", world_s=f"{world_s:.1f}",
        grads_equal=True, replicas_equal=True)
    base = res[0]["zero"]["0/ready"]
    for key in res[0]["zero"]:
        for r in res:
            z = r["zero"][key]
            rep = z["report"]
            per_step = {k: z["launches"].get(k, 0) / DIST_STEPS
                        for k in ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv")}
            say("dist-bert-zero", run=key, rank=r["rank"], mode=z["mode"],
                losses="/".join(f"{v:.6f}" for v in z["losses"]),
                step_ms="/".join(f"{v:.1f}" for v in z["step_ms"]),
                buckets_per_step=z["buckets"],
                busy_ms=f"{z['busy_ms']:.1f}",
                idle_share=f"{1 - z['busy_ms'] / z['window_ms']:.4f}",
                peak_gb=f"{z['peak_gb']:.2f}",
                opt_bytes=f"{rep['opt_bytes_per_device']}/"
                          f"{rep['opt_bytes_replicated']}",
                grad_bytes=f"{rep['grad_bytes_per_device']}/"
                           f"{rep['grad_bytes_replicated']}",
                param_bytes=f"{rep['param_bytes_per_device']}/"
                            f"{rep['param_bytes_replicated']}",
                k1_k2_per_step="/".join(f"{v:g}" for v in per_step.values()))
            check(all(np.isfinite(z["losses"])),
                  f"[dist-bert-zero] {key} losses {z['losses']}")
            check(z["losses"] == base["losses"] and
                  z["param_digest"] == base["param_digest"],
                  f"[dist-bert-zero] {key} rank {r['rank']} differs from "
                  "0/ready")
            check(all(v == layers for v in per_step.values()),
                  f"[dist-bert-zero] {key}: K1/K2 per step {per_step}")
        rep = res[0]["zero"][key]["report"]
        if key in ("2/ready", "3/ready"):
            dev = rep["opt_bytes_per_device"] + rep["grad_bytes_per_device"]
            repl = rep["opt_bytes_replicated"] + rep["grad_bytes_replicated"]
            check(dev <= repl / DIST_RANKS * 1.05,
                  f"[dist-bert-zero] {key}: optimizer + gradient bytes "
                  f"{dev} of {repl} replicated")
    check(res[0]["zero"]["3/ready"]["report"]["param_bytes_per_device"]
          < base["report"]["param_bytes_per_device"],
          "[dist-bert-zero] ZeRO-3 keeps whole parameters at rest")
    for r in res:
        z = r["zero"]["0/ready"]
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(z["losses"], z["ref_losses"]))
        key_bias_bound = 2 * DIST_STEPS * BERT_ADAM["learning_rate"]
        say("dist-bert-zero-vs-one-process", rank=r["rank"],
            losses="/".join(f"{v:.6f}" for v in z["losses"]),
            one_process_losses="/".join(f"{v:.6f}" for v in
                                        z["ref_losses"]),
            loss_rel=f"{loss_rel:.3e}",
            update_worst_rel=f"{z['update_worst_rel']:.3e}",
            update_worst=z["update_worst"] or "-",
            key_bias_abs=f"{z['key_bias_abs']:.3e}")
        check(loss_rel <= DIST_ZERO_LOSS_RTOL,
              f"[dist-bert-zero] rank {r['rank']}: losses {z['losses']} off "
              f"the one-process step's {z['ref_losses']}")
        check(z["update_worst_rel"] <= DIST_ZERO_UPDATE_RTOL,
              f"[dist-bert-zero] rank {r['rank']}: update of "
              f"{z['update_worst']} off the one-process step's by "
              f"{z['update_worst_rel']}")
        check(z["key_bias_abs"] <= key_bias_bound,
              f"[dist-bert-zero] rank {r['rank']}: key biases "
              f"{z['key_bias_abs']} apart")


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
    sass_phase(libs)
    kernel_resources_phase()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    row, pools = kernel_phase(dev, gen)
    flash_rows, flash_errs = flash_kernel_phase(dev, gen)
    k6_row = fused_bwd_time_phase(dev, gen, flash_errs)
    fused_worst = fused_kernel_phase(dev, gen)
    fused_rows = fused_time_phase(dev, gen, fused_worst)
    mnv2_rows = fused_time_phase(dev, gen, fused_worst, MOBILENETV2_1X1,
                                 "mobilenetv2")
    fused_determinism(dev, gen)
    lowp_kernel_time_phase(dev, gen)
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
    decode_chunk_phase(net, _kernels.LAUNCHES)
    repo_generation_phase(net)
    prefill_graph_phase(net)
    del net
    torch.cuda.empty_cache()

    import mxnet_tpu_torch as mx

    bert, x, y = bert_setup(mx.gpu(0))
    train_parity_phase(bert, x, y)
    counts = train_phase(bert, x, y, _kernels.LAUNCHES)
    for r in flash_rows:
        if "@" not in r["name"]:
            r["launches"] = counts[r["name"]]
    train_hybrid_phase(mx.gpu(0), _kernels.LAUNCHES)
    gc.collect()  # blocks hold themselves in cycles; so do their graphs
    torch.cuda.empty_cache()
    params_phase(bert, x, mx.gpu(0))
    gc.collect()
    torch.cuda.empty_cache()
    warmup_phase(mx.gpu(0))
    aot_predict_phase(bert, _kernels.LAUNCHES, mx.gpu(0))
    del bert, y
    gc.collect()
    torch.cuda.empty_cache()
    serve_bert_phase(mx.gpu(0), _kernels.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    serve_repo_phase(mx.gpu(0))
    gc.collect()
    torch.cuda.empty_cache()
    bert_pretrain_phase(mx.gpu(0), _kernels.LAUNCHES, x)
    del x
    gc.collect()
    torch.cuda.empty_cache()
    nd_ops_phase(dev)
    torch.cuda.empty_cache()
    trainer_fused_phase(mx.gpu(0))
    torch.cuda.empty_cache()
    bert_amp_superstep_phase(mx.gpu(0), _kernels.LAUNCHES)
    checkpoint_resume_phase(mx.gpu(0))

    transformer_parity_phase(mx.gpu(0))
    counts, by_case = transformer_train_phase(mx.gpu(0), _kernels.LAUNCHES)
    transformer_train_phase(mx.gpu(0), _kernels.LAUNCHES, hybrid=True)
    for r in flash_rows:
        kernel, _, case = r["name"].partition("@")
        if case:
            r["launches"] = by_case[case][kernel]

    net, fused, x, y, marked, build = resnet_setup(mx.gpu(0))
    resnet_parity_phase(net, fused, x, y, marked, build, _kernels.LAUNCHES,
                        mx.gpu(0))
    torch.cuda.empty_cache()
    counts = resnet_train_phase(net, fused, x, y, marked, _kernels.LAUNCHES)
    for r in fused_rows:
        r["launches"] = counts[r["name"]]
    del net, fused, x, y, marked, build
    torch.cuda.empty_cache()
    resnet_train_hybrid_phase(mx.gpu(0), _kernels.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_amp_fp16_phase(mx.gpu(0), _kernels.LAUNCHES)
    data_phases(mx.gpu(0), _kernels.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()

    nn_layers_phase(mx.gpu(0), _kernels.LAUNCHES)
    zoo_phase(mx.gpu(0), _kernels.LAUNCHES)
    mobilenet = dict(batch=MOBILENET_BATCH, size=MOBILENET_SIZE)
    for model in ("mobilenet1.0", "mobilenetv2_1.0"):
        v2 = model == "mobilenetv2_1.0"
        net, fused, x, y, marked, build = resnet_setup(
            mx.gpu(0), model=model, **mobilenet)
        resnet_parity_phase(net, fused, x, y, marked, build,
                            _kernels.LAUNCHES, mx.gpu(0),
                            tag="mobilenet-parity",
                            prologue=MOBILENETV2_PROLOGUE if v2 else 0,
                            table=MOBILENETV2_1X1 if v2 else None,
                            sums_vs_terms=True, grad_dist=_layer_l2)
        del net, fused, x, y, marked, build
        gc.collect()
        torch.cuda.empty_cache()
    net, fused, x, y, marked, _ = resnet_setup(
        mx.gpu(0), model="mobilenetv2_1.0", **mobilenet)
    counts = resnet_train_phase(net, fused, x, y, marked, _kernels.LAUNCHES,
                                tag="mobilenet-train", sgd=MOBILENET_SGD)
    for r in mnv2_rows:
        r["launches"] = counts[r["name"].partition("@")[0]]
    del net, fused, x, y, marked
    gc.collect()
    torch.cuda.empty_cache()
    resnet_train_hybrid_phase(mx.gpu(0), _kernels.LAUNCHES,
                              prefix="mobilenet", sgd=MOBILENET_SGD,
                              grad_dist=_layer_l2,
                              model="mobilenetv2_1.0", **mobilenet)
    gc.collect()
    torch.cuda.empty_cache()

    llama, x, y = llama_setup(mx.gpu(0))
    llama_parity_phase(llama, x, y, _kernels.LAUNCHES)
    torch.cuda.empty_cache()
    counts = llama_train_phase(llama, x, y, _kernels.LAUNCHES)
    k6_row["launches"] = counts["flash_bwd_fused"]
    del llama, x, y
    gc.collect()
    torch.cuda.empty_cache()

    dist_nccl_phase()
    dist_bert_phases(smi)
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [row] + flash_rows + fused_rows
                      + mnv2_rows + [k6_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(*sys.argv[2:5])
    else:
        main()
