#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``artist_style_transfer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py             # every phase, one card
    python3 chip_smoke.py --profile   # plus device time by kernel: Gatys steps, a stylize
                                      # batch, 4 'cycle' training steps, an eval batch,
                                      # 4 'classifier' training steps, 8 streamed steps,
                                      # an int8 stylize batch, an int8 eval batch,
                                      # 4 steps of each int8 training run, and a round
                                      # of f32 and of int8 serve traffic
    python3 chip_smoke.py --phases space_train diffusion
                                      # header, build and these phases only: a probe
                                      # (the timing line, no kernels line, and a
                                      # last line that names the probe)

Phases, one JSON line each (15-17 do their work in this process first, then share
one launch of gloo ranks a world size, then check); any failure raises and exits
non-zero. The whole run took 545 s on an H100 80GB HBM3 at 700 W (805 s when each of
those phases launched its ranks apart and the launcher sent its pickles down pipes); it
must finish inside 1200 s, and machines differ by up to 1.5x in host-bound time:

0. header: torch/CUDA/Triton versions, the card (``nvidia-smi`` name and power
   limit), and both TF32 flags, which parity mode keeps False;
1. build: compiles ``csrc/*.cu`` with nvcc (set-up time) and counts the
   tensor-core MMA instructions (``HGMMA``, ``HMMA``) of each dtype in the SASS;
   K2's s8 warpgroup MMA (``IGMMA``) in each of its instantiations, no ``mma.sync``
   int8 MMA (``IMMA``) anywhere; each kernel's registers, shared memory and
   spills (``ptxas -v``);
2. gram: the Hopper Gram kernel against the plain PyTorch version at the
   VGG tap shapes of Gatys at 256x256 (N=1), of a training batch (224x224,
   N=4) and of a 512x512 batch of 4,
   in f32 and bf16, with its gradient; kernel / plain / cuBLAS times by CUDA
   events (warm), kernel and cuBLAS device time by the profiler with L2
   flushed before each call (cold), and the bound;
3. stylize: the committed golden TransformerNet on the card against the
   golden image (> 35 dB) and against the port's own CPU result (> 45 dB),
   then a seeded 4x512x512 batch through ``stylize_batched``;
4. gatys: 5 steps with the kernel against 5 without (loss traces within
   1e-4), then the main path: 300 default steps with the kernel counter
   zeroed just before, which must count 4 + 4*300 = 1204 launches;
5. train: 'cycle' training of the full-width TransformerNet through
   ``train()`` at 224x224, B=4, 16 seeded content images, 8 seeded paintings,
   3 epochs, f32 parity mode, random seeded VGG16: finite per-step losses,
   the third epoch's total below the first's, 4*ceil(8/8) + 4*12 = 52 kernel
   launches (counter zeroed just before), the exported ``.pth`` and ``.npz``
   reloaded and run; 3 steps with the kernel against 3 without (per-step
   losses within 1e-4); the FLOPs of one step (``FlopCounterMode``) and its
   bound by the rule of the Gram's (FP32 or 3xTF32, whichever is faster); one epoch with
   ``compute_dtype="bfloat16"`` (20 kernel launches) and a warm bf16 ms/step;
   ms/step and images/s of epochs 2-3 (host clock, each epoch ends in a
   sync) and peak memory;
6. classifier: the seeded ResNet-50 artist classifier (random BN running
   statistics) at 256x256, B=4, f32: logits and features on the card against
   the same module on the CPU (within 1e-3 of the largest magnitude, same
   argmax), ms a batch by CUDA events, the FLOPs of a forward and their bound;
7. eval: ``evaluate_with_classifier`` at the reference's eval defaults, the
   committed golden TransformerNet and the seeded classifier (saved as
   fastai's ``{'model': sd}`` and read back by ``load_classifier``), both
   on the default device, on 16 seeded
   uint8 1024x1024 images, crop 256, B=4: images/s and ms/image (host clock,
   after one warm-up batch), the accuracy, peak memory, no kernel launch
   (counter zeroed just before), and the predictions of 2 images against the
   port's CPU result (skipped where the CPU's top-2 margin is under 1e-3 of
   max|logit|); then, where cv2 is installed, the ``inference.py
   --no-display`` CLI on 4 seeded JPEGs, whose ``Acc=`` must equal a direct
   call's;
8. train_classifier: 'classifier' training through ``train()`` at 224x224,
   B=4, 16 seeded content images, 3 epochs, f32, seeded VGG16 and classifier:
   finite per-step losses, epoch 3's total below epoch 1's, 0 kernel launches,
   no ``.grad`` on a VGG or classifier parameter, the ``.pth`` export reloaded
   and run; ms/step and images/s of epochs 2-3, peak memory, the step's FLOPs
   and bound; one bf16 epoch (finite) and a warm bf16 ms/step;
9. data: the data pipeline on a seeded workspace written to a temp dir (256
   content JPEGs of 320-640 x 320-640 plus one truncated file, three artists
   in ``artists.csv`` with 64, 8 and 8 paintings of 200-500, a VGG16 ``.pth``
   from ``init_vgg16`` seed 0): the loaders timed (images/s, the decoder that
   ran) and held against a serial ``cv2.imread`` + ``cv2.resize``/``warpAffine``
   of the same files in the same order (bit-equal on the cv2 route, within
   1.0 on the native one), the truncated file skipped; then the training CLI
   (``train_style_transfer.main``, 'cycle', 2 epochs of 256 images at 224x224,
   B=4, on the default device): finite and falling epoch losses, the
   checkpoints and exports, the ``.pth`` export stylizing, the decoder in ``metrics.jsonl``,
   4*ceil(64/8) + 4*64*2 = 544 kernel launches; the stream refusing the
   truncated file; ``train(content_stream=content_file_stream(...))`` for 2
   epochs (544 launches, the host seconds waiting on the stream); a stream
   replaying the resident permutation over 32 decoded images against
   ``train(content_images=...)`` (per-epoch losses within rtol 1e-3); one
   streamed step with the kernel against one without (within 1e-4);
10. display: ``inference.py`` in its default display mode on the golden content
    image, on the default device, with matplotlib made unimportable: the figure
    (OpenCV's writer) exists, decodes at 1800x500 and holds 3 panels;
11. int8: kernel K2 (``csrc/qconv.cu``, the int8 conv) against its plain f64
    version on the real inputs of every conv of the main paths, recorded from one
    ``stylize_int8`` at 512x512, B=4 and one int8 eval batch (the quantized
    TransformerNet at 1024x1024 and the quantized ResNet-50 at 256x256, B=4): the
    int32 epilogue exact, the bf16 one bit-equal to the bf16 of the exact sum, the
    dequant within f32 rounding; each shape's plan (tile, sub-pixel classes, split-K)
    and K2 time (warm events, cold device),
    the plain version's, cuDNN's bf16 conv of the same geometry and, for the 1x1
    stride-1 shapes, ``torch._int_mm``, and its bound; a CUDA tensor with C_in not
    a multiple of 32 refused; then ``stylize_int8`` on the golden image (> 45 dB
    against the port's f32 stylize, > 35 dB against the golden), 16 K2 launches a
    forward, and int8, bf16 and f32 ms/image at 512x512, B=4;
    ``evaluate_with_classifier(quantize=True)`` on the eval phase's 16 seeded
    1024x1024 images with a decisive classifier (its artist's logit raised by 100):
    images/s, 68 K2 launches a batch, no K1 launch, the real pipeline's accuracy,
    and 2 images' predictions against the port's CPU int8 pipeline (the seeded
    classifier; skipped where the CPU's top-2 margin is under 2e-2 of max|logit|);
    then ``inference.py --no-display --quantize`` on 4 JPEGs, whose ``Acc=`` must
    equal a direct call's on the same files in the CLI's order;
12. int8_train: 'cycle' ``train()`` at the train phase's shapes (224x224, B=4, 16
    seeded content images, 8 paintings, seeded VGG16) in bf16: without int8 (3
    epochs, the baseline), with ``quantize_loss=True`` (3 epochs), with ``qat="trunk"``
    as well (3 epochs) and ``qat="all"`` (1 epoch), then 'classifier' through
    ``quantize_classifier`` of the seeded classifier (4 steps): finite per-step losses,
    falling over 3 epochs, and each run's K2, K1 and ``_int_mm`` launches counted from
    0: a step launches K2 for each int8 conv's forward and for its STE data gradient,
    12 (quantize_loss), 38 (+QAT trunk: 13 convs), 44 (QAT all: 16) and 104 (the
    ResNet-50's 52), the targets' forward 6 more; K1 2 a step (relu1_2, relu2_2) and 4
    for the targets; the int8 Gram 16 ``_int_mm`` calls a step (relu3_3 and relu4_3,
    forward and backward, one an image); gradients on every quantized layer's weight
    and gamma and on the output conv (QAT), on the TransformerNet (classifier), none
    on the frozen VGG or an int8 net's buffer. Then K2 against its plain version on
    one recorded step of each int8 net, forward and dgrad shapes apart, as phase
    int8 holds it (cuDNN's bf16 conv of the same geometry the reference, a dgrad's
    lhs-dilated one as a transpose conv); the int8 Gram's ``_int_mm`` products
    against the f64 ones at relu3_3 and relu4_3 (int32 error 0) and their times; warm
    ms/step of each int8 net; ``train_style_transfer.main`` with ``--quantize_loss
    --qat`` for one epoch over 16 seeded JPEGs (its K2 launches, the ``.pth``
    reloading);
13. train_artist_classifier: ``train/classifier.train_classifier`` on the card with the
    full-width ResNet-50 and fastai head (25,624,659 parameters, 19 classes) at the
    classifier CLI's defaults (256x256, B=32) on 160 seeded paintings of 19 artists,
    each artist's tinted: 3 epochs with ``freeze_body=True`` (counters zeroed just
    before: 0 K1 and 0 K2 launches), finite and falling train loss, every conv weight
    bit-unchanged, every BN's running statistics moved, the BN affines and the head
    trained; then 1 epoch with the body unfrozen; ms/step and images/s of epochs 2-3,
    peak memory, a step's FLOPs (frozen and unfrozen) and bound; ``best-2.pth`` exported
    and reloaded by ``load_classifier`` with the same logits; then
    ``python -m artist_style_transfer_tpu_torch.train.classifier`` for one epoch on phase
    data's seeded workspace (B=16), its ``best-2.pth`` and ``classifier.npz`` written and
    loading;
14. serve: the HTTP stack at full width (the golden TransformerNet, the classifier just
    trained), one in-process ``make_http_server`` on 127.0.0.1:0 a registry: ``/healthz``,
    ``/v1/models``, ``/statsz``; f32 stylize, 32 PNG requests of seeded 512x512 images from
    8 client threads (``max_batch`` 8, ``max_wait_ms`` 3), each response > 45 dB against
    a direct ``stylize``, fewer batches than images; a hot reload (the ``.pth`` rewritten
    with a second seeded net, ``POST .../reload``, the next response that net's); int8
    (``quantize=True``) stylize with 8 ``/v1/classify`` requests (300x280, one 200x180)
    among them: > 45 dB against the f32 stylize, each batch bit-equal to a serial
    ``stylize_int8`` of the same images, each top-1 a serial ``classifier_apply_int8``'s
    of the same batch, K2 16 a stylize batch plus 52 a classify batch (counter zeroed
    just before), then each path alone; 0 K1 launches over it all; served images/s,
    p50/p99 latency, batch fill and where a request's time goes (decode, queue, the
    batch's dispatch, encode), beside the direct ms/image; then ``python -m
    artist_style_transfer_tpu_torch.infer.http_server`` in a subprocess with
    ``--models-dir`` (a ``.pth`` and an ``.npz`` of one epoch: the ``.npz`` chosen),
    ``--quantize``, ``--classifier-path`` the CLI's ``best-2.pth`` and ``--port 0``: its
    port read from stdout, one stylize and one classify answered, exit 0 within 10 s of
    SIGINT;
15. parallel: data-parallel training and evaluation and row-sharded stylization at full
    width (the TransformerNet, the ResNet-50). Part 1, a world of one over NCCL in this
    process, through the entry points, against their mesh-less runs: ``train(mesh=)``
    'cycle' at 224x224, B=4, one epoch (losses within rtol 1e-4, 4 + 4*4 = 20 K1
    launches), the training CLI with ``--data_parallel`` on 16 seeded JPEGs,
    ``train_classifier(mesh=)`` at 256x256, B=32 on 160 seeded paintings (one epoch),
    ``evaluate_with_classifier(mesh=)`` f32 and int8 on 4 seeded 1024x1024 images (the
    same ``Acc=`` and ``Pred=`` lines), ``stylize_spatial`` and ``stylize_spatial_int8`` of
    a seeded 512x512 image (> 45 dB against ``stylize`` / ``stylize_int8``). Part 2, two
    ranks on cuda:0 over gloo (NCCL refuses two ranks on one card), in the launch of 2
    ranks that phases 15-17 share (their jobs one after another): the same
    'cycle' run with a global B=4 (losses within rtol 1e-4 of the single process, the
    ranks' params bit-identical, K1 20 a rank), ``stylize_spatial`` (> 45 dB),
    ``stylize_spatial_int8`` (within 1.5, mean under 0.2, of ``stylize_int8``; 16 K2
    launches a band; the first banded conv's codes and int32 sums identical to the
    single-device ones), the sharded int8 eval (its ``Acc=`` and ``Pred=`` lines, 68 K2
    launches a rank), ``train_classifier`` with global-batch BN (the epoch loss within
    rtol 1e-2); then K2 against its plain version at every band shape of both ranks
    (int32 error 0). Wall and device times of each part, and the collectives' times
    from the profiler's ``gloo:``/``nccl:`` ranges and NCCL's kernels. In part 1 also
    the world of one's ``train_classifier`` stepped in lockstep with the mesh-less one
    and a second mesh-less one (one epoch, 256x256, B=32; ``parallel_lockstep``
    lines): the first step and layer where BN outputs, gradients, running statistics
    and parameters part, each trainer's first step against the same step in f64; once
    as the trainers run and once with deterministic algorithms, where the two mesh-less
    trainers must be bit-identical;
16. space_train: training over a ('data', 'space') mesh at full width ('cycle', 224x224,
    global B=4, 16 seeded images, 8 paintings), each image's rows spread over the
    'space' ranks: a world of one over NCCL with mesh (1, 1) (the banded code, no
    exchange); 2 gloo ranks on cuda:0 with mesh (1, 2): one f32 epoch (per-step losses
    within rtol 1e-4 of the one-process ``train()``, the ranks' params bit-identical, K1
    20 launches a rank), two bf16 epochs (finite, falling), a streamed epoch through
    ``content_stream=`` (within rtol 1e-3 of the resident one), one 1024x1024, B=1 step
    (within rtol 1e-4 of the one process's, and each rank's peak memory over the step
    beside the one process's); 4 gloo ranks with mesh
    (2, 2): the f32 epoch again. Then 'classifier' mode and the int8 options over the
    axis (the ResNet-50 with 19 classes too): 2 gloo ranks with mesh (1, 2), one epoch
    each of 'classifier' f32 (within rtol 1e-4 of the one-process ``train()``) and bf16
    (finite), 'cycle' with ``quantize_loss=True``, with ``qat=True, quantize_gram=True``
    (the int8 Gram on the real VGG16's taps) and with ``qat="all"``, and 'classifier'
    through ``quantize_classifier`` with ``quantize_loss=True`` (on 8 images: 2 steps;
    the int8 runs within rtol 1e-2 of one process), and one 'classifier' f32 step at
    1024x1024, B=1 (within rtol 1e-4; each rank's peak memory beside the one
    process's); 4 gloo ranks with
    mesh (2, 2): the ``qat``/``quantize_gram`` and the int8 'classifier' runs; every
    run's ranks bit-identical, params, losses and dynamic int8 scales; K1 and K2
    launches a rank counted (K2 12 a step + 6 for ``quantize_loss``, 26, 32 and 104;
    K1 2, 2 and 4 a step + 4; 0 in 'classifier' mode). Then K1 against its plain
    version and an f64 product at every band shape the ranks launched it at
    (``space_train_k1`` lines: warm and cold times, the plain version's,
    ``torch.bmm``'s, the bound), and K2 against its plain version at every shape the
    int8 runs' ranks launched it at, forward and dgrad (``qconv`` lines with path
    ``train_space``, warm times); wall seconds and rank 0's ``gloo:`` host ms;
17. space_more: evaluation, artist-classifier training and diffusion training over a
    ('data', 'space') mesh at full width on gloo ranks on the card, against their one
    process in this process: ``evaluate_with_classifier`` of one 1024x1024, B=4 batch
    (crop 256), f32 and ``quantize=True``, over (1, 2) and (2, 2) (``Acc=``/``Pred=``
    equal, f32 logits within 1e-3 of max, 0 K1, K2 68 a rank in int8 and exact at every
    band shape: ``qconv`` lines with path ``eval_int8_space``); ``train_classifier`` at
    256x256, B=32, 160 images over (1, 2), one epoch frozen (within 5e-3) and one
    unfrozen (read beside the one process's own run-to-run distance), an unfrozen
    512x512, B=8 step (within 1e-4; peak memory a rank); ``train_diffusion`` at the CLI's
    defaults, 128 images, one epoch over (1, 2) and (2, 2) (within 1e-4), a 256x256, B=8
    step (peak memory a rank); ranks bit-identical; ms a step and rank 0's gloo ms;
18. kernel_rows: K1 at the DP 'cycle' rank's taps (224x224, N=2) and K2 at the serve
    batches' shapes (``stylize_int8`` 512x512 and the int8 classify 256x256 at B = 1, 2
    and 8), the sharded int8 eval's (N=2) and one DP int8 training step's (N=2), each
    recorded from the path's own function and held against its plain version, with
    warm times, bounds and the library yardsticks;
19. diffusion: the class-conditional UNet at the diffusion CLI's defaults (64x64, base
    64, 19 classes, T = 1000, B = 32, 15,118,659 parameters): ``diff_model_apply`` with
    every weight redrawn (within 1e-4 of max of the port's CPU) and guided DDIM-20 from
    one x_T (> 45 dB against the CPU); ``train_diffusion`` for 2 epochs on 128 seeded
    images (finite, falling; warm ms/step, the step's FLOPs and bound, peak memory); ms
    per model evaluation of DDPM, DDIM-50 and DPM++-20 at B=16, with and without
    guidance; the diffusion CLI's ``train``, ``sample`` (guided DDIM, DPM++) and ``eval``
    (16 samples), at T = 250, on a seeded workspace; then the CFID quality curve at the
    config of ``tests/goldens/diffusion_cfid_curve.json`` (32x32, 2 classes, 256 real and 128
    generated images, 80 epochs, base 32, cosine) for its 12 sampler configurations,
    with the orderings of ``tests/test_diffusion.py`` held at 3 decimals; K1 and K2
    0 launches on every one of these paths;
20. in_q8: the fused instance norm of the int8 TransformerNet (``csrc/in_q8.cu``) on the
    real accumulators of ``forward`` at 1024x1024, B = 8 and 4, bf16 and int32
    accumulators (each distinct call of a forward once): its bf16 stream and int8 codes
    bit-equal to the plain op's on the card and between two runs, and the whole
    forward's output bit-equal to the plain forward's; a CUDA accumulator with C = 12
    refused; 17 fused calls and 16 K2 launches a ``stylize_int8`` batch of 8; its time
    warm (events) and, for the bf16 forwards, the call's and each kernel's cold device
    time (profiler), beside the plain op's and the bytes bounds (read once; as moved);
21. timing: each phase's seconds on the host clock (phases 15-17 their work in this
    process, phase 16's 'classifier' and int8 runs under ``space_train_more`` and its
    K1 checks under ``space_train_k1``; ``ranks_2`` and ``ranks_4`` the one launch of 2
    and of 4 gloo ranks on cuda:0 that runs their rank jobs: one start-up and warm-up a
    world size) and the total; then the kernels line; the card line; then ``{"ok": true, ...}`` last.

Imports neither JAX nor the JAX package, nor PIL; OpenCV only inside the
phases that write or read images (``eval``'s CLI step, ``data``,
``train_artist_classifier``, ``serve``, ``diffusion``). Without CUDA,
or without the port's package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections.abc import Generator

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
GRAM_SOURCE = "artist_style_transfer_tpu_torch/csrc/gram.cu"
GRAM_REPLACES = "artist_style_transfer_tpu/ops/pallas/gram_kernel.py:60"  # gram_matrix_pallas
QCONV_SOURCE = "artist_style_transfer_tpu_torch/csrc/qconv.cu"
# The XLA int8 convs K2 replaces (PyTorch has no int8 conv on CUDA).
QCONV_REPLACES = ("artist_style_transfer_tpu/models/transformer_q.py:62; "
                  "artist_style_transfer_tpu/ops/qconv.py:68; "
                  "artist_style_transfer_tpu/models/resnet_q.py:111")

# Published dense peaks (NVIDIA data sheets) by H100 variant: FP32 outside
# the tensor cores, TF32, bf16 and int8 (operations/s) tensor cores, HBM bandwidth.
# At full power limit.
PEAKS = {
    "H100 SXM": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12, "hbm": 3.35e12},
    "H100 PCIe": {"fp32": 51e12, "tf32": 378e12, "bf16": 756e12, "int8": 1513e12, "hbm": 2.0e12},
    "H100 NVL": {"fp32": 60e12, "tf32": 418e12, "bf16": 835e12, "int8": 1671e12, "hbm": 3.9e12},
}
# Host-side calls of a profiled window worth counting: the ones that wait for the device
# (a synchronous copy ends in cudaStreamSynchronize), pin memory, or launch.
HOST_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaHostAlloc", "cudaMemcpyAsync", "cudaLaunchKernel", "aten::pin_memory",
              "aten::_pin_memory", "aten::copy_")
FLUSH_BYTES = 256 << 20  # written between timed calls: more than the H100's 50 MB L2

TAPS = (("relu1_2", 1, 64), ("relu2_2", 2, 128), ("relu3_3", 4, 256), ("relu4_3", 8, 512))
GATYS_SIZE = 256
GATYS_STEPS = 300
# The 'cycle' train phase: reference TRAIN_SIZE and batch (train_cnn.py:28, :144).
TRAIN_SIZE = 224
TRAIN_BATCH = 4
TRAIN_CONTENT = 16
TRAIN_PAINTINGS = 8
TRAIN_EPOCHS = 3
# The classifier paths: the reference eval transform's crop (inference.py:56-59), its
# resize_size and batch (InferenceConfig), and the 'classifier' train artist.
CLF_SIZE = 256
CLF_BATCH = 4
EVAL_SIZE = 1024
EVAL_IMAGES = 16
EVAL_CPU_IMAGES = 2
EVAL_CLI_IMAGES = 4
CLF_ARTIST = "Pablo_Picasso"
# The data phase: the reference's content corpus size (content_data_size=256) and three
# artists of the Kaggle archive layout, the trained one with 64 paintings.
DATA_CONTENT = 256
DATA_ARTISTS = (("Seeded Artist", 64), ("Second Artist", 8), ("Third Artist", 8))
DATA_EPOCHS = 2
DATA_PARITY_IMAGES = 32
DATA_PROFILE_STEPS = 8
# The int8 phase: the flagship stylize shape (512x512, B=4); the eval phase's images.
INT8_SIZE = 512
INT8_BATCH = 4
INT8_CLI_IMAGES = 4
# Launches of K2: 16 int8 convs a TransformerNet forward, 52 a ResNet-50 forward.
QCONV_TRANSFORMER = 16
QCONV_RESNET = 52
# The fused instance norm (csrc/in_q8.cu): the int8 TransformerNet's 17 instance norms (the
# stem's and the 16 int8 convs') a forward, one call each, checked at the benchmark's
# stylize and eval batches at 1024x1024.
IN_Q8_SOURCE = "artist_style_transfer_tpu_torch/csrc/in_q8.cu"
IN_Q8_FORWARD = 17
IN_Q8_SIZE = 1024
IN_Q8_BATCHES = (8, 4)
# The int8 training phase: the train phase's 'cycle' shapes in bf16. Int8 convs of a
# step, each launching K2 twice (forward and STE data gradient): the VGG16's conv3_1..
# conv4_3 under quantize_loss "deep", the QAT TransformerNet's 128-channel convs under
# "trunk" (JAX's gate cout < 128: encoder convs 3-4, 10 residual, decoder conv 1) or its
# 16 interior ones under "all", the ResNet-50's 52.
INT8_TRAIN_EPOCHS = 3
QCONV_VGG_DEEP = 6
QCONV_QAT = {"trunk": 13, "all": 16}
INT8_GRAM_TAPS = (("relu3_3", 4, 256), ("relu4_3", 8, 512))  # the taps the int8 Gram takes
INT8_TRAIN_TAPS = ("relu1_2", "relu2_2")  # the taps an int8 training step sends to K1
INT8_CLI_CONTENT = 16
# The artist-classifier training phase: the classifier CLI's defaults (256x256 rescale,
# batch 32; JAX train/classifier.py:320-345) on about 160 seeded paintings of 19 artists;
# the CLI on phase data's 80 paintings (64 to train): batch 16 gives the one-cycle
# schedule the 4 steps it needs.
ARTIST_CLF_IMAGES = 160
ARTIST_CLF_SIZE = 256
ARTIST_CLF_BATCH = 32
ARTIST_CLF_CLASSES = 19
ARTIST_CLF_EPOCHS = 3  # freeze_body=True; then 1 epoch with the body unfrozen
ARTIST_CLF_CLI_BATCH = 16
# The serve phase: the flagship 512x512 and JAX http_server.py's batcher defaults
# (max_batch 8, max_wait_ms 3): 32 stylize requests from 8 client threads, with 8
# classify requests at 300x280 among them, one smaller than the 256 crop.
SERVE_SIZE = 512
SERVE_REQUESTS = 32
SERVE_CLIENTS = 8
SERVE_MAX_BATCH = 8
SERVE_MAX_WAIT_MS = 3.0
SERVE_CLASSIFY = 8
SERVE_ROUNDS = 2  # timed rounds of each traffic mix, after a warm-up round: their range
CLASSIFY_HW = (300, 280)
CLASSIFY_SMALL_HW = (200, 180)
# The parallel phase: a world of one over NCCL in this process, then 2 ranks on cuda:0
# over gloo (NCCL refuses two ranks on one card as a duplicate GPU).
PAR_RANKS = 2
PAR_TRAIN_EPOCHS = 1  # 'cycle' at 224², global B=4, 16 images: 4 steps
PAR_SPATIAL = 512  # stylize_spatial(_int8) of one flagship image over the ranks' row bands
PAR_EVAL_IMAGES = 4  # one eval batch at 1024², B=4
PAR_CLF_EPOCHS = 1  # train_classifier at 256², B=32, 160 images: 4 steps
PAR_CLI_CONTENT = 16  # the training CLI --data_parallel on a small seeded workspace
# train_classifier's epoch loss, the mean of 4 steps, against the single process: the
# train-mode ResNet-50 amplifies the f32 rounding of another BN function (or another
# split of the batch) and Adam's sign-like steps part the later steps further. On an
# H100 80GB HBM3 at 700 W the world of one read 6.4e-4, 8.0e-4, 8.9e-4 and 1.34e-3 and
# 2 ranks 1.3e-4, 1.4e-4, 1.7e-4 and 2.1e-4 (four runs of this phase; on the CPU one
# ulp on the input images moves it 6.2e-4 at 32²); the BN itself is held at 1e-5 by the
# CPU tests. A batch norm on each rank's own half is caught exactly instead: the ranks'
# running statistics would differ.
PAR_CLF_RTOL = 5e-3
SPACE_EPOCHS = 1  # phase space_train: 'cycle' at 224², global B=4, 16 images: 4 steps
SPACE_MEM_SIZE = 1024  # one step at 1024², B=1: each rank's peak memory against one process's
SPACE_STREAM_RTOL = 1e-3  # the streamed bar (PERF.md §2)
SPACE_INT8_RTOL = 1e-2  # the banded int8 runs' per-step losses against one process (PERF.md §6)
# K2 launches a step of each banded int8 run (forward + STE dgrad on every rank's band), and
# its targets' (the int8 VGG16's forward of the 8 paintings): phase int8_train's counts.
SPACE_K2_STEP = {"qloss": 2 * QCONV_VGG_DEEP, "qat_qgram": 2 * QCONV_QAT["trunk"],
                 "qat_all": 2 * QCONV_QAT["all"], "qclf": 2 * QCONV_RESNET}
# The int8 'classifier' run over the axis takes the first 8 content images: 2 steps, so
# that its second loss holds the first step's backward against one process. Its banded
# step waits on 208 scale all-reduces over gloo (4.6 s a step on (1, 2)).
SPACE_QCLF_CONTENT = 8
# Phase space_more: evaluation, artist-classifier and diffusion training over a ('data',
# 'space') mesh, each against its one process in the phase's own process.
SPACE_MORE_EVAL = 4  # one eval batch of the eval phase's 1024² images, B=4, crop 256
SPACE_MORE_CLF_EPOCHS = 1  # train_classifier at 256², B=32, 160 images: 4 steps, each freeze
SPACE_MORE_DIFF_IMAGES = 128  # train_diffusion at the CLI's defaults, one epoch: 4 steps
SPACE_MORE_DIFF_RTOL = 1e-4
# The first step's synced gradients of the 256² UNet step over (1, 2) and the 512²
# classifier step's BN statistics: each leaf within this share of its module's largest
# entry of the one process's (statistics: of its own). The classifier's f32 gradients are
# read, not held: this ResNet-50 in train mode turns rounding into a 3% L2 difference of
# its body's gradients (f32 against f64 on the CPU, the bands against one process on
# the card); the same step in f64 is held at SPACE_MORE_F64_RTOL.
SPACE_MORE_GRAD_RTOL = 1e-4
SPACE_MORE_STATS_RTOL = 1e-3
SPACE_MORE_F64_RTOL = 1e-6
SPACE_MORE_MEM = {"classifier": 512, "diffusion": 256}  # one step at B=8: peak memory a rank
SPACE_MORE_MEM_BATCH = 8
SERVE_ROW_BATCHES = (1, 2, 8)  # phase kernel_rows: K2 at the serve batches (4 is phase int8's)
# Phase diffusion at the diffusion CLI's defaults (JAX diffusion/cli.py:20-29).
DIFF_SIZE = 64
DIFF_BASE = 64
DIFF_CLASSES = 19
DIFF_T = 1000
DIFF_BATCH = 32
DIFF_TRAIN_IMAGES = 128
DIFF_EPOCHS = 2
DIFF_WARM_STEPS = 10
DIFF_CPU_IMAGES = 2  # the card-vs-CPU UNet and guided DDIM
DIFF_CPU_DDIM_STEPS = 20  # the card-vs-CPU guided DDIM (the CPU's run: 6-13 s at 50)
DIFF_SAMPLE_BATCH = 16  # ms per model evaluation of each sampler
DIFF_DDIM_STEPS = 50
DIFF_DPMPP_STEPS = 20
DIFF_CLI_ARTISTS = (("Alfred Sisley", 24), ("Vincent van Gogh", 24))
DIFF_CLI_BATCH = 16
DIFF_CLI_SAMPLES = 16
DIFF_CLI_T = 250  # the CLI's train, sample and eval: its DDPM eval runs T model evaluations
# The CFID quality curve at the config of tests/goldens/diffusion_cfid_curve.json.
CURVE_SIZE = 32
CURVE_CLASSES = 2
CURVE_REAL = 256
CURVE_GEN = 128
CURVE_EPOCHS = 80
CURVE_BASE = 32
CURVE_LR = 2e-4
CURVE_BATCH = 32
CURVE_CONFIGS = ("ddpm-1000", "ddim-50", "ddim-20", "ddim-10", "ddim-5", "ddim-3", "ddim-2",
                 "dpmpp-20", "dpmpp-12", "dpmpp-8", "dpmpp-4", "dpmpp-2")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks_for(name: str) -> tuple[str, dict]:
    variant = "H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name else "H100 SXM"
    return variant, PEAKS[variant]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# device_ms's readings by the kernel name they count and by their source: "profiler", or
# "events" where no profiled window recorded any device event. The kernels line reads it.
DEVICE_MS_SOURCES: dict[str, dict[str, int]] = {}


def device_ms(fn, kernel: str, iters: int = 20, attempts: int = 5) -> float:
    """Device time per call of ``fn`` from ``torch.profiler``, with L2 flushed before each call.

    Counts the kernels whose name holds ``kernel`` (``""``: every kernel of
    ``fn``), which must run the same number of times in every call; the
    flush's own fill kernel never counts. The profiler now and then drops
    device events (seen on the H100 machine: 11 or 18 of 20 launches
    recorded), so each window is a warm-up cycle of the profiler followed by
    the recorded one, and a window that still lost events is taken again, up
    to ``attempts`` times. Where no window recorded any device event, each flushed
    call is timed with CUDA events instead, an upper bound that covers every kernel of
    ``fn``: a ``device_ms_fallback`` line says so, and :data:`DEVICE_MS_SOURCES` counts
    the reading under "events".
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    sources = DEVICE_MS_SOURCES.setdefault(kernel, {"profiler": 0, "events": 0})
    blind = True
    for _ in range(attempts):
        recorded = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
            for _ in range(2):  # the profiler's warm-up cycle, then the recorded one
                for _ in range(iters):
                    flush.fill_(1.0)
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # The schedule's ``ProfilerStep#`` range shows on the device as a user
        # annotation; it is no kernel.
        rows = [ev for ev in (recorded[0] if recorded else [])
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not getattr(ev, "is_user_annotation", False)
                and not ev.key.startswith("ProfilerStep")
                and "FillFunctor" not in ev.key and kernel in ev.key]
        launches = sum(ev.count for ev in rows)
        if launches > 0 and launches % iters == 0:
            sources["profiler"] += 1
            return sum(ev.self_device_time_total for ev in rows) / 1e3 / iters
        blind = blind and not any(ev.device_type == DeviceType.CUDA
                                  for ev in (recorded or [[]])[0])
    if blind:
        # No device event at all in any window: the profiler lost the card (seen once on
        # the H100 machine, after many profiled phases). Time each flushed call with CUDA
        # events instead, an upper bound on the device time (launch gaps included).
        emit("device_ms_fallback", kernel=kernel, attempts=attempts)
        total = 0.0
        for _ in range(iters):
            flush.fill_(1.0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        sources["events"] += 1
        return total / iters
    raise SystemExit(f"chip_smoke: FAILED: device_ms: {launches} launches of '{kernel}' "
                     f"recorded over {iters} calls, {attempts} times: "
                     f"{[(ev.key[:60], ev.count) for ev in rows]}")


def gram_bound(n: int, hw: int, c: int, dtype: torch.dtype, peaks: dict) -> tuple[float, float]:
    """(operations ms, bytes ms): the least time for a Gram on these inputs.

    Operations count the C(C+1)/2 distinct entries, HW*C*(C+1) FLOPs an
    image. f32 needs an f32-accurate product: FP32 on the CUDA cores or
    3xTF32 on the tensor cores, whichever is faster; bf16 runs at the bf16
    tensor-core rate. Bytes: F read once, G written once.
    """
    flops = float(n) * hw * c * (c + 1)
    if dtype == torch.float32:
        t_ops = min(flops / peaks["fp32"], 3 * flops / peaks["tf32"])
    else:
        t_ops = flops / peaks["bf16"]
    nbytes = n * hw * c * (4 if dtype == torch.float32 else 2) + n * c * c * 4
    return t_ops * 1e3, nbytes / peaks["hbm"] * 1e3


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_header() -> str:
    from artist_style_transfer_tpu_torch.ops import precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    try:  # recorded only: no kernel of the port is written in Triton
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit(
        "header",
        triton=triton_version,
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(),
        nvidia_smi=smi,
        precision=precision.get_precision(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction),
    )
    require(not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 is on in parity mode")
    require(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on in parity mode")
    return smi


def sass_by_function(lib_path) -> dict[str, list[str]]:
    """``cuobjdump -sass`` of the kernel library, its lines grouped by kernel (mangled name)."""
    from artist_style_transfer_tpu_torch.ops.cuda import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    lines = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    funcs: dict[str, list[str]] = {}
    current = None
    for ln in lines:
        if "Function : " in ln:
            current = ln.split("Function : ", 1)[1].strip()
            funcs[current] = []
        elif current is not None:
            funcs[current].append(ln)
    return funcs


def ptxas_report(log: str) -> list[dict]:
    """Each kernel's registers, shared memory and spills from ``nvcc --ptxas-options=-v``."""
    import re

    out, current = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m:
            if current is None or current["function"] != m.group(1):
                current = {"function": m.group(1)}
                out.append(current)
            continue
        if current is None:
            continue
        for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                current[key] = int(m.group(1))
    return [r for r in out if "registers" in r]


def phase_build() -> None:
    from artist_style_transfer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    info = build.last_build
    lib_path = build.BUILD_DIR / build.LIB_NAME
    funcs = sass_by_function(lib_path)
    sass = [ln for body in funcs.values() for ln in body]
    mma = {kind: sum(1 for ln in sass if "MMA" in ln and f".{kind.upper()}" in ln)
           for kind in ("tf32", "bf16")}
    ffma = sum(1 for ln in sass if " FFMA " in ln)
    # K2: the s8 warpgroup MMA (IGMMA) in every instantiation, and no mma.sync IMMA left.
    k2 = {name: body for name, body in funcs.items() if "qconv_kernel" in name}
    igmma = {name: sum(1 for ln in body if "IGMMA" in ln) for name, body in k2.items()}
    imma = sum(1 for ln in sass if "IMMA" in ln)
    ptxas = ptxas_report(info["log"]) if info["built"] else []
    emit("build", seconds=time.perf_counter() - t0, compiled=info["built"],
         nvcc_seconds=info["seconds"], library=str(lib_path), ptxas=ptxas,
         sass_mma=mma, sass_ffma=ffma, k2_instantiations=len(k2),
         sass_igmma=sum(igmma.values()), sass_imma=imma)
    require(all(v > 0 for v in mma.values()), f"no tensor-core MMA in the SASS of a dtype: {mma}")
    require(len(k2) > 0 and all(v > 0 for v in igmma.values()),
            f"K2 instantiations without the s8 warpgroup MMA (IGMMA) in their SASS: {igmma}")
    require(imma == 0, f"{imma} IMMA (mma.sync int8) left in the kernel library")


def phase_gram(peaks: dict) -> dict:
    from artist_style_transfer_tpu_torch.ops import gram as gram_ops
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst_abs = worst_rel = 0.0
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    main = dict.fromkeys(keys, 0.0)  # the 4 taps of a Gatys step (256², N=1, f32)
    train = dict.fromkeys(keys, 0.0)  # the 4 taps of a train step (224², N=4, f32)
    train_bf16 = dict.fromkeys(keys, 0.0)  # the same in bf16, the bf16 train step's
    int8_train = dict.fromkeys(keys, 0.0)  # relu1_2 and relu2_2 of it: the int8 train step's
    for size, n in ((GATYS_SIZE, 1), (TRAIN_SIZE, TRAIN_BATCH), (512, 4)):
        for tap, down, c in TAPS:
            hw = (size // down) ** 2
            for dtype in (torch.float32, torch.bfloat16):
                f = torch.rand((n, size // down, size // down, c), generator=gen,
                               device="cuda").to(dtype)
                g_kernel = gram_kernel.gram_matrix_cuda(f)
                g_plain = gram_ops.gram_matrix_plain(f.float())
                torch.cuda.synchronize()
                abs_err = (g_kernel - g_plain).abs().max().item()
                rel_err = abs_err / g_plain.abs().max().item()
                # Both against an f64 product, to say which of the two rounds more.
                f64 = f.double().reshape(n, hw, c)
                g64 = torch.bmm(f64.transpose(1, 2), f64) / float(c * hw)
                g64_max = g64.abs().max().item()
                kernel_vs_f64 = (g_kernel.double() - g64).abs().max().item() / g64_max
                plain_vs_f64 = (g_plain.double() - g64).abs().max().item() / g64_max
                tol = 1e-4 if dtype == torch.float32 else 1e-3
                require(rel_err <= tol, f"gram {tap} {size}^2 n{n} {dtype}: rel err {rel_err}")
                worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)

                grad_rel = None
                if dtype == torch.float32:
                    require(kernel_vs_f64 <= 5e-6,
                            f"gram {tap} {size}^2 n{n}: kernel vs f64 {kernel_vs_f64}")
                    r = torch.randn((n, c, c), generator=gen, device="cuda")
                    grads = []
                    for use_kernel in (True, False):
                        x = f.clone().requires_grad_(True)
                        (gram_ops.GramFunction.apply(x, use_kernel) * r).sum().backward()
                        grads.append(x.grad)
                    grad_rel = ((grads[0] - grads[1]).abs().max()
                                / grads[1].abs().max()).item()
                    require(grad_rel <= 1e-4, f"gram grad {tap} {size}^2: rel err {grad_rel}")

                scale = 1.0 / float(c * hw)
                f3 = f.reshape(n, hw, c)
                run_kernel = lambda: gram_kernel.gram_matrix_cuda(f)  # noqa: E731
                run_library = lambda: torch.bmm(f3.transpose(1, 2), f3) * scale  # noqa: E731
                kernel_ms = time_ms(run_kernel)
                plain_ms = time_ms(lambda: gram_ops.gram_matrix_plain(f))
                library_ms = time_ms(run_library)
                kernel_dev = device_ms(run_kernel, "gram_tile_kernel")
                library_dev = device_ms(run_library, "")
                t_ops, t_bytes = gram_bound(n, hw, c, dtype, peaks)
                bound_ms = max(t_ops, t_bytes)
                require(kernel_dev >= bound_ms / 1.05,
                        f"gram {tap} {size}^2 n{n} {dtype}: device {kernel_dev} ms under the "
                        f"bound {bound_ms} ms: the bound is miscounted")
                plan = gram_kernel.gram_plan(n, hw, c, sms)
                flops = float(n) * hw * c * (c + 1)
                emit("gram", tap=tap, size=size, n=n, hw=hw, c=c, dtype=str(dtype)[6:],
                     tile=plan.tile, tiles=len(plan.pairs), splits=plan.splits,
                     rows_per_split=plan.rows,
                     max_abs_err=abs_err, max_rel_err=rel_err, grad_rel_err=grad_rel,
                     kernel_vs_f64_rel=kernel_vs_f64, plain_vs_f64_rel=plain_vs_f64,
                     kernel_ms=kernel_ms, device_ms=kernel_dev, plain_ms=plain_ms,
                     library_ms=library_ms, library_device_ms=library_dev,
                     bound_ms=bound_ms, bound_by="operations" if t_ops >= t_bytes else "bytes",
                     bound_share=bound_ms / kernel_dev, gflop=flops / 1e9,
                     kernel_tflops=flops / kernel_dev / 1e9)
                sums = {(GATYS_SIZE, torch.float32): main, (TRAIN_SIZE, torch.float32): train,
                        (TRAIN_SIZE, torch.bfloat16): train_bf16}.get((size, dtype))
                targets = [] if sums is None else [sums]
                if (size, dtype) == (TRAIN_SIZE, torch.bfloat16) and tap in INT8_TRAIN_TAPS:
                    targets.append(int8_train)
                for s in targets:
                    for k, v in zip(keys, (kernel_ms, kernel_dev, plain_ms, library_ms,
                                           bound_ms, t_ops, t_bytes)):
                        s[k] += v
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **main, "train_taps": train,
            "train_taps_bf16": train_bf16, "int8_train_taps_bf16": int8_train}


def phase_stylize() -> None:
    from artist_style_transfer_tpu_torch.infer.stylize import (
        load_transfer_params,
        stylize,
        stylize_batched,
    )
    from artist_style_transfer_tpu_torch.utils.images import read_png

    pth = os.path.join(GOLDENS, "golden_transfer.pth")
    content = read_png(os.path.join(GOLDENS, "content_landscape_256.png"))
    golden = read_png(os.path.join(GOLDENS, "golden_stylized.png"))
    model = load_transfer_params(pth, device="cuda")
    out = stylize(model, content[None], device="cuda")[0].cpu().numpy()
    require(out.shape == golden.shape, f"stylize shape {out.shape} vs golden {golden.shape}")
    out_cpu = stylize(load_transfer_params(pth, device="cpu"), content[None], device="cpu")
    p_golden, p_cpu = psnr(out, golden), psnr(out, out_cpu[0].numpy())
    require(p_golden > 35.0, f"golden PSNR {p_golden} dB")
    require(p_cpu > 45.0, f"card vs CPU PSNR {p_cpu} dB")

    rng = np.random.default_rng(0)
    batch = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(4)]
    for _ in range(2):
        stylize_batched(model, batch, batch_size=4, device="cuda")
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        outs = stylize_batched(model, batch, batch_size=4, device="cuda")
    ms = (time.perf_counter() - t0) * 1e3 / reps
    require(all(o.shape == (512, 512, 3) and o.dtype == np.uint8 for o in outs),
            "stylize_batched output shape")
    emit("stylize", golden_psnr_db=p_golden, card_vs_cpu_psnr_db=p_cpu,
         batch=4, size=512, ms_per_batch=ms, ms_per_image=ms / 4)


def phase_gatys() -> int:
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel
    from artist_style_transfer_tpu_torch.train.gatys import gatys_stylize

    vgg = init_vgg16(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(1)
    content = rng.uniform(0, 255, (GATYS_SIZE, GATYS_SIZE, 3)).astype(np.float32)
    style = rng.uniform(0, 255, (GATYS_SIZE, GATYS_SIZE, 3)).astype(np.float32)

    traces = [
        gatys_stylize(vgg, content, style, num_steps=5, use_kernel=k, device="cuda")[1].cpu()
        for k in (True, False)
    ]
    trace_rel = ((traces[0] - traces[1]).abs() / traces[1].abs()).max().item()
    require(trace_rel <= 1e-4, f"gatys 5-step trace kernel vs plain: rel {trace_rel}")

    # The main path: counter zeroed just before, read just after.
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    gram_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    out, losses = gatys_stylize(vgg, content, style, num_steps=GATYS_STEPS, device="cuda")
    losses = losses.cpu().numpy()
    seconds = time.perf_counter() - t0
    launches = gram_kernel.LAUNCHES
    require(tuple(out.shape) == (GATYS_SIZE, GATYS_SIZE, 3), f"gatys output {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()) and np.isfinite(losses).all(), "gatys not finite")
    require(losses[-1] < losses[0], f"gatys loss did not fall: {losses[0]} -> {losses[-1]}")
    require(launches == 4 + 4 * GATYS_STEPS, f"gram launches {launches} != {4 + 4 * GATYS_STEPS}")
    emit("gatys", kernel_vs_plain_trace_rel=trace_rel, steps=GATYS_STEPS, size=GATYS_SIZE,
         loss_first=float(losses[0]), loss_last=float(losses[-1]), seconds=seconds,
         ms_per_step=seconds * 1e3 / GATYS_STEPS, gram_launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def train_data(size: int = TRAIN_SIZE) -> tuple[np.ndarray, np.ndarray]:
    """Seeded content images and paintings, NHWC BGR [0,255] f32."""
    rng = np.random.default_rng(2)
    content = rng.uniform(0, 255, (TRAIN_CONTENT, size, size, 3)).astype(np.float32)
    paintings = rng.uniform(0, 255, (TRAIN_PAINTINGS, size, size, 3)).astype(np.float32)
    return content, paintings


def train_step_fns(vgg, content: np.ndarray, paintings: np.ndarray | None, use_kernel,
                   device: str, compute_dtype: str = "float32", classifier=None, qat=False):
    """Step functions from ``init_transformer`` seed 0, and the corpus on ``device``:
    'cycle', or 'classifier' when a classifier is given; ``vgg`` and ``classifier`` may
    be quantized, and ``qat`` runs the QAT TransformerNet."""
    from artist_style_transfer_tpu_torch.models.transformer import init_transformer
    from artist_style_transfer_tpu_torch.train.loop import (
        make_optimizer,
        make_step_fns,
        precompute_content_relu2_2,
    )
    from artist_style_transfer_tpu_torch.train.styles import build_style_targets

    mode = "cycle" if classifier is None else "classifier"
    model = init_transformer(torch.Generator().manual_seed(0), device)
    targets = build_style_targets(mode, vgg, CLF_ARTIST, paintings=paintings,
                                  batch_size=TRAIN_BATCH, use_kernel=use_kernel)
    steps = -(-len(content) // TRAIN_BATCH)
    opt, sched = make_optimizer(model.parameters(), 0.0024, 1e-4, TRAIN_EPOCHS, 2, steps)
    fns = make_step_fns(mode, model, vgg, targets, opt, sched, content_weight=17.0,
                        style_weight=25.0, batch_size=TRAIN_BATCH, num_content=len(content),
                        use_kernel=use_kernel, compute_dtype=compute_dtype,
                        classifier=classifier, qat=qat)
    data = torch.as_tensor(content, device=device)
    r22 = precompute_content_relu2_2(
        vgg, data, dtype=torch.bfloat16 if compute_dtype == "bfloat16" else None)
    return fns, data, r22


def warm_ms_per_step(fns, data: torch.Tensor, r22: torch.Tensor, epochs: int = 2) -> float:
    """ms a step over ``epochs`` epochs after a warm-up one (cuDNN's algorithm choice and
    first calls); host clock, ending in a sync."""
    perm = torch.arange(len(data))
    fns.epoch_fn(data, r22, perm, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in range(1, epochs + 1):
        fns.epoch_fn(data, r22, perm, e * fns.steps_per_epoch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (epochs * fns.steps_per_epoch)


def step_flops_and_bound(fns, data: torch.Tensor, r22: torch.Tensor, peaks: dict):
    """The FLOPs of one step as ``FlopCounterMode`` counts them (convs forward, dgrad and,
    where a weight trains, wgrad; matmuls), and their bound at f32 accuracy, as
    ``gram_bound`` counts K1's: FP32 on the CUDA cores or 3xTF32 on the tensor cores,
    whichever is faster. The step's bytes weigh far less."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fns.step_fn(data[:TRAIN_BATCH], r22[:TRAIN_BATCH], 0)
    flops = counter.get_total_flops()
    return flops, min(flops / peaks["fp32"], 3 * flops / peaks["tf32"]) * 1e3


def read_jsonl(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def phase_train(peaks: dict, size: int = TRAIN_SIZE, device: str = "cuda") -> tuple[int, int]:
    """The 'cycle' train() main path, its exports, kernel against plain, the step's
    FLOPs and bound, and a bf16 epoch.

    Returns the kernel launches of the f32 main path and of the bf16 epoch.
    """
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel
    from artist_style_transfer_tpu_torch.train import train

    vgg = init_vgg16(torch.Generator().manual_seed(0), device=device)
    content, paintings = train_data(size)
    steps_per_epoch = -(-TRAIN_CONTENT // TRAIN_BATCH)
    expect = 4 * -(-TRAIN_PAINTINGS // 8) + 4 * TRAIN_EPOCHS * steps_per_epoch
    kwargs = dict(batch_size=TRAIN_BATCH, seed=0, num_steps=2, save_every=1,
                  content_images=content, paintings=paintings, vgg=vgg, device=device,
                  wordy=False, log_every_batches=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # The main path: counter zeroed just before, read just after.
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        gram_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        model, losses = train("cycle", "Seeded", num_epochs=TRAIN_EPOCHS, model_dir=tmp, **kwargs)
        seconds = time.perf_counter() - t0
        launches = gram_kernel.LAUNCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        run_dir = os.path.join(tmp, "Seeded", "cycle")
        events = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
        steps = np.array([[e["content_loss"], e["style_loss"], e["total_loss"]]
                          for e in events if e["event"] == "batch"])
        epochs = [e for e in events if e["event"] == "epoch"]
        require(steps.shape == (TRAIN_EPOCHS * steps_per_epoch, 3),
                f"train: {steps.shape} per-step loss records")
        require(bool(np.isfinite(steps).all()) and bool(np.isfinite(losses).all()),
                "train: a loss is not finite")
        require(losses[-1, 2] < losses[0, 2],
                f"train: epoch {TRAIN_EPOCHS} total {losses[-1, 2]} not below epoch 1's "
                f"{losses[0, 2]}")
        require(launches == expect, f"train: gram launches {launches} != {expect}")
        warm = epochs[1:]
        warm_s = sum(e["secs"] for e in warm)
        warm_steps = len(warm) * steps_per_epoch

        # The exports reload and stylize, and give what the trained model gives.
        probe = content[:1]
        ref = stylize(model, probe, clip=False, device=device).float().cpu().numpy()
        reload_db = {}
        for ext in ("pth", "npz"):
            path = os.path.join(run_dir, f"transfer_17-25_{TRAIN_EPOCHS}.{ext}")
            out = stylize(load_transfer_params(path, device=device), probe, clip=False,
                          device=device).float().cpu().numpy()
            require(out.shape == ref.shape and bool(np.isfinite(out).all()),
                    f"train: the {ext} export did not stylize")
            db = psnr(out, ref)
            require(db > 45.0, f"train: {ext} export {db} dB from the model")
            reload_db[ext] = float(np.abs(out - ref).max())

        # Kernel against plain: 3 steps from the same init and data.
        traces = []
        for use_kernel in (True, False):
            fns, data, r22 = train_step_fns(vgg, content[: 3 * TRAIN_BATCH], paintings,
                                            use_kernel, device)
            traces.append(fns.epoch_fn(data, r22, torch.arange(len(data)), 0).cpu())
        trace_rel = ((traces[0] - traces[1]).abs() / traces[1].abs()).max().item()
        require(trace_rel <= 1e-4, f"train 3-step losses kernel vs plain: rel {trace_rel}")

        step_flops, step_bound_ms = step_flops_and_bound(fns, data, r22, peaks)

        # One epoch in bf16: K1's bf16 route on the train path.
        gram_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        _, bf16_losses = train("cycle", "Seeded", num_epochs=1, model_dir=None,
                               compute_dtype="bfloat16", **kwargs)
        bf16_seconds = time.perf_counter() - t0
        bf16_launches = gram_kernel.LAUNCHES
        require(bool(np.isfinite(bf16_losses).all()), "train bf16: a loss is not finite")
        require(bf16_launches == 4 + 4 * steps_per_epoch,
                f"train bf16: gram launches {bf16_launches} != {4 + 4 * steps_per_epoch}")
        bf16_ms = warm_ms_per_step(*train_step_fns(vgg, content, paintings, "auto", device,
                                                   compute_dtype="bfloat16"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("train", mode="cycle", size=size, batch=TRAIN_BATCH, content=TRAIN_CONTENT,
         paintings=TRAIN_PAINTINGS, epochs=TRAIN_EPOCHS, steps=int(steps.shape[0]),
         epoch_losses=losses.tolist(), step_total_first=float(steps[0, 2]),
         step_total_last=float(steps[-1, 2]), gram_launches=launches, seconds=seconds,
         epoch_secs=[e["secs"] for e in epochs], ms_per_step=warm_s * 1e3 / warm_steps,
         images_per_sec=warm_steps * TRAIN_BATCH / warm_s, step_gflop=step_flops / 1e9,
         step_bound_ms=step_bound_ms, step_bound_share=step_bound_ms * warm_steps / (warm_s * 1e3),
         peak_mem_gib=peak_gib,
         reload_max_abs_diff=reload_db, kernel_vs_plain_step_rel=trace_rel,
         bf16_epoch_losses=bf16_losses.tolist(), bf16_gram_launches=bf16_launches,
         bf16_seconds=bf16_seconds, bf16_ms_per_step_warm=bf16_ms)
    return launches, bf16_launches


def seeded_classifier(device: str):
    """The ResNet-50 artist classifier from ``init_classifier`` seed 0, with random BN
    running statistics (fresh BN's mean 0 / var 1 would hide a statistics bug), as the
    tests' ``randomize_bn_stats`` draws them."""
    from artist_style_transfer_tpu_torch.models.resnet import init_classifier

    model = init_classifier(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.5)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 2.0 + 0.5)
    return model.to(device)


def rel_to_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double().cpu() - ref.double().cpu()).abs().max() / ref.abs().max()).item()


def phase_classifier(peaks: dict) -> None:
    """The classifier on the card against the same module on the CPU, f32 parity mode."""
    from torch.utils.flop_counter import FlopCounterMode

    gpu, cpu = seeded_classifier("cuda"), seeded_classifier("cpu")
    x = torch.randn((CLF_BATCH, CLF_SIZE, CLF_SIZE, 3), generator=torch.Generator().manual_seed(3))
    xg = x.cuda()
    with torch.inference_mode():
        logits, feats = gpu(xg), gpu(xg, return_features=True)
        logits_cpu, feats_cpu = cpu(x), cpu(x, return_features=True)
        ms = time_ms(lambda: gpu(xg), iters=10)
    with FlopCounterMode(display=False) as counter:
        with torch.inference_mode():
            gpu(xg)
    flops = counter.get_total_flops()
    bound_ms = min(flops / peaks["fp32"], 3 * flops / peaks["tf32"]) * 1e3
    logit_rel, feat_rel = rel_to_max(logits, logits_cpu), rel_to_max(feats, feats_cpu)
    argmax, argmax_cpu = logits.argmax(-1).tolist(), logits_cpu.argmax(-1).tolist()
    require(tuple(logits.shape) == (CLF_BATCH, 19) and bool(torch.isfinite(logits).all()),
            f"classifier logits {tuple(logits.shape)}")
    require(logit_rel <= 1e-3, f"classifier card vs CPU logits: rel {logit_rel}")
    require(feat_rel <= 1e-3, f"classifier card vs CPU features: rel {feat_rel}")
    require(argmax == argmax_cpu, f"classifier argmax {argmax} vs CPU {argmax_cpu}")
    emit("classifier", size=CLF_SIZE, batch=CLF_BATCH,
         params=sum(p.numel() for p in gpu.parameters()), card_vs_cpu_logits_rel=logit_rel,
         card_vs_cpu_features_rel=feat_rel, argmax=argmax, max_abs_logit=logits.abs().max().item(),
         ms_per_batch=ms, gflop=flops / 1e9, bound_ms=bound_ms, bound_share=bound_ms / ms)


def eval_data() -> list[np.ndarray]:
    """Seeded uint8 BGR images at the reference eval's resize_size."""
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (EVAL_SIZE, EVAL_SIZE, 3), dtype=np.uint8)
            for _ in range(EVAL_IMAGES)]


def phase_eval() -> int:
    """``evaluate_with_classifier`` at the reference eval defaults; returns its K1 launches."""
    from artist_style_transfer_tpu_torch.infer.evaluate import eval_logits, evaluate_with_classifier
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, load_classifier
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel

    pth = os.path.join(GOLDENS, "golden_transfer.pth")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        # Both nets load as the CLI loads them, from the reference file layouts, onto
        # the default device (CUDA); the classifier from a fastai-style {'model': sd}.
        clf_path = os.path.join(tmp, "best-2.pth")
        torch.save({"model": seeded_classifier("cpu").state_dict()}, clf_path)
        model, clf = load_transfer_params(pth), load_classifier(clf_path)
        require(next(clf.parameters()).is_cuda, "eval: load_classifier did not default to CUDA")
        images = eval_data()
        artist = ARTISTS_19.index(CLF_ARTIST)
        kw = dict(batch_size=CLF_BATCH, wordy=False)
        evaluate_with_classifier(model, clf, images[:CLF_BATCH], artist, **kw)  # warm-up batch

        # The main path: counter zeroed just before, read just after.
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        gram_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        acc = evaluate_with_classifier(model, clf, images, artist, **kw)
        seconds = time.perf_counter() - t0
        launches = gram_kernel.LAUNCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        cli = eval_cli(tmp, pth, clf_path, model, clf)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # The pipeline's predictions, batch by batch, give its accuracy.
    logits = torch.cat([eval_logits(model, clf, torch.as_tensor(np.stack(images[i:i + CLF_BATCH]),
                                                                 device="cuda")).cpu()
                        for i in range(0, EVAL_IMAGES, CLF_BATCH)])
    preds = logits.argmax(-1)
    require(bool(torch.isfinite(logits).all()), "eval: logits not finite")
    require(acc == round(100.0 * (preds == artist).sum().item() / EVAL_IMAGES, 2),
            f"eval: accuracy {acc} is not that of the predictions {preds.tolist()}")
    require(launches == 0, f"eval: {launches} gram launches on a path with no Gram")

    # Against the port's CPU result on EVAL_CPU_IMAGES images; a top-2 margin under
    # 1e-3 of max|logit| is within the two devices' rounding and is not compared.
    cpu_logits = eval_logits(load_transfer_params(pth, device="cpu"), seeded_classifier("cpu"),
                             torch.as_tensor(np.stack(images[:EVAL_CPU_IMAGES])))
    top2 = cpu_logits.topk(2, dim=-1).values
    margins = ((top2[:, 0] - top2[:, 1]) / cpu_logits.abs().max()).tolist()
    compared = [i for i, m in enumerate(margins) if m >= 1e-3]
    cpu_preds = cpu_logits.argmax(-1).tolist()
    require(all(cpu_preds[i] == preds[i].item() for i in compared),
            f"eval: card predictions {preds[:EVAL_CPU_IMAGES].tolist()} vs CPU {cpu_preds}")
    emit("eval", images=EVAL_IMAGES, size=EVAL_SIZE, crop=CLF_SIZE, batch=CLF_BATCH,
         accuracy=acc, preds=preds.tolist(), seconds=seconds,
         images_per_sec=EVAL_IMAGES / seconds, ms_per_image=seconds * 1e3 / EVAL_IMAGES,
         peak_mem_gib=peak_gib, gram_launches=launches, cpu_preds=cpu_preds,
         cpu_top2_margins=margins, cpu_compared=compared,
         card_vs_cpu_logits_rel=rel_to_max(logits[:EVAL_CPU_IMAGES], cpu_logits), cli=cli)
    return launches


def eval_cli(tmp: str, pth: str, clf_path: str, model, clf) -> dict:
    """``inference.py --no-display`` on the default device over EVAL_CLI_IMAGES seeded
    JPEGs, resized to the default 1024²: its ``Acc=`` against ``evaluate_with_classifier``
    on the same files decoded by cv2, as the CLI decodes them. Skipped where cv2 is
    missing, since the CLI needs it."""
    try:
        import cv2
    except ImportError:
        return {"skipped": "no cv2 to decode JPEGs"}
    import contextlib
    import io

    from artist_style_transfer_tpu_torch import inference
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19

    content = os.path.join(tmp, "content")
    model_dir = os.path.join(tmp, "models", CLF_ARTIST, "random")
    os.makedirs(content)
    os.makedirs(model_dir)
    shutil.copy(pth, model_dir)
    rng = np.random.default_rng(5)
    files = [os.path.join(content, f"c{i}.jpg") for i in range(EVAL_CLI_IMAGES)]
    for f in files:
        cv2.imwrite(f, rng.integers(0, 256, (600, 800, 3), dtype=np.uint8))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        acc = inference.main(["--no-display", "--artist", CLF_ARTIST, "--style_method", "random",
                              "--model_filename", os.path.basename(pth), "--model_dir",
                              os.path.join(tmp, "models"), "--content_dir", content,
                              "--classifier_path", clf_path, "--seed", "0"])
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    # The accuracy does not depend on the order the CLI shuffles the files into.
    direct = evaluate_with_classifier(
        model, clf, [cv2.resize(cv2.imread(f), (EVAL_SIZE, EVAL_SIZE)) for f in files],
        ARTISTS_19.index(CLF_ARTIST), batch_size=CLF_BATCH, wordy=False)
    require(f"Grabbed {EVAL_CLI_IMAGES} images!" in lines and lines[-1] == f"Acc={acc}",
            f"eval CLI output: {lines[:2]} ... {lines[-1:]}")
    require(acc == direct, f"eval CLI Acc={acc} vs a direct call's {direct}")
    return {"images": EVAL_CLI_IMAGES, "accuracy": acc, "direct_accuracy": direct,
            "seconds": seconds, "cv2": cv2.__version__}


def phase_train_classifier(peaks: dict, size: int = TRAIN_SIZE, device: str = "cuda") -> int:
    """'classifier' training through ``train()``; returns its K1 launches (0)."""
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel
    from artist_style_transfer_tpu_torch.train import train

    vgg = init_vgg16(torch.Generator().manual_seed(0), device=device)
    clf = seeded_classifier(device)
    content, _ = train_data(size)
    steps_per_epoch = -(-TRAIN_CONTENT // TRAIN_BATCH)
    kwargs = dict(batch_size=TRAIN_BATCH, seed=0, num_steps=2, save_every=1,
                  content_images=content, vgg=vgg, classifier=clf, device=device, wordy=False,
                  log_every_batches=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_classifier_")
    try:
        # The main path: counter zeroed just before, read just after.
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        gram_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        model, losses = train("classifier", CLF_ARTIST, num_epochs=TRAIN_EPOCHS, model_dir=tmp,
                              **kwargs)
        seconds = time.perf_counter() - t0
        launches = gram_kernel.LAUNCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        run_dir = os.path.join(tmp, CLF_ARTIST, "classifier")
        events = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
        steps = np.array([[e["content_loss"], e["style_loss"], e["total_loss"]]
                          for e in events if e["event"] == "batch"])
        epochs = [e for e in events if e["event"] == "epoch"]
        require(steps.shape == (TRAIN_EPOCHS * steps_per_epoch, 3),
                f"train_classifier: {steps.shape} per-step loss records")
        require(bool(np.isfinite(steps).all()) and bool(np.isfinite(losses).all()),
                "train_classifier: a loss is not finite")
        require(losses[-1, 2] < losses[0, 2],
                f"train_classifier: epoch {TRAIN_EPOCHS} total {losses[-1, 2]} not below "
                f"epoch 1's {losses[0, 2]}")
        require(launches == 0, f"train_classifier: {launches} gram launches on a path with no Gram")
        frozen = [n for net, tag in ((vgg, "vgg"), (clf, "classifier"))
                  for n, p in net.named_parameters(prefix=tag) if p.grad is not None]
        require(not frozen, f"train_classifier: frozen parameters with a .grad: {frozen[:4]}")
        warm = epochs[1:]
        warm_s = sum(e["secs"] for e in warm)
        warm_steps = len(warm) * steps_per_epoch

        probe = content[:1]
        ref = stylize(model, probe, clip=False, device=device).float().cpu().numpy()
        path = os.path.join(run_dir, f"transfer_17-25_{TRAIN_EPOCHS}.pth")
        out = stylize(load_transfer_params(path, device=device), probe, clip=False,
                      device=device).float().cpu().numpy()
        require(out.shape == ref.shape and bool(np.isfinite(out).all()),
                "train_classifier: the pth export did not stylize")
        db = psnr(out, ref)
        require(db > 45.0, f"train_classifier: pth export {db} dB from the model")
        reload_diff = float(np.abs(out - ref).max())

        fns, data, r22 = train_step_fns(vgg, content, None, "auto", device, classifier=clf)
        step_flops, step_bound_ms = step_flops_and_bound(fns, data, r22, peaks)

        _, bf16_losses = train("classifier", CLF_ARTIST, num_epochs=1, model_dir=None,
                               compute_dtype="bfloat16", **kwargs)
        require(bool(np.isfinite(bf16_losses).all()), "train_classifier bf16: a loss is not finite")
        bf16_ms = warm_ms_per_step(*train_step_fns(vgg, content, None, "auto", device,
                                                   compute_dtype="bfloat16", classifier=clf))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("train_classifier", mode="classifier", size=size, batch=TRAIN_BATCH,
         content=TRAIN_CONTENT, epochs=TRAIN_EPOCHS, steps=int(steps.shape[0]),
         epoch_losses=losses.tolist(), step_total_first=float(steps[0, 2]),
         step_total_last=float(steps[-1, 2]), gram_launches=launches, seconds=seconds,
         epoch_secs=[e["secs"] for e in epochs], ms_per_step=warm_s * 1e3 / warm_steps,
         images_per_sec=warm_steps * TRAIN_BATCH / warm_s, step_gflop=step_flops / 1e9,
         step_bound_ms=step_bound_ms,
         step_bound_share=step_bound_ms * warm_steps / (warm_s * 1e3), peak_mem_gib=peak_gib,
         reload_max_abs_diff=reload_diff, bf16_epoch_losses=bf16_losses.tolist(),
         bf16_ms_per_step_warm=bf16_ms)
    return launches


def smooth_image(cv2, rng, h: int, w: int) -> np.ndarray:
    """A seeded uint8 BGR image: a smooth colour field with noise, which compresses and
    decodes like a photograph rather than like white noise."""
    coarse = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
    smooth = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    return np.clip(smooth + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)


def data_workspace(root: str, size_range=(320, 641), painting_range=(200, 501),
                   n_content: int = DATA_CONTENT, artists=DATA_ARTISTS) -> dict:
    """The seeded workspace of the data phase under ``root``, in the reference's layout:
    ``images/content/`` (``n_content`` JPEGs and one truncated file),
    ``images/archive/artists.csv`` and ``resized/resized/<name>_<i>.jpg``, an empty
    ``dicts/``, ``models/vgg16-00b39a1b.pth``. Images are smooth colour fields with
    noise, so they compress and decode like photographs rather than like white noise."""
    import cv2

    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    rng = np.random.default_rng(7)

    def image(lo: int, hi: int) -> np.ndarray:
        h, w = (int(v) for v in rng.integers(lo, hi, 2))
        return smooth_image(cv2, rng, h, w)

    ws = {k: os.path.join(root, v) for k, v in (
        ("content", "images/content"), ("archive", "images/archive"), ("cache", "dicts"),
        ("models", "models"))}
    for d in ws.values():
        os.makedirs(d)
    paintings = os.path.join(ws["archive"], "resized", "resized")
    os.makedirs(paintings)
    for i in range(n_content):
        cv2.imwrite(os.path.join(ws["content"], f"c{i:03d}.jpg"), image(*size_range))
    with open(os.path.join(ws["content"], "c000.jpg"), "rb") as fh:
        head = fh.read(200)  # inside the JPEG headers: no decoder gets an image out of it
    ws["bad"] = os.path.join(ws["content"], "truncated.jpg")
    with open(ws["bad"], "wb") as fh:
        fh.write(head)
    with open(os.path.join(ws["archive"], "artists.csv"), "w") as fh:
        fh.write("id,name,paintings\n")
        for k, (name, n) in enumerate(artists):
            fh.write(f"{k},{name},{n}\n")
            for i in range(1, n + 1):
                cv2.imwrite(os.path.join(paintings, f"{name.replace(' ', '_')}_{i}.jpg"),
                            image(*painting_range))
    ws["vgg"] = os.path.join(ws["models"], "vgg16-00b39a1b.pth")
    torch.save(init_vgg16(torch.Generator().manual_seed(0)).state_dict(), ws["vgg"])
    ws["artist"] = artists[0][0].replace(" ", "_")
    return ws


def serial_loaders(ws: dict, size: int) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of the loaders: the reference's serial cv2 loops
    (dataset.py:93-101, :135-164 and its rescale) over the same files in the same
    order, f32: the content corpus, and the trained artist's paintings."""
    import random

    import cv2

    from artist_style_transfer_tpu_torch.data.datasets import rescale_image

    files = sorted(os.listdir(ws["content"]))
    random.Random(2).shuffle(files)
    content = []
    for f in files:
        im = cv2.imread(os.path.join(ws["content"], f))
        if im is not None:
            content.append(cv2.resize(im, (size, size)).astype(np.float32))
        if len(content) == DATA_CONTENT:
            break
    n = DATA_ARTISTS[0][1]
    paintings = [cv2.imread(os.path.join(ws["archive"], "resized", "resized",
                                         f"{ws['artist']}_{i}.jpg")) for i in range(1, n + 1)]
    return (np.stack(content),
            np.stack([rescale_image(im, size, size) for im in paintings]).astype(np.float32))


def data_loaders(ws: dict, size: int) -> tuple[dict, np.ndarray, np.ndarray]:
    """``get_content_dataset``/``get_painting_dataset`` timed and held against the serial
    loops: bit-equal on the cv2 route, within 1.0 on the native one."""
    from artist_style_transfer_tpu_torch.data import get_content_dataset, get_painting_dataset

    stats = {"content": {}, "paintings": {}}
    t0 = time.perf_counter()
    content = get_content_dataset(DATA_CONTENT, size, size, content_dir=ws["content"], seed=2,
                                  stats=stats["content"])
    content_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    corpus = get_painting_dataset(False, size, size, archive_dir=ws["archive"],
                                  cache_dir=ws["cache"], stats=stats["paintings"])
    paintings_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_content, ref_paintings = serial_loaders(ws, size)
    serial_s = time.perf_counter() - t0
    c, p = stats["content"], stats["paintings"]
    require(c["images"] == DATA_CONTENT and c["skipped"] == 1,
            f"data: content loader kept {c['images']} and skipped {c['skipped']} "
            f"of {DATA_CONTENT} JPEGs and one truncated file")
    require(p["source"] == "decoded" and p["images"] == sum(n for _, n in DATA_ARTISTS),
            f"data: painting loader {p}")
    errs = {}
    for what, got, ref, route in (("content", content, ref_content, c["decoder"]),
                                  ("paintings", corpus[ws["artist"]], ref_paintings,
                                   p["decoder"])):
        require(got.shape == ref.shape, f"data: {what} {got.shape} vs serial {ref.shape}")
        errs[what] = float(np.abs(got - ref).max())
        if route == "cv2":
            require(errs[what] == 0.0, f"data: {what} on the cv2 route differs from the serial "
                                       f"loop by {errs[what]}")
        else:
            require(errs[what] < 1.0, f"data: {what} on the native route {errs[what]} from cv2")
    out = {
        "content": {**c, "seconds": content_s, "images_per_sec": c["images"] / content_s},
        "paintings": {**p, "seconds": paintings_s, "images_per_sec": p["images"] / paintings_s},
        "serial_cv2_seconds": serial_s,
        "serial_cv2_images_per_sec": (c["images"] + DATA_ARTISTS[0][1]) / serial_s,
        "max_abs_err_vs_serial": errs,
    }
    return out, content, corpus[ws["artist"]]


def metrics_of(run_dir: str) -> tuple[list[dict], list[dict], dict]:
    """The epoch records, the per-batch losses and the ``data`` record of a run."""
    events = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    return ([e for e in events if e["event"] == "epoch"],
            [e for e in events if e["event"] == "batch"],
            next(e for e in events if e["event"] == "data"))


def phase_data(size: int = TRAIN_SIZE, device: str | None = None,
               workspace=data_workspace) -> tuple[int, int]:
    """The data pipeline, the training CLI and the streamed path; returns the kernel
    launches of the CLI run and of the streamed run. ``device=None`` is the entry
    points' default, CUDA."""
    from artist_style_transfer_tpu_torch import train_style_transfer
    from artist_style_transfer_tpu_torch.data import (
        content_file_stream,
        device_prefetch,
        native_loader,
    )
    from artist_style_transfer_tpu_torch.data.datasets import decoder_route
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize
    from artist_style_transfer_tpu_torch.models.vgg import load_vgg16
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel
    from artist_style_transfer_tpu_torch.train import train
    from artist_style_transfer_tpu_torch.train.loop import epoch_permutation

    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        t0 = time.perf_counter()
        ws = workspace(tmp)
        workspace_s = time.perf_counter() - t0
        loaders, content, paintings = data_loaders(ws, size)
        route = decoder_route()
        artist = ws["artist"]
        n_paint = DATA_ARTISTS[0][1]
        steps = -(-DATA_CONTENT // TRAIN_BATCH)
        expect = 4 * -(-n_paint // 8) + 4 * steps * DATA_EPOCHS

        # The CLI on the default device: counter zeroed just before, read just after.
        model_dir = os.path.join(tmp, "models")
        dev_args = [] if device is None else ["--device", device]
        sync()
        gram_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        model, losses = train_style_transfer.main([
            "--style_method", "cycle", "--artist", artist, "--num_epochs", str(DATA_EPOCHS),
            "--batch_size", str(TRAIN_BATCH), "--content_data_size", str(DATA_CONTENT),
            "--train_size", str(size), "--save_every", "1", "--log_every_batches", "1",
            "--content_dir", ws["content"], "--archive_dir", ws["archive"],
            "--cache_dir", ws["cache"], "--model_dir", model_dir, "--vgg_path", ws["vgg"],
            "--quiet", *dev_args])
        sync()
        cli_s = time.perf_counter() - t0
        cli_launches = gram_kernel.LAUNCHES
        run_dir = os.path.join(model_dir, artist, "cycle")
        epochs, batches, data_rec = metrics_of(run_dir)
        require(bool(np.isfinite(losses).all()) and losses[-1, 2] < losses[0, 2],
                f"data CLI: epoch losses {losses.tolist()}")
        require(len(batches) == steps * DATA_EPOCHS, f"data CLI: {len(batches)} batch records")
        require(cli_launches == expect, f"data CLI: gram launches {cli_launches} != {expect}")
        require(data_rec["content"].get("decoder") == route
                and data_rec["paintings"].get("decoder") == route,
                f"data CLI: metrics.jsonl names no {route!r} decoder: {data_rec}")
        names = set(os.listdir(run_dir))
        # 'cycle' writes no style.jpg: the reference writes it for 'random' and 'average'.
        want = {f"transfer_17-25_{e}.ckpt" for e in range(DATA_EPOCHS + 1)} | {
            f"transfer_17-25_{DATA_EPOCHS}.{x}" for x in ("npy", "npz", "pth")} | {
            "metrics.jsonl"}
        require(want <= names, f"data CLI: missing artifacts {sorted(want - names)}")
        dev = next(model.parameters()).device
        probe = content[:1]
        ref = stylize(model, probe, clip=False, device=dev).float().cpu().numpy()
        out = stylize(load_transfer_params(os.path.join(run_dir,
                                                        f"transfer_17-25_{DATA_EPOCHS}.pth"), dev),
                      probe, clip=False, device=dev).float().cpu().numpy()
        require(psnr(out, ref) > 45.0, f"data CLI: the .pth export is {psnr(out, ref)} dB off")
        cli_ms = epochs[-1]["secs"] * 1e3 / steps

        # A file no decoder reads stops the stream (no silent skip).
        try:
            for _ in content_file_stream(ws["content"], TRAIN_BATCH, size, size, seed=2)(0):
                pass
            refused = None
        except RuntimeError as e:
            refused = str(e)
        require(refused is not None and "truncated.jpg" in refused,
                f"data stream: the truncated file was not refused: {refused}")
        os.remove(ws["bad"])

        # The streamed main path: counter zeroed just before, read just after.
        vgg = load_vgg16(ws["vgg"], dev)
        kw = dict(batch_size=TRAIN_BATCH, seed=2, wordy=False, vgg=vgg, device=dev,
                  archive_dir=ws["archive"], cache_dir=ws["cache"], train_size=size)
        stream = content_file_stream(ws["content"], TRAIN_BATCH, size, size,
                                     content_data_size=DATA_CONTENT, seed=2)
        stream_dir = os.path.join(tmp, "stream")
        sync()
        gram_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        _, s_losses = train("cycle", artist, num_epochs=DATA_EPOCHS,
                            content_data_size=DATA_CONTENT, content_stream=stream,
                            model_dir=stream_dir, save_every=1, log_every_batches=1, **kw)
        sync()
        stream_s = time.perf_counter() - t0
        stream_launches = gram_kernel.LAUNCHES
        s_epochs, s_batches, s_data = metrics_of(os.path.join(stream_dir, artist, "cycle"))
        require(bool(np.isfinite(s_losses).all()) and s_losses[-1, 2] < s_losses[0, 2],
                f"data stream: epoch losses {s_losses.tolist()}")
        require(len(s_batches) == steps * DATA_EPOCHS, f"data stream: {len(s_batches)} batches")
        require(stream_launches == expect, f"data stream: gram launches {stream_launches} != "
                                           f"{expect}")
        require(s_data["content"].get("decoder") == route, f"data stream: {s_data}")
        stream_ms = s_epochs[-1]["secs"] * 1e3 / steps
        # The stream alone, and through device_prefetch, with no training beside it.
        alone = {}
        for what in ("decode", "decode_and_copy"):
            batches = stream(DATA_EPOCHS)
            if what == "decode_and_copy":
                batches = device_prefetch(batches, device=dev)
            t0 = time.perf_counter()
            n = sum(int(b.shape[0]) for b in batches)
            sync()
            alone[what] = {"images": n, "images_per_sec": n / (time.perf_counter() - t0)}

        # Streamed against resident: the resident permutation replayed over decoded images.
        corpus = content[:DATA_PARITY_IMAGES]

        def replay(epoch):
            perm = epoch_permutation(2, epoch, len(corpus)).numpy()
            for s in range(0, len(corpus), TRAIN_BATCH):
                yield corpus[perm[s : s + TRAIN_BATCH]]

        pkw = dict(kw, paintings=paintings, num_epochs=DATA_EPOCHS, model_dir=None,
                   content_data_size=len(corpus))
        _, resident = train("cycle", artist, content_images=corpus, **pkw)
        _, streamed = train("cycle", artist, content_stream=replay, **pkw)
        parity_rel = float(np.max(np.abs(streamed - resident) / np.abs(resident)))
        require(parity_rel <= 1e-3, f"data: streamed vs resident per-epoch losses rel {parity_rel}")

        # One streamed step with the kernel against one without.
        batch = torch.as_tensor(corpus[:TRAIN_BATCH], device=dev)
        step = []
        for use_kernel in (True, False):
            fns, _, _ = train_step_fns(vgg, corpus[:TRAIN_BATCH], paintings[:8], use_kernel, dev)
            step.append(fns.stream_step_fn(batch, 0).cpu())
        step_rel = ((step[0] - step[1]).abs() / step[1].abs()).max().item()
        require(step_rel <= 1e-4, f"data: streamed step kernel vs plain rel {step_rel}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("data", size=size, batch=TRAIN_BATCH, content=DATA_CONTENT, epochs=DATA_EPOCHS,
         paintings={name.replace(" ", "_"): n for name, n in DATA_ARTISTS},
         decoder=route, native_loader_error=native_loader.load_error,
         workspace_seconds=workspace_s, loaders=loaders,
         cli={"seconds": cli_s, "epoch_losses": losses.tolist(),
              "epoch_secs": [e["secs"] for e in epochs], "ms_per_step_epoch2": cli_ms,
              "images_per_sec_epoch2": steps * TRAIN_BATCH * 1e3 / (cli_ms * steps),
              "gram_launches": cli_launches, "expected_launches": expect,
              "pth_reload_psnr_db": psnr(out, ref), "data_record": data_rec},
         stream={"seconds": stream_s, "epoch_losses": s_losses.tolist(),
                 "epoch_secs": [e["secs"] for e in s_epochs], "ms_per_step_epoch2": stream_ms,
                 "stream_wait_secs": [e["stream_wait_secs"] for e in s_epochs],
                 "gram_launches": stream_launches, "refused": refused[:120],
                 "alone": alone},
         stream_over_resident_ms=stream_ms / cli_ms,
         parity={"images": len(corpus), "resident": resident.tolist(),
                 "streamed": streamed.tolist(), "max_rel": parity_rel},
         kernel_vs_plain_stream_step_rel=step_rel,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_available()
         else None)
    return cli_launches, stream_launches


def panel_boxes(fig_bgr: np.ndarray) -> list[tuple[int, int]]:
    """The (first, last) columns of each panel of a figure: runs of columns that hold a
    non-white pixel in the middle band of rows, below the titles."""
    h = fig_bgr.shape[0]
    ink = (fig_bgr[int(h * 0.3):int(h * 0.7)] != 255).any(axis=(0, 2))
    edges = np.flatnonzero(np.diff(np.concatenate([[0], ink.astype(np.int8), [0]])))
    return [(int(a), int(b) - 1) for a, b in zip(edges[::2], edges[1::2])]


def phase_display() -> None:
    """``inference.py`` in display mode (the reference's default) on the golden content
    image, on the default device, with matplotlib made unimportable: OpenCV writes the
    Content/Style/Transformed figure."""
    import cv2

    from artist_style_transfer_tpu_torch import inference

    tmp = tempfile.mkdtemp(prefix="chip_smoke_display_")
    hidden = sys.modules.get("matplotlib", "absent")
    sys.modules["matplotlib"] = None  # import matplotlib now raises, as where it is missing
    try:
        model_dir = os.path.join(tmp, "models", "Golden", "random")
        os.makedirs(model_dir)
        shutil.copy(os.path.join(GOLDENS, "golden_transfer.pth"), model_dir)
        cv2.imwrite(os.path.join(model_dir, "style.jpg"),
                    np.random.default_rng(6).integers(0, 256, (96, 128, 3), dtype=np.uint8))
        t0 = time.perf_counter()
        fig_path = inference.main([
            "--artist", "Golden", "--style_method", "random", "--model_filename",
            "golden_transfer.pth", "--model_dir", os.path.join(tmp, "models"), "--fig_dir",
            os.path.join(tmp, "figs"), "--content_img",
            os.path.join(GOLDENS, "content_landscape_256.png"), "--content_size_w", "256"])
        seconds = time.perf_counter() - t0
        fig = cv2.imread(fig_path)
        require(fig is not None, f"display: no decodable figure at {fig_path}")
        boxes = panel_boxes(fig)
    finally:
        if hidden == "absent":
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = hidden
        shutil.rmtree(tmp, ignore_errors=True)
    require(fig.shape == (500, 1800, 3), f"display: figure shape {fig.shape}")
    require(len(boxes) == 3, f"display: {len(boxes)} panels, not 3: {boxes}")
    emit("display", figure=os.path.basename(fig_path), shape=list(fig.shape), panels=len(boxes),
         panel_columns=boxes, writer="cv2", cv2=cv2.__version__, seconds=seconds)


def record_qconv_calls(run) -> list[tuple]:
    """Run ``run`` and return the arguments of every K2 launch it made, in order (the
    tensors themselves: the main path's real inputs)."""
    from artist_style_transfer_tpu_torch.ops.cuda import qconv_kernel

    calls, real = [], qconv_kernel.conv_i8_cuda

    def recording(*args):
        calls.append(args)
        return real(*args)

    qconv_kernel.conv_i8_cuda = recording
    try:
        run()
        torch.cuda.synchronize()
    finally:
        qconv_kernel.conv_i8_cuda = real
    return calls


def qconv_bound(x, w, y, stride, dil, peaks) -> tuple[float, float, float]:
    """(operations ms, bytes ms, the conv's own MACs) of one K2 launch: x and w read once,
    y written once; 2 operations a MAC at the dense int8 rate. A transpose conv (lhs
    dilation > 1) counts its own MACs, each input pixel times k^2 * C_out, and not the
    inserted zeros the kernel multiplies too."""
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    if dil > 1:
        macs = float(n) * h * wd * cin * cout * kh * kw
    else:
        macs = float(y.shape[0]) * y.shape[2] * y.shape[3] * cout * kh * kw * cin
    nbytes = x.numel() + w.numel() + y.numel() * y.element_size()
    return 2 * macs / peaks["int8"] * 1e3, nbytes / peaks["hbm"] * 1e3, macs


def qconv_library(x, w, stride, lo, hi, dil, exact) -> dict:
    """The yardsticks of one K2 shape: cuDNN's bf16 conv of the same geometry (the real
    dtype's reference point; zero padding) and, for a 1x1 stride-1 conv, ``torch._int_mm``,
    which computes the same int32 function in one call."""
    import torch.nn.functional as F

    xb = x.to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    k = w.shape[2]
    if dil > 1:
        wt = wb.transpose(0, 1).flip(2, 3).contiguous()
        cudnn = lambda: F.conv_transpose2d(xb, wt, stride=dil, padding=k - 1 - lo,  # noqa: E731
                                           output_padding=hi - lo)
    else:
        cudnn = lambda: F.conv2d(xb, wb, stride=stride, padding=lo)  # noqa: E731
    out = {"cudnn_bf16_ms": time_ms(cudnn), "int_mm_ms": None}
    if k == 1 and stride == 1 and dil == 1 and lo == hi == 0:
        a = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        b = w.view(w.shape[0], w.shape[1]).t()
        try:
            got = torch._int_mm(a, b)
            out["int_mm_exact"] = bool(torch.equal(
                got, exact.permute(0, 2, 3, 1).reshape(-1, w.shape[0])))
            out["int_mm_ms"] = time_ms(lambda: torch._int_mm(a, b))
        except RuntimeError as e:  # a yardstick only: record why it did not run
            out["int_mm_error"] = str(e)[:200]
    return out


def check_qconv_shapes(calls: list[tuple], path: str, peaks: dict, cold: bool = True) -> dict:
    """K2 against its plain f64 version on each distinct shape of ``calls`` (a path's
    launches), in all three epilogues, and its times; returns the path's sums over its
    launches (a shape counts as often as the path launches it). ``cold=False`` skips the
    profiler's cold-L2 device time (and with it the check that it is not under the
    bound): the warm events time stays."""
    from artist_style_transfer_tpu_torch.ops.cuda.qconv_kernel import conv_i8_cuda, plan_for
    from artist_style_transfer_tpu_torch.ops.qconv import Dequant, apply_epilogue, conv_i8_plain

    groups: dict[tuple, list] = {}
    for args in calls:
        x, w, stride, lo, hi, dil, reflect, out = args
        kind = "dequant_" + str(out.dtype)[6:] if isinstance(out, Dequant) else str(out)[6:]
        key = (tuple(x.shape), tuple(w.shape), stride, lo, hi, dil, reflect, kind)
        groups.setdefault(key, [args, 0])[1] += 1
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms", "cudnn_bf16_ms")
    sums = dict.fromkeys(keys, 0.0)
    # torch._int_mm over the 1x1 stride-1 launches it computes, and K2 over the same ones.
    library = {"library_ms": 0.0, "library_k2_ms": 0.0, "library_k2_device_ms": 0.0,
               "library_launches": 0, "library_failed_launches": 0}
    worst = {"s32_max_abs_err": 0, "bf16_mismatches": 0, "dequant_max_rel_err": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for key, (args, count) in groups.items():
        x, w, stride, lo, hi, dil, reflect, out = args
        mode = "reflect" if reflect else "zeros"
        exact = conv_i8_plain(x, w, stride, (lo, hi), dil, mode)
        k32 = conv_i8_cuda(x, w, stride, lo, hi, dil, reflect, torch.int32)
        kbf = conv_i8_cuda(x, w, stride, lo, hi, dil, reflect, torch.bfloat16)
        torch.cuda.synchronize()
        s32_err = int((k32.long() - exact.long()).abs().max().item())
        pbf = apply_epilogue(exact, torch.bfloat16)
        bf16_bad = int((kbf.view(torch.int16) != pbf.view(torch.int16)).sum().item())
        cout = w.shape[0]
        dq = out if isinstance(out, Dequant) else Dequant(
            torch.tensor(0.0123, device="cuda"),
            torch.rand(cout, generator=gen, device="cuda") * 1e-3,
            torch.randn(cout, generator=gen, device="cuda"), torch.float32)
        dq_rel = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            d = dq._replace(dtype=dtype)
            ref = apply_epilogue(exact, d).float()
            got = conv_i8_cuda(x, w, stride, lo, hi, dil, reflect, d).float()
            dq_rel = max(dq_rel, ((got - ref).abs().max() / ref.abs().max()).item())
        require(s32_err == 0, f"K2 {path} {key}: int32 epilogue off by {s32_err}")
        require(bf16_bad == 0, f"K2 {path} {key}: {bf16_bad} bf16 values not the exact sum's")
        # f32 rounding: the kernel and the plain version round the same ops, so 0 is
        # expected; one f32 ulp of the largest value is the bar.
        require(dq_rel <= 2.0**-23, f"K2 {path} {key}: dequant rel err {dq_rel}")
        worst["s32_max_abs_err"] = max(worst["s32_max_abs_err"], s32_err)
        worst["bf16_mismatches"] += bf16_bad
        worst["dequant_max_rel_err"] = max(worst["dequant_max_rel_err"], dq_rel)

        run = lambda: conv_i8_cuda(*args)  # noqa: E731  (the main path's epilogue)
        y = run()
        ms = time_ms(run)
        dev = device_ms(run, "qconv_kernel") if cold else None
        plain_ms = time_ms(lambda: conv_i8_plain(x, w, stride, (lo, hi), dil, mode, out),
                           iters=3, warmup=1)
        t_ops, t_bytes, macs = qconv_bound(x, w, y, stride, dil, peaks)
        bound = max(t_ops, t_bytes)
        require(dev is None or dev >= bound / 1.05, f"K2 {path} {key}: device {dev} ms under "
                                                    f"the bound {bound} ms: miscounted")
        lib = qconv_library(x, w, stride, lo, hi, dil, exact)
        emit("qconv", path=path, x=list(x.shape), w=list(w.shape), stride=stride, pads=[lo, hi],
             lhs_dilation=dil, pad_mode=mode, epilogue=key[-1], launches=count,
             plan=plan_for(x, w, stride, lo, hi, dil, reflect).describe(),
             s32_max_abs_err=s32_err, bf16_mismatches=bf16_bad, dequant_max_rel_err=dq_rel,
             ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound,
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             bound_share=bound / (dev or ms), gmac=macs / 1e9,
             tops=2 * macs / (dev or ms) / 1e9, **lib)
        for k, v in zip(keys, (ms, dev or 0.0, plain_ms, bound, t_ops, t_bytes,
                               lib["cudnn_bf16_ms"])):
            sums[k] += v * count
        if lib["int_mm_ms"] is not None:
            library["library_ms"] += lib["int_mm_ms"] * count
            library["library_k2_ms"] += ms * count
            library["library_k2_device_ms"] += (dev or 0.0) * count
            library["library_launches"] += count
        elif "int_mm_error" in lib:
            library["library_failed_launches"] += count
    if not cold:
        sums["device_ms"] = library["library_k2_device_ms"] = None
    return {**sums, **library, **worst, "launches": len(calls), "shapes": len(groups)}


def decisive_classifier(device: str, artist: int):
    """The seeded classifier with ``artist``'s logit raised by 100, far above the int8
    rounding, as JAX's ``tests/test_resnet_q.py:225-245`` makes it."""
    clf = seeded_classifier("cpu")
    with torch.no_grad():
        clf.get_submodule("1").get_submodule("8").bias[artist] += 100.0
    return clf.to(device)


def phase_int8(peaks: dict, smi: str) -> dict:
    """K2 against its plain version on the main paths' shapes, ``stylize_int8``, the int8
    eval pipeline and the ``--quantize`` CLI; returns the kernels line's numbers."""
    from artist_style_transfer_tpu_torch.infer.evaluate import (
        eval_logits,
        evaluate_with_classifier,
        quantize_eval_pipeline,
    )
    from artist_style_transfer_tpu_torch.infer.stylize import (
        load_transfer_params,
        stylize,
        stylize_int8,
    )
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19
    from artist_style_transfer_tpu_torch.models.transformer_q import quantize_transformer
    from artist_style_transfer_tpu_torch.ops import qconv
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel, qconv_kernel
    from artist_style_transfer_tpu_torch.utils.images import read_png

    pth = os.path.join(GOLDENS, "golden_transfer.pth")
    model = load_transfer_params(pth, device="cuda")
    # Random calibration content, not the test image, as tests/test_quant.py draws it.
    calib = (np.random.default_rng(7).random((2, 128, 128, 3)) * 255).astype(np.float32)
    qmodel = quantize_transformer(model, calib)

    # No CPU form, no fallback: a CUDA tensor K2 cannot take raises.
    bad = torch.zeros((1, 48, 8, 8), dtype=torch.int8, device="cuda").contiguous(
        memory_format=torch.channels_last)
    try:
        qconv.conv_i8(bad, torch.zeros((8, 48, 3, 3), dtype=torch.int8, device="cuda").contiguous(
            memory_format=torch.channels_last), padding=1)
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "multiple of 32" in refused,
            f"int8: K2 took C_in = 48: {refused}")

    # stylize_int8 on the golden image, against the port's f32 stylize and the golden.
    content = read_png(os.path.join(GOLDENS, "content_landscape_256.png"))
    golden = read_png(os.path.join(GOLDENS, "golden_stylized.png"))
    out8 = stylize_int8(qmodel, content[None], device="cuda")[0].cpu().numpy()
    out32 = stylize(model, content[None], device="cuda")[0].cpu().numpy()
    db_f32, db_golden = psnr(out8, out32), psnr(out8, golden)
    require(db_f32 > 45.0, f"int8: stylize_int8 vs the f32 stylize {db_f32} dB")
    require(db_golden > 35.0, f"int8: stylize_int8 vs the golden {db_golden} dB")

    # The stylize main path at 512x512, B=4: counters zeroed just before, read just after.
    rng = np.random.default_rng(8)
    batch = rng.integers(0, 256, (INT8_BATCH, INT8_SIZE, INT8_SIZE, 3), dtype=np.uint8)
    stylize_int8(qmodel, batch, device="cuda")  # warm-up
    torch.cuda.synchronize()
    qconv_kernel.LAUNCHES = gram_kernel.LAUNCHES = 0
    outs = stylize_int8(qmodel, batch, device="cuda")
    torch.cuda.synchronize()
    stylize_launches, stylize_k1 = qconv_kernel.LAUNCHES, gram_kernel.LAUNCHES
    require(tuple(outs.shape) == batch.shape and outs.dtype == torch.uint8,
            f"int8: stylize_int8 output {tuple(outs.shape)} {outs.dtype}")
    require(stylize_launches == QCONV_TRANSFORMER and stylize_k1 == 0,
            f"int8: stylize_int8 made {stylize_launches} K2 and {stylize_k1} K1 launches")
    x = torch.as_tensor(batch, device="cuda")
    model_bf16 = load_transfer_params(pth, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        per_image = {
            "int8": time_ms(lambda: qmodel(x, accum=torch.bfloat16).float().clamp(0, 255)
                            .to(torch.uint8), iters=10) / INT8_BATCH,
            "bf16": time_ms(lambda: model_bf16(x.to(torch.bfloat16)).float().clamp(0, 255)
                            .to(torch.uint8), iters=10) / INT8_BATCH,
            "f32": time_ms(lambda: model(x.float()).clamp(0, 255).to(torch.uint8),
                           iters=10) / INT8_BATCH,
        }
    emit("stylize_int8", size=INT8_SIZE, batch=INT8_BATCH, psnr_vs_f32_db=db_f32,
         psnr_vs_golden_db=db_golden, k2_launches=stylize_launches, k1_launches=stylize_k1,
         ms_per_image=per_image, card=smi, c_in_48_refused=refused)

    # K2 against plain on the stylize path's 16 convs and an eval batch's 68.
    images = eval_data()
    artist = ARTISTS_19.index(CLF_ARTIST)
    clf = seeded_classifier("cuda")
    stylize_calls = record_qconv_calls(lambda: stylize_int8(qmodel, batch, device="cuda"))
    qm_eval, qc_eval = quantize_eval_pipeline(model, clf, np.stack(images[:2]))
    eval_calls = record_qconv_calls(lambda: eval_logits(
        qm_eval, qc_eval, torch.as_tensor(np.stack(images[:CLF_BATCH]), device="cuda")))
    require(len(stylize_calls) == QCONV_TRANSFORMER, f"int8: {len(stylize_calls)} stylize convs")
    require(len(eval_calls) == QCONV_TRANSFORMER + QCONV_RESNET,
            f"int8: {len(eval_calls)} convs in an eval batch")
    shapes = {"stylize_512": check_qconv_shapes(stylize_calls, "stylize_512", peaks),
              "eval_transformer_1024": check_qconv_shapes(eval_calls[:QCONV_TRANSFORMER],
                                                          "eval_transformer_1024", peaks),
              "eval_resnet_256": check_qconv_shapes(eval_calls[QCONV_TRANSFORMER:],
                                                    "eval_resnet_256", peaks)}
    del stylize_calls, eval_calls

    # The int8 eval main path, with a decisive classifier: counters zeroed just before.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    try:
        decisive = decisive_classifier("cuda", artist)
        kw = dict(batch_size=CLF_BATCH, wordy=False)
        evaluate_with_classifier(model, decisive, images[:CLF_BATCH], artist, quantize=True, **kw)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        qconv_kernel.LAUNCHES = gram_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        acc_q = evaluate_with_classifier(model, decisive, images, artist, quantize=True, **kw)
        seconds = time.perf_counter() - t0
        eval_launches, eval_k1 = qconv_kernel.LAUNCHES, gram_kernel.LAUNCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        acc_real = evaluate_with_classifier(model, decisive, images, artist, **kw)
        batches = -(-EVAL_IMAGES // CLF_BATCH)
        require(eval_launches == batches * (QCONV_TRANSFORMER + QCONV_RESNET),
                f"int8 eval: {eval_launches} K2 launches, not {batches} x 68")
        require(eval_k1 == 0, f"int8 eval: {eval_k1} K1 launches on a path with no Gram")
        require(acc_q == acc_real, f"int8 eval: Acc={acc_q}, the real pipeline's {acc_real}")

        # 2 images against the port's CPU int8 pipeline (the seeded classifier).
        pair = np.stack(images[:EVAL_CPU_IMAGES])
        card_logits = eval_logits(qm_eval, qc_eval, torch.as_tensor(pair, device="cuda")).float()
        qm_cpu, qc_cpu = quantize_eval_pipeline(load_transfer_params(pth, device="cpu"),
                                                seeded_classifier("cpu"), pair)
        cpu_logits = eval_logits(qm_cpu, qc_cpu, torch.as_tensor(pair)).float()
        top2 = cpu_logits.topk(2, dim=-1).values
        margins = ((top2[:, 0] - top2[:, 1]) / cpu_logits.abs().max()).tolist()
        compared = [i for i, m in enumerate(margins) if m >= 2e-2]
        card_preds, cpu_preds = card_logits.argmax(-1).tolist(), cpu_logits.argmax(-1).tolist()
        require(all(card_preds[i] == cpu_preds[i] for i in compared),
                f"int8 eval: card predictions {card_preds} vs CPU {cpu_preds}")
        cli = eval_cli_int8(tmp, pth, model, decisive, artist)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("eval_int8", images=EVAL_IMAGES, size=EVAL_SIZE, crop=CLF_SIZE, batch=CLF_BATCH,
         accuracy=acc_q, real_accuracy=acc_real, seconds=seconds,
         images_per_sec=EVAL_IMAGES / seconds, ms_per_image=seconds * 1e3 / EVAL_IMAGES,
         k2_launches=eval_launches, k2_launches_per_batch=eval_launches / batches,
         k1_launches=eval_k1, peak_mem_gib=peak_gib, card_preds=card_preds, cpu_preds=cpu_preds,
         cpu_top2_margins=margins, cpu_compared=compared,
         card_vs_cpu_logits_rel=rel_to_max(card_logits, cpu_logits), cli=cli, card=smi)
    return {"shapes": shapes, "launches": {
        "eval_int8": eval_launches, "stylize_int8": stylize_launches,
        "eval_cli_int8": cli["k2_launches"]},
        "k1_launches": {"stylize_int8": stylize_k1, "eval_int8": eval_k1}}


def record_in_q8_calls(run) -> list[tuple]:
    """Run ``run`` and return the arguments of every fused instance-norm call it made, in
    order (the tensors themselves: the main path's real accumulators)."""
    from artist_style_transfer_tpu_torch.ops.cuda import in_q8_kernel

    calls, real = [], in_q8_kernel.in_q8_cuda

    def recording(*args):
        calls.append(args)
        return real(*args)

    in_q8_kernel.in_q8_cuda = recording
    try:
        run()
        torch.cuda.synchronize()
    finally:
        in_q8_kernel.in_q8_cuda = real
    return calls


def in_q8_key(args: tuple) -> tuple:
    acc, _, _, relu, residual, inv_s, stream = args
    return (tuple(acc.shape), str(acc.dtype).split(".")[-1], relu, residual is not None,
            inv_s is not None, stream)


def in_q8_bytes(args: tuple) -> tuple[int, int]:
    """(the bytes read once and written once, the bytes the call moves) of a fused call:
    the accumulator, the residual, the bf16 stream and the int8 codes; the call also reads
    the accumulator for the mean and for the squares, and writes and reads the f32
    squares."""
    acc, _, _, _, residual, inv_s, stream = args
    once = acc.numel() * acc.element_size() \
        + (residual.numel() * 2 if residual is not None else 0) \
        + (acc.numel() * 2 if stream else 0) + (acc.numel() if inv_s is not None else 0)
    return once, once + 2 * acc.numel() * acc.element_size() + 8 * acc.numel()


def check_in_q8_call(args: tuple, peaks: dict, device_times: bool) -> dict:
    """One fused instance-norm call against the plain op on the card, bit for bit."""
    from artist_style_transfer_tpu_torch.models.transformer_q import in_act_q8_plain
    from artist_style_transfer_tpu_torch.ops.cuda import in_q8_kernel

    acc, gamma, beta, relu, residual, inv_s, stream = args

    def bits(t):  # NHWC in memory: a view of its bytes
        return t.permute(0, 2, 3, 1).view(torch.uint8)

    first, again = in_q8_kernel.in_q8_cuda(*args), in_q8_kernel.in_q8_cuda(*args)
    repeats = all(a is None or torch.equal(bits(a), bits(b)) for a, b in zip(first, again))
    del first, again
    stream_k, codes_k = in_q8_kernel.in_q8_cuda(acc, gamma, beta, relu, residual, inv_s, True)
    stream_p, codes_p = in_act_q8_plain(acc, gamma, beta, relu, residual, inv_s, True)
    out = {"key": in_q8_key(args), "repeat_bit_equal": repeats,
           "stream_mismatches": int((bits(stream_k) != bits(stream_p)).sum()),
           "codes_mismatches": 0 if codes_k is None else int((codes_k != codes_p).sum()),
           "mean_order_equal": torch.equal(acc.mean(dim=(2, 3), dtype=torch.float32),
                                           acc.float().mean(dim=(2, 3)))}
    del stream_k, codes_k, stream_p, codes_p
    # Times: warm by events (the whole call: PyTorch's two means, the squares, the apply);
    # cold device time by the profiler; the bounds from the bytes at the HBM peak.
    once, moved = in_q8_bytes(args)
    out.update(ms=time_ms(lambda: in_q8_kernel.in_q8_cuda(*args), iters=10),
               plain_ms=time_ms(lambda: in_act_q8_plain(*args), iters=5, warmup=1),
               bound_ms=once / peaks["hbm"] * 1e3, moved_bound_ms=moved / peaks["hbm"] * 1e3)
    if device_times:
        out.update({f"{k}_device_ms": device_ms(lambda: in_q8_kernel.in_q8_cuda(*args), name,
                                                iters=10)
                    for k, name in (("call", ""), ("square", "in_q8_square_kernel"),
                                    ("apply", "in_q8_apply_kernel"))})
    return out


def phase_in_q8(peaks: dict, smi: str) -> dict:
    """The fused instance norm (``csrc/in_q8.cu``) against the plain op, bit for bit, on
    the real accumulators of the int8 TransformerNet's forward at 1024x1024 (B = 8 and 4,
    int32 and bf16 accumulators) and on the forward's output, its times beside the plain
    op's and its bounds, and its calls a ``stylize_int8`` batch; returns the kernels
    line's numbers."""
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize_int8
    from artist_style_transfer_tpu_torch.models import transformer_q as tq
    from artist_style_transfer_tpu_torch.models.transformer_q import (
        in_act_q8,
        quantize_transformer,
    )
    from artist_style_transfer_tpu_torch.ops.cuda import in_q8_kernel, qconv_kernel

    model = load_transfer_params(os.path.join(GOLDENS, "golden_transfer.pth"), device="cuda")
    calib = (np.random.default_rng(7).random((2, 128, 128, 3)) * 255).astype(np.float32)
    qmodel = quantize_transformer(model, calib)
    images = np.stack(eval_data()[:max(IN_Q8_BATCHES)])

    # No CPU form, no fallback: a CUDA accumulator the kernel cannot take raises.
    bad = torch.zeros((1, 12, 8, 8), dtype=torch.bfloat16, device="cuda").contiguous(
        memory_format=torch.channels_last)
    try:
        in_act_q8(bad, torch.ones(12, device="cuda"), torch.zeros(12, device="cuda"), True)
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "multiple of 8" in refused,
            f"in_q8: the kernel took C = 12: {refused}")

    # One stylize_int8 batch at the stylize cell's shape: 17 calls, 16 K2 launches.
    batch = images[:IN_Q8_BATCHES[0]]
    stylize_int8(qmodel, batch, device="cuda")
    torch.cuda.synchronize()
    in_q8_kernel.LAUNCHES = qconv_kernel.LAUNCHES = 0
    stylize_int8(qmodel, batch, device="cuda")
    torch.cuda.synchronize()
    launches, k2 = in_q8_kernel.LAUNCHES, qconv_kernel.LAUNCHES
    require(launches == IN_Q8_FORWARD and k2 == QCONV_TRANSFORMER,
            f"in_q8: a stylize_int8 batch made {launches} fused calls and {k2} K2 launches")

    paths, lines, forwards = {}, [], {}
    for n in IN_Q8_BATCHES:
        x = torch.as_tensor(images[:n], device="cuda")
        for accum in (torch.bfloat16, torch.int32):
            path = f"forward_{IN_Q8_SIZE}_b{n}_{str(accum).split('.')[-1]}"
            with torch.inference_mode():
                calls = record_in_q8_calls(lambda: qmodel(x, accum=accum))
                fused = qmodel(x, accum=accum)
                tq.in_act_q8 = tq.in_act_q8_plain
                try:
                    plain = qmodel(x, accum=accum)
                finally:
                    tq.in_act_q8 = in_act_q8
                forwards[path] = torch.equal(fused.view(torch.int16), plain.view(torch.int16))
                del fused, plain
            require(len(calls) == IN_Q8_FORWARD, f"in_q8: {len(calls)} calls in {path}")
            counts: dict[tuple, int] = {}
            for args in calls:
                counts[in_q8_key(args)] = counts.get(in_q8_key(args), 0) + 1
            checked = {}
            for args in calls:
                key = in_q8_key(args)
                if key in checked:
                    continue
                with torch.inference_mode():
                    checked[key] = check_in_q8_call(args, peaks, accum == torch.bfloat16)
                emit("in_q8", path=path, calls=counts[key], card=smi, **checked[key])
                lines.append(checked[key])
            del calls
            keys = ["ms", "plain_ms", "bound_ms", "moved_bound_ms"] + (
                ["call_device_ms", "square_device_ms", "apply_device_ms"]
                if accum == torch.bfloat16 else [])
            paths[path] = {k: sum(counts[key] * r[k] for key, r in checked.items()) for k in keys}
            emit("in_q8_forward", path=path, calls=IN_Q8_FORWARD, card=smi,
                 output_bit_equal_to_plain=forwards[path], **paths[path])
        del x
    torch.cuda.empty_cache()
    worst = {"stream_mismatches": sum(r["stream_mismatches"] for r in lines),
             "codes_mismatches": sum(r["codes_mismatches"] for r in lines)}
    require(all(r["repeat_bit_equal"] for r in lines), "in_q8: two runs differ")
    require(worst["stream_mismatches"] == 0 and worst["codes_mismatches"] == 0,
            f"in_q8: the fused op differs from the plain op on the card: {worst}")
    require(all(forwards.values()), f"in_q8: the forward differs from the plain one: {forwards}")
    return {"paths": paths, "worst": {**worst, "forward_bit_equal": forwards},
            "launches": {"stylize_int8": launches},
            "refused": refused}


def counted_train(mode: str, artist: str, tmp: str, **kw) -> dict:
    """``train()`` with the K1, K2 and ``_int_mm`` counters zeroed just before it and read
    just after; with its per-step losses and epoch records from ``metrics.jsonl``."""
    from artist_style_transfer_tpu_torch.ops import gram as gram_ops
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel, qconv_kernel
    from artist_style_transfer_tpu_torch.train import train

    model_dir = tempfile.mkdtemp(dir=tmp)
    sync()
    gram_kernel.LAUNCHES = qconv_kernel.LAUNCHES = gram_ops.INT_MM_CALLS = 0
    t0 = time.perf_counter()
    model, losses = train(mode, artist, model_dir=model_dir, log_every_batches=1, **kw)
    sync()
    seconds = time.perf_counter() - t0
    counts = {"k2": qconv_kernel.LAUNCHES, "k1": gram_kernel.LAUNCHES,
              "int_mm": gram_ops.INT_MM_CALLS}
    events = read_jsonl(os.path.join(model_dir, artist, mode, "metrics.jsonl"))
    steps = np.array([[e["content_loss"], e["style_loss"], e["total_loss"]]
                      for e in events if e["event"] == "batch"])
    epochs = [e for e in events if e["event"] == "epoch"]
    warm = epochs[1:] or epochs
    warm_steps = len(steps) * len(warm) // len(epochs)
    return {"model": model, "losses": losses, "steps": steps, "counts": counts,
            "seconds": seconds, "epoch_secs": [e["secs"] for e in epochs],
            "ms_per_step": sum(e["secs"] for e in warm) * 1e3 / warm_steps,
            "images_per_sec": warm_steps * TRAIN_BATCH / sum(e["secs"] for e in warm)}


def check_int8_run(name: str, run: dict, epochs: int, per_step: dict, setup: dict) -> dict:
    """Finite per-step losses, falling over more than one epoch, and each counter at
    ``setup`` (the style targets) plus ``per_step`` a step; returns the line's fields."""
    steps = run["steps"]
    spe = -(-TRAIN_CONTENT // TRAIN_BATCH)
    require(steps.shape == (epochs * spe, 3), f"int8_train {name}: {steps.shape} step records")
    require(bool(np.isfinite(steps).all()) and bool(np.isfinite(run["losses"]).all()),
            f"int8_train {name}: a loss is not finite")
    if epochs > 1:
        losses = run["losses"]
        require(losses[-1, 2] < losses[0, 2], f"int8_train {name}: epoch {epochs} total "
                                              f"{losses[-1, 2]} not below epoch 1's {losses[0, 2]}")
    want = {k: setup.get(k, 0) + per_step.get(k, 0) * len(steps) for k in run["counts"]}
    require(run["counts"] == want, f"int8_train {name}: launches {run['counts']} != {want}")
    return {"epochs": epochs, "steps": int(len(steps)), "epoch_losses": run["losses"].tolist(),
            "launches": run["counts"], "launches_per_step": per_step, "seconds": run["seconds"],
            "epoch_secs": run["epoch_secs"], "ms_per_step": run["ms_per_step"],
            "images_per_sec": run["images_per_sec"]}


def record_step(fns, data: torch.Tensor, r22: torch.Tensor) -> tuple[list, list]:
    """The K2 calls of one training step, split into the forward's and the backward's
    (every int8 conv of a step launches once in each, the forward's first)."""
    calls = record_qconv_calls(lambda: fns.step_fn(data[:TRAIN_BATCH], r22[:TRAIN_BATCH], 0))
    half = len(calls) // 2
    require(len(calls) == 2 * half, f"int8_train: {len(calls)} K2 calls in a step")
    return calls[:half], calls[half:]


def check_int8_gram(peaks: dict) -> dict:
    """The int8 Gram's ``torch._int_mm`` route against its plain version (the codes in
    f64) at relu3_3 and relu4_3 of a 224x224 B=4 step, forward and backward products:
    int32 error 0; times (warm events), the plain version's on the card, the bound."""
    from artist_style_transfer_tpu_torch.ops import gram as gram_ops

    out = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, down, c in INT8_GRAM_TAPS:
        hw = (TRAIN_SIZE // down) ** 2
        rows = gram_ops._int_mm_rows(hw)
        fq = torch.zeros((TRAIN_BATCH, rows, c), dtype=torch.int8, device="cuda")
        fq[:, :hw] = torch.randint(-127, 128, (TRAIN_BATCH, hw, c), generator=gen,
                                   device="cuda", dtype=torch.int8)
        sym = torch.randint(-127, 128, (TRAIN_BATCH, c, c), generator=gen, device="cuda",
                            dtype=torch.int8)
        fq_t = fq.transpose(1, 2).contiguous()
        line = {"tap": name, "n": TRAIN_BATCH, "hw": hw, "rows": rows, "c": c}
        for kind, a, b_t in (("forward", fq_t, fq_t), ("backward", fq, sym.transpose(1, 2))):
            got = gram_ops.int8_products(a, b_t)
            ref = torch.bmm(a.double(), b_t.double().transpose(1, 2))
            err = int((got.double() - ref).abs().max().item())
            require(err == 0, f"int8 Gram {name} {kind}: _int_mm off the f64 product by {err}")
            m, k = a.shape[1], a.shape[2]
            ops = 2.0 * TRAIN_BATCH * m * k * b_t.shape[1]
            nbytes = a.numel() + (0 if kind == "forward" else b_t.numel()) + got.numel() * 4
            t_ops, t_bytes = ops / peaks["int8"] * 1e3, nbytes / peaks["hbm"] * 1e3
            line[kind] = {
                "max_abs_err": err,
                "ms": time_ms(lambda a=a, b_t=b_t: gram_ops.int8_products(a, b_t)),
                "plain_ms": time_ms(lambda a=a, b_t=b_t: torch.bmm(
                    a.double(), b_t.double().transpose(1, 2)), iters=5, warmup=1),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        out.append(line)
    return {"taps": out, **{f"{k}_{kind}": sum(t[kind][k] for t in out)
                            for k in ("ms", "plain_ms", "bound_ms")
                            for kind in ("forward", "backward")}}


def int8_cli(tmp: str, size: int) -> dict:
    """``train_style_transfer.main`` with ``--quantize_loss --qat`` for one epoch over a
    small seeded workspace: finite losses, its K2 launches, the ``.pth`` reloading."""
    from artist_style_transfer_tpu_torch import train_style_transfer
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize
    from artist_style_transfer_tpu_torch.ops.cuda import qconv_kernel

    n_paint = 8
    ws = data_workspace(os.path.join(tmp, "ws"), n_content=INT8_CLI_CONTENT,
                        artists=(("Seeded Artist", n_paint),))
    model_dir = os.path.join(tmp, "cli_models")
    sync()
    qconv_kernel.LAUNCHES = 0
    model, losses = train_style_transfer.main([
        "--style_method", "cycle", "--artist", ws["artist"], "--num_epochs", "1",
        "--batch_size", str(TRAIN_BATCH), "--content_data_size", str(INT8_CLI_CONTENT),
        "--train_size", str(size), "--log_every_batches", "1", "--quantize_loss", "--qat",
        "--content_dir", ws["content"], "--archive_dir", ws["archive"],
        "--cache_dir", ws["cache"], "--model_dir", model_dir, "--vgg_path", ws["vgg"],
        "--quiet"])
    sync()
    launches = qconv_kernel.LAUNCHES
    run_dir = os.path.join(model_dir, ws["artist"], "cycle")
    _, batches, _ = metrics_of(run_dir)
    per_step = 2 * (QCONV_QAT["trunk"] + QCONV_VGG_DEEP)
    want = per_step * len(batches) + QCONV_VGG_DEEP * -(-n_paint // 8)
    require(bool(np.isfinite(losses).all()), f"int8 CLI: losses {losses.tolist()}")
    require(launches == want, f"int8 CLI: {launches} K2 launches != {want}")
    probe = np.random.default_rng(5).uniform(0, 255, (1, size, size, 3)).astype(np.float32)
    ref = stylize(model, probe, clip=False, device="cuda").float().cpu().numpy()
    out = stylize(load_transfer_params(os.path.join(run_dir, "transfer_17-25_1.pth"),
                                       device="cuda"), probe, clip=False,
                  device="cuda").float().cpu().numpy()
    db = psnr(out, ref)
    require(db > 45.0, f"int8 CLI: the .pth export {db} dB from the model")
    return {"steps": len(batches), "epoch_losses": losses.tolist(), "k2_launches": launches,
            "pth_reload_db": db}


def phase_int8_train(peaks: dict, smi: str) -> dict:
    """Int8 training on the card: ``train()`` with ``quantize_loss``, with ``qat`` and
    through a quantized classifier, K2's forward and data-gradient shapes against the
    plain version, the int8 Gram's ``_int_mm`` route, and the CLI's int8 flags."""
    from artist_style_transfer_tpu_torch.models.resnet_q import quantize_classifier
    from artist_style_transfer_tpu_torch.models.transformer import ENCODER_SPEC
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16, quantize_vgg16_loss

    vgg = init_vgg16(torch.Generator().manual_seed(0), device="cuda")
    content, paintings = train_data()
    chunks = -(-TRAIN_PAINTINGS // 8)
    kw = dict(batch_size=TRAIN_BATCH, seed=0, num_steps=2, save_every=0, content_images=content,
              paintings=paintings, vgg=vgg, device="cuda", wordy=False,
              compute_dtype="bfloat16")
    deep = {"k2": 2 * QCONV_VGG_DEEP, "k1": 2, "int_mm": 2 * len(INT8_GRAM_TAPS) * TRAIN_BATCH}
    setup = {"k2": QCONV_VGG_DEEP * chunks, "k1": 4 * chunks}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_int8_train_")
    lines, ms = {}, {}
    try:
        # The main paths, each with its counters zeroed just before it.
        base = counted_train("cycle", "Seeded", tmp, num_epochs=INT8_TRAIN_EPOCHS, **kw)
        lines["bf16"] = check_int8_run("bf16", base, INT8_TRAIN_EPOCHS, {"k1": 4}, setup={
            "k1": 4 * chunks})
        ql = counted_train("cycle", "Seeded", tmp, num_epochs=INT8_TRAIN_EPOCHS,
                           quantize_loss=True, **kw)
        lines["quantize_loss"] = check_int8_run("quantize_loss", ql, INT8_TRAIN_EPOCHS, deep,
                                                setup)
        frozen = [n for n, p in vgg.named_parameters() if p.grad is not None]
        require(not frozen, f"int8_train: VGG parameters with a .grad: {frozen[:4]}")
        qat = counted_train("cycle", "Seeded", tmp, num_epochs=INT8_TRAIN_EPOCHS,
                            quantize_loss=True, qat="trunk", **kw)
        lines["qat_trunk"] = check_int8_run(
            "qat_trunk", qat, INT8_TRAIN_EPOCHS,
            {**deep, "k2": deep["k2"] + 2 * QCONV_QAT["trunk"]}, setup)
        # A gradient on every quantized layer's weight and gamma, and on the output conv.
        model = qat["model"]
        quantized = [model.ConvBlock[2 * i] for i, (_, _, _, co) in enumerate(ENCODER_SPEC)
                     if i and co == 128] + [m for b in model.ResidualBlock
                                            for m in (b.conv1, b.conv2)]
        leaves = [(m.conv_layer.weight, m.norm_layer.weight) for m in quantized] + [
            (model.DeconvBlock[0].conv_transpose.weight, model.DeconvBlock[0].norm_layer.weight),
            (model.DeconvBlock[-1].conv_layer.weight,)]
        require(all(p.grad is not None and bool(p.grad.abs().max() > 0)
                    for group in leaves for p in group),
                "int8_train qat: a quantized layer's weight or gamma, or the output conv, "
                "has no gradient")
        qat_all = counted_train("cycle", "Seeded", tmp, num_epochs=1, quantize_loss=True,
                                qat="all", **kw)
        lines["qat_all"] = check_int8_run(
            "qat_all", qat_all, 1, {**deep, "k2": deep["k2"] + 2 * QCONV_QAT["all"]}, setup)
        qclf = quantize_classifier(seeded_classifier("cuda"))
        clf_kw = dict(kw, paintings=None, classifier=qclf)
        cl = counted_train("classifier", CLF_ARTIST, tmp, num_epochs=1, **clf_kw)
        lines["classifier"] = check_int8_run("classifier", cl, 1, {"k2": 2 * QCONV_RESNET}, {})
        require(all(p.grad is not None and bool(p.grad.abs().max() > 0)
                    for n, p in cl["model"].named_parameters() if n.endswith("conv_layer.weight")),
                "int8_train classifier: no gradient reached a TransformerNet conv")
        del base, ql, qat, qat_all, cl, model, leaves

        # Warm ms/step of each configuration (phase train's measure), and K2 against plain
        # on one recorded step of each int8 net: every forward and data-gradient shape.
        # A step's forward launches come first, then the backward's in reverse order.
        clf = seeded_classifier("cuda")
        qvgg = quantize_vgg16_loss(vgg, "deep", dtype=torch.bfloat16)
        nq = QCONV_QAT["all"]
        recorded = {"quantize_loss": ("vgg", slice(None), slice(None)),
                    "qat_all": ("qat_all", slice(0, nq), slice(QCONV_VGG_DEEP, None)),
                    "classifier_int8": ("resnet", slice(None), slice(None))}
        shapes, calls = {}, {}
        for name, net, step_kw in (("bf16", vgg, {}), ("quantize_loss", qvgg, {}),
                                   ("qat_trunk", qvgg, {"qat": "trunk"}),
                                   ("qat_all", qvgg, {"qat": "all"}),
                                   ("classifier_bf16", vgg, {"classifier": clf}),
                                   ("classifier_int8", vgg, {"classifier": qclf})):
            fns, data, r22 = train_step_fns(
                net, content, None if "classifier" in step_kw else paintings, "auto", "cuda",
                compute_dtype="bfloat16", **step_kw)
            if name in recorded:
                key, fwd, bwd = recorded[name]
                forward, backward = record_step(fns, data, r22)
                calls[f"{key}_fwd"], calls[f"{key}_dgrad"] = forward[fwd], backward[bwd]
            ms[name] = warm_ms_per_step(fns, data, r22)
        grads = [n for net in (qvgg, qclf) for n, b in net.named_buffers() if b.grad is not None]
        require(not grads, f"int8_train: int8 net buffers with a .grad: {grads[:4]}")
        require([len(calls[k]) for k in ("vgg_fwd", "qat_all_fwd", "resnet_fwd")]
                == [QCONV_VGG_DEEP, nq, QCONV_RESNET],
                f"int8_train: recorded {[(k, len(v)) for k, v in calls.items()]}")
        for key, group in calls.items():
            shapes[f"train_{key}"] = check_qconv_shapes(group, f"train_{key}", peaks)
        del calls
        gram = check_int8_gram(peaks)
        emit("int8_gram", **gram, card=smi)
        cli = int8_cli(tmp, TRAIN_SIZE)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("int8_train", size=TRAIN_SIZE, batch=TRAIN_BATCH, content=TRAIN_CONTENT,
         paintings=TRAIN_PAINTINGS, compute_dtype="bfloat16", runs=lines,
         warm_ms_per_step=ms, cli=cli, card=smi)
    launches = {f"int8_train_{k}": v["launches"]["k2"] for k, v in lines.items() if k != "bf16"}
    launches["int8_train_cli"] = cli["k2_launches"]
    return {"shapes": shapes, "launches": launches, "gram": gram,
            "k1_launches": {f"int8_train_{k}": v["launches"]["k1"] for k, v in lines.items()}}


def eval_cli_int8(tmp: str, pth: str, model, clf, artist: int) -> dict:
    """``inference.py --no-display --quantize`` on INT8_CLI_IMAGES seeded JPEGs on the
    default device: its ``Acc=`` against ``evaluate_with_classifier(quantize=True)`` on
    the same files decoded by cv2 in the CLI's shuffled order (the first two calibrate)."""
    import contextlib
    import io
    import random

    import cv2

    from artist_style_transfer_tpu_torch import inference
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier
    from artist_style_transfer_tpu_torch.ops.cuda import qconv_kernel

    content = os.path.join(tmp, "content")
    model_dir = os.path.join(tmp, "models", CLF_ARTIST, "random")
    os.makedirs(content)
    os.makedirs(model_dir)
    shutil.copy(pth, model_dir)
    clf_path = os.path.join(tmp, "best-2.pth")
    torch.save({"model": clf.state_dict()}, clf_path)
    rng = np.random.default_rng(9)
    for i in range(INT8_CLI_IMAGES):
        cv2.imwrite(os.path.join(content, f"c{i}.jpg"),
                    rng.integers(0, 256, (600, 800, 3), dtype=np.uint8))
    out = io.StringIO()
    qconv_kernel.LAUNCHES = 0
    with contextlib.redirect_stdout(out):
        acc = inference.main(["--no-display", "--quantize", "--artist", CLF_ARTIST,
                              "--style_method", "random", "--model_filename",
                              os.path.basename(pth), "--model_dir", os.path.join(tmp, "models"),
                              "--content_dir", content, "--classifier_path", clf_path,
                              "--seed", "0"])
    launches = qconv_kernel.LAUNCHES
    lines = out.getvalue().splitlines()
    files = [f for f in os.listdir(content) if ".jpg" in f]
    random.Random(0).shuffle(files)  # the CLI's order
    direct = evaluate_with_classifier(
        model, clf, [cv2.resize(cv2.imread(os.path.join(content, f)), (EVAL_SIZE, EVAL_SIZE))
                     for f in files], artist, batch_size=CLF_BATCH, wordy=False, quantize=True)
    require(f"Grabbed {INT8_CLI_IMAGES} images!" in lines and lines[-1] == f"Acc={acc}",
            f"int8 eval CLI output: {lines[:2]} ... {lines[-1:]}")
    require(acc == direct, f"int8 eval CLI Acc={acc} vs a direct call's {direct}")
    require(launches == QCONV_TRANSFORMER + QCONV_RESNET,
            f"int8 eval CLI: {launches} K2 launches for one batch")
    return {"images": INT8_CLI_IMAGES, "accuracy": acc, "direct_accuracy": direct,
            "k2_launches": launches}


def artist_corpus(n: int = ARTIST_CLF_IMAGES, size: int = ARTIST_CLF_SIZE,
                  classes: int = ARTIST_CLF_CLASSES) -> tuple[np.ndarray, np.ndarray]:
    """Seeded paintings of ``classes`` artists, artist ``i % classes`` for image ``i``,
    each artist's tinted by a colour of its own so that the classifier can learn them:
    NHWC RGB torchvision-normalized f32 (what ``get_painting_dataset(for_classifier=True)``
    yields) and int32 labels."""
    import cv2

    from artist_style_transfer_tpu_torch.ops.image import (
        TORCHVISION_MEAN_RGB,
        TORCHVISION_STD_RGB,
    )

    rng = np.random.default_rng(11)
    tints = rng.uniform(-60.0, 60.0, (classes, 3))
    labels = np.arange(n) % classes
    images = np.empty((n, size, size, 3), np.float32)
    for i, artist in enumerate(labels):
        bgr = np.clip(smooth_image(cv2, rng, size, size) + tints[artist], 0.0, 255.0)
        images[i] = (bgr[..., ::-1] / 255.0 - TORCHVISION_MEAN_RGB) / TORCHVISION_STD_RGB
    return images, labels.astype(np.int32)


def phase_train_artist_classifier(peaks: dict | None, smi: str, device: str = "cuda",
                                  n: int = ARTIST_CLF_IMAGES, size: int = ARTIST_CLF_SIZE,
                                  batch: int = ARTIST_CLF_BATCH,
                                  workspace=data_workspace) -> dict:
    """``train_classifier`` at full width on a seeded corpus, its export, and the classifier
    CLI on phase data's seeded workspace. Returns the best model, the CLI's ``best-2.pth``
    (for phase serve), the temp dir holding it, and the K1 launches of the main path."""
    import copy

    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    from artist_style_transfer_tpu_torch.models.resnet import (
        classifier_apply_train,
        init_classifier,
        load_classifier,
    )
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel, qconv_kernel
    from artist_style_transfer_tpu_torch.train import classifier as tclf
    from artist_style_transfer_tpu_torch.train.checkpoint import export_classifier_pth

    on_card = device != "cpu"
    images, labels = artist_corpus(n, size)
    init = init_classifier(torch.Generator().manual_seed(2), device)
    params = sum(p.numel() for p in init.parameters())
    require(params == 25_624_659, f"artist classifier: {params} parameters, not full width")
    n_val = int(round(n * 0.2))
    steps = (n - n_val) // batch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_artist_clf_")
    metrics = os.path.join(tmp, "metrics.jsonl")
    kw = dict(batch_size=batch, seed=2, wordy=False, device=device)

    # The main path: freeze_body=True, counters zeroed just before, read just after.
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    gram_kernel.LAUNCHES = qconv_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    best, hist = tclf.train_classifier(images, labels, num_epochs=ARTIST_CLF_EPOCHS,
                                       freeze_body=True, model=init, metrics_path=metrics, **kw)
    sync()
    seconds = time.perf_counter() - t0
    k1, k2 = gram_kernel.LAUNCHES, qconv_kernel.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    epochs = [e for e in read_jsonl(metrics) if e["event"] == "classifier_epoch"]
    losses = hist["train_loss"]
    require(len(epochs) == ARTIST_CLF_EPOCHS and bool(np.isfinite(losses).all()),
            f"train_artist_classifier: epoch losses {losses}")
    require(losses[-1] < losses[0], f"train_artist_classifier: train loss {losses} not falling")
    require(k1 == 0 and k2 == 0,
            f"train_artist_classifier: {k1} K1 and {k2} K2 launches on a path with neither")
    start, trained = init.state_dict(), best.state_dict()
    convs = [f"{name}.weight" for name, m in init.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    moved = [k for k in convs if not torch.equal(trained[k], start[k])]
    require(len(convs) == 53 and not moved,
            f"train_artist_classifier: frozen conv weights changed: {moved[:4]}")
    bns = [name for name, m in init.named_modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    stats_moved = [b for b in bns if not torch.equal(trained[f"{b}.running_mean"],
                                                       start[f"{b}.running_mean"])
                   and not torch.equal(trained[f"{b}.running_var"], start[f"{b}.running_var"])]
    require(len(stats_moved) == len(bns) == 55,
            f"train_artist_classifier: {len(stats_moved)} of {len(bns)} BN statistics moved")
    require(not torch.equal(trained["0.1.weight"], start["0.1.weight"])
            and not torch.equal(trained["1.8.weight"], start["1.8.weight"]),
            "train_artist_classifier: the BN affines or the head did not train")
    warm = epochs[1:]
    warm_s = sum(e["secs"] for e in warm)

    # One epoch with the body unfrozen, from the frozen run's best.
    unfrozen, hist_u = tclf.train_classifier(images, labels, num_epochs=1, freeze_body=False,
                                             model=best, **kw)
    require(bool(np.isfinite(hist_u["train_loss"]).all()),
            f"train_artist_classifier unfrozen: {hist_u}")
    require(any(not torch.equal(unfrozen.state_dict()[k], trained[k]) for k in convs),
            "train_artist_classifier unfrozen: no conv weight trained")

    # The FLOPs of one step (forward, dgrad, and wgrad where a weight trains) and their
    # bound at f32 accuracy, as the other train phases count them.
    xb = torch.as_tensor(images[:batch], device=device)
    yb = torch.as_tensor(labels[:batch], dtype=torch.int64, device=device)
    flops = {}
    for freeze in (True, False):
        m = copy.deepcopy(init)
        tclf.make_classifier_optimizer(m, 1e-3, 4, 1e-2, freeze)
        with FlopCounterMode(display=False) as counter:
            logits, _ = classifier_apply_train(m, xb)
            F.cross_entropy(logits, yb).backward()
        flops["frozen" if freeze else "unfrozen"] = counter.get_total_flops()
        del m
    bound_ms = (min(flops["frozen"] / peaks["fp32"], 3 * flops["frozen"] / peaks["tf32"]) * 1e3
                if peaks else None)

    # The export reloads with the same logits.
    pth = os.path.join(tmp, "best-2.pth")
    export_classifier_pth(pth, best)
    x = torch.as_tensor(images[:4], device=device)
    with torch.inference_mode():
        same = torch.equal(best(x), load_classifier(pth, device)(x))
    require(same, "train_artist_classifier: the exported best-2.pth gives other logits")

    # The classifier CLI on phase data's seeded workspace, one epoch, in a subprocess run
    # from the workspace's root (the reference's relative data paths).
    root = os.path.join(tmp, "ws")
    workspace(root, n_content=1)  # the classifier CLI reads images/archive/ alone
    out_dir = os.path.join(tmp, "cli_models")
    cmd = [sys.executable, "-m", "artist_style_transfer_tpu_torch.train.classifier",
           "--num_epochs", "1", "--batch_size", str(ARTIST_CLF_CLI_BATCH),
           "--out_dir", out_dir, "--metrics", os.path.join(tmp, "cli_metrics.jsonl")]
    if not on_card:
        cmd += ["--device", device, "--rescale_height", str(size), "--rescale_width", str(size)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=port_env(), capture_output=True, text=True,
                          timeout=900)
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"classifier CLI exited {proc.returncode}: "
                                  f"{proc.stdout[-1500:]}{proc.stderr[-1500:]}")
    cli_pth = os.path.join(out_dir, "best-2.pth")
    require("exported" in proc.stdout and os.path.exists(cli_pth)
            and os.path.exists(os.path.join(out_dir, "classifier.npz")),
            f"classifier CLI: {proc.stdout[-500:]}")
    cli_epochs = [e for e in read_jsonl(os.path.join(tmp, "cli_metrics.jsonl"))
                  if e["event"] == "classifier_epoch"]
    with torch.inference_mode():
        cli_logits = load_classifier(cli_pth, device)(x).float()
    require(tuple(cli_logits.shape) == (4, 19) and bool(torch.isfinite(cli_logits).all()),
            f"classifier CLI: best-2.pth logits {tuple(cli_logits.shape)}")
    emit("train_artist_classifier", size=size, batch=batch, images=n, classes=ARTIST_CLF_CLASSES,
         params=params, epochs=ARTIST_CLF_EPOCHS, steps_per_epoch=steps,
         epoch_losses=losses, train_acc=hist["train_acc"], val_acc=hist["val_acc"],
         unfrozen_loss=hist_u["train_loss"], unfrozen_val_acc=hist_u["val_acc"],
         k1_launches=k1, k2_launches=k2, seconds=seconds,
         epoch_secs=[e["secs"] for e in epochs],
         ms_per_step=warm_s * 1e3 / (len(warm) * steps),
         images_per_sec=len(warm) * steps * batch / warm_s,
         times_are="host clock over epochs 2-3, each epoch's validation pass included",
         step_gflop={k: v / 1e9 for k, v in flops.items()}, step_bound_ms=bound_ms,
         step_bound_share=(bound_ms * len(warm) * steps / (warm_s * 1e3)
                           if bound_ms else None),
         peak_mem_gib=peak_gib, bn_stats_moved=len(stats_moved), frozen_convs=len(convs),
         cli={"seconds": cli_s, "epochs": cli_epochs, "stdout_tail": proc.stdout[-200:]},
         card=smi)
    return {"best": best, "cli_pth": cli_pth, "tmp": tmp, "launches": k1}


def port_env() -> dict:
    """The environment of a subprocess that imports the port from this checkout."""
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": ROOT if not path else ROOT + os.pathsep + path}


def timed_server(**kw):
    """A ``StylizeServer`` that stamps each request: ``t_submit`` when it is queued,
    ``t_taken`` when the worker takes its batch, ``t_done`` when its result is set (the
    batch's stack, copies and forward); and records each batch (input, output) while
    ``batches`` is a list."""
    from artist_style_transfer_tpu_torch.infer.serve import StylizeServer, _apply_params

    class TimedServer(StylizeServer):
        def __init__(self, **kw):
            self.batches, self.futures = None, []
            super().__init__(apply_fn=self._recorded, **kw)

        def submit(self, image, model=None):
            t = time.perf_counter()
            fut = super().submit(image, model)
            fut.t_submit = t
            fut.add_done_callback(lambda f: setattr(f, "t_done", time.perf_counter()))
            self.futures.append(fut)
            return fut

        def _take_batch(self):
            item = super()._take_batch()
            if item is not None:
                t = time.perf_counter()
                for _, fut in item[1]:
                    fut.t_taken = t
            return item

        def _recorded(self, params, images):
            out = _apply_params(params, images)
            if self.batches is not None:
                self.batches.append((images.cpu().numpy(), out))
            return out

    return TimedServer(**kw)


class TimedCv2:
    """OpenCV with ``imdecode`` and ``imencode`` timed: (shape, seconds) of each call."""

    def __init__(self, cv2):
        self._cv2, self.decode, self.encode = cv2, [], []

    def __getattr__(self, name):
        return getattr(self._cv2, name)

    def imdecode(self, *args):
        t = time.perf_counter()
        out = self._cv2.imdecode(*args)
        self.decode.append((None if out is None else out.shape, time.perf_counter() - t))
        return out

    def imencode(self, ext, img, *args):
        t = time.perf_counter()
        out = self._cv2.imencode(ext, img, *args)
        self.encode.append((img.shape, time.perf_counter() - t))
        return out


def http_post(url: str, body: bytes) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_get(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        require(r.status == 200, f"GET {url}: {r.status}")
        return json.loads(r.read())


# The load generator of phase serve, run in a process of its own so that its threads do
# not compete with the server's for the interpreter lock: argv[1] is the JSON of [base,
# [[path, body file], ...], clients, out dir]; client k sends requests k, k + clients, ...
# one at a time. Prints the round's wall seconds and [status, response file, seconds] of
# each request; the responses are written after the round.
SERVE_CLIENT = """
import json, sys, threading, time, urllib.error, urllib.request
base, reqs, clients, out_dir = json.loads(sys.argv[1])
bodies = [open(f, "rb").read() for _, f in reqs]
res = [None] * len(reqs)
def post(i):
    t = time.perf_counter()
    req = urllib.request.Request(base + reqs[i][0], data=bodies[i], method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    res[i] = [status, body, time.perf_counter() - t]
def client(k):
    for i in range(k, len(reqs), clients):
        post(i)
threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
for i, r in enumerate(res):
    with open(f"{out_dir}/{i}.out", "wb") as f:
        f.write(r[1])
    r[1] = f"{out_dir}/{i}.out"
print(json.dumps({"wall": wall, "results": res}))
"""


def http_round(base: str, requests: list[tuple[str, str]], clients: int = SERVE_CLIENTS):
    """Send ``requests`` (path, body file) from ``clients`` threads of a client process
    (``SERVE_CLIENT``); returns [(status, body, seconds)] in request order and the wall
    seconds of the round."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_client_")
    try:
        proc = subprocess.run([sys.executable, "-c", SERVE_CLIENT,
                               json.dumps([base, requests, clients, out_dir])],
                              capture_output=True, text=True, timeout=900)
        require(proc.returncode == 0, f"serve client: {proc.stderr[-1500:]}")
        out = json.loads(proc.stdout)
        results = []
        for status, path, seconds in out["results"]:
            with open(path, "rb") as fh:
                results.append((status, fh.read(), seconds))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return results, out["wall"]


def warm_batches(srv, images: list[np.ndarray], model: str | None = None) -> None:
    """A batch of each size 1..SERVE_MAX_BATCH through the server's worker thread:
    cuDNN and cuBLAS keep their handles per thread, and each batch size meets its first
    call here rather than inside a timed request."""
    for b in range(1, SERVE_MAX_BATCH + 1):
        futs = [srv.submit(im, model=model) for im in images[:b]]
        for fut in futs:
            fut.result(timeout=600)


def image_key(im: np.ndarray) -> bytes:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(im).tobytes()).digest()


def round_report(results, wall: float, server, stats0: dict, stats1: dict, cv2t: TimedCv2,
                 size: int) -> dict:
    """Served images/s, request latency percentiles, batch fill, and where a stylize
    request's time went (means, ms): the server's decode, the queue (submit to the
    batch's take), the batch's dispatch (stack, copies, forward, clip), the encode; and
    the rest (HTTP and the handler) to the client's latency."""
    lat = np.array([r[2] for r in results]) * 1e3
    futs = server.futures[-len(results):]
    queue = np.mean([(f.t_taken - f.t_submit) * 1e3 for f in futs])
    device = np.mean([(f.t_done - f.t_taken) * 1e3 for f in futs])
    decode = np.mean([s * 1e3 for shape, s in cv2t.decode if shape and shape[:2] == (size, size)])
    encode = np.mean([s * 1e3 for shape, s in cv2t.encode if shape[:2] == (size, size)])
    batches = stats1["batches"] - stats0["batches"]
    images = stats1["images"] - stats0["images"]
    return {"requests": len(results), "wall_s": wall, "images_per_sec": images / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()), "batches": batches, "images": images,
            "mean_batch_fill": images / batches,
            "split_ms": {"decode": decode, "queue": queue, "device": device, "encode": encode,
                         "rest": float(lat.mean()) - decode - queue - device - encode}}


def check_int8_round(results, wall: float, mixed, images, clf_images, direct, srv_q,
                     clf_batches, qmodel, qclf, stats0: dict, stats1: dict, cv2t: TimedCv2,
                     size: int, device: str) -> dict:
    """One int8 round of phase serve held to serial runs of the same batch compositions
    (each stylize batch bit-equal to ``stylize_int8`` of its images, each classify
    batch's top-1 equal to ``classifier_apply_int8``'s), each response to its batch's
    output, and the stylize outputs to the f32 stylize (> 45 dB); returns its report."""
    import cv2

    from artist_style_transfer_tpu_torch.infer import http_server as hs
    from artist_style_transfer_tpu_torch.infer.stylize import stylize_int8
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19
    from artist_style_transfer_tpu_torch.models.resnet_q import classifier_apply_int8
    from artist_style_transfer_tpu_torch.ops.image import bgr_to_rgb, torchvision_normalize

    served = {}
    for inp, out in srv_q.batches:
        serial = stylize_int8(qmodel, inp, device=device).cpu().numpy()
        require(np.array_equal(serial, out), "serve int8: a batch differs from a serial "
                                             "stylize_int8 of the same images")
        served.update({image_key(im): o for im, o in zip(inp, out)})
    top1, probs_diff = {}, 0.0
    for inp, probs in clf_batches:
        with torch.inference_mode():
            xq = torch.as_tensor(inp, device=device)
            logits = classifier_apply_int8(qclf, torchvision_normalize(
                bgr_to_rgb(xq.float()) / 255.0))
            serial = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        require(np.array_equal(serial.argmax(-1), probs.argmax(-1)),
                "serve classify: a batch's top-1 differs from a serial classifier_apply_int8")
        probs_diff = max(probs_diff, float(np.abs(serial - probs).max()))
        top1.update({image_key(im): int(p.argmax()) for im, p in zip(inp, probs)})
    s_results = [r for r, q in zip(results, mixed) if q[0].startswith("/v1/stylize")]
    c_results = [r for r, q in zip(results, mixed) if q[0] == "/v1/classify"]
    dbs = []
    for r, im, d in zip(s_results, images, direct):
        got = cv2.imdecode(np.frombuffer(r[1], np.uint8), cv2.IMREAD_COLOR)
        require(np.array_equal(got, served[image_key(im)]),
                "serve int8: a response is not its batch's output")
        dbs.append(psnr(got, d))
    require(min(dbs) > 45.0, f"serve int8: {min(dbs)} dB against the f32 stylize")
    answers = []
    for r, im in zip(c_results, clf_images):
        out = json.loads(r[1])
        want = top1[image_key(hs.classify_crop(cv2, im))]
        require(out["index"] == want and out["artist"] == ARTISTS_19[want]
                and len(out["top3"]) == 3, f"serve classify: {out} vs serial top-1 {want}")
        answers.append(out["index"])
    report = round_report(s_results, wall, srv_q, {"batches": 0, "images": 0},
                          {"batches": len(srv_q.batches), "images": len(s_results)}, cv2t, size)
    return {**report, "served_per_sec": len(results) / wall, "min_psnr_vs_f32_db": min(dbs),
            "classify_batches": stats1["classify"]["batches"] - stats0["classify"]["batches"],
            "classify_images": stats1["classify"]["images"] - stats0["classify"]["images"],
            "classify_p50_ms": float(np.percentile([r[2] * 1e3 for r in c_results], 50)),
            "classify_answers": answers, "classify_probs_max_diff": probs_diff,
            "stylize_batches_bit_equal": len(srv_q.batches)}


def medians(rounds: list[dict]) -> dict:
    """The median of each number the rounds share (a split's parts included)."""
    out = {}
    for k, v in rounds[0].items():
        if isinstance(v, dict):
            out[k] = medians([r[k] for r in rounds])
        elif isinstance(v, (int, float)):
            out[k] = float(np.median([r[k] for r in rounds]))
    return out


def phase_serve(smi: str, clf, clf_cli_pth: str, device: str = "cuda", size: int = SERVE_SIZE,
                profile: bool = False) -> dict:
    """The HTTP serving stack at full width: one in-process ``make_http_server`` for f32
    stylize (then a hot reload), one for int8 stylize and classify together, then the
    ``main`` CLI in a subprocess. Returns the K1 and K2 launches by path."""
    import threading

    import cv2

    from artist_style_transfer_tpu_torch.infer import http_server as hs
    from artist_style_transfer_tpu_torch.infer.serve import ModelRegistry
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize
    from artist_style_transfer_tpu_torch.models.resnet_q import quantize_classifier
    from artist_style_transfer_tpu_torch.models.transformer import init_transformer
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel, qconv_kernel
    from artist_style_transfer_tpu_torch.train.checkpoint import export_pth, save_params_npz

    on_card = device != "cpu"
    name = "Golden/random"
    golden_pth = os.path.join(GOLDENS, "golden_transfer.pth")
    golden = load_transfer_params(golden_pth, device)
    rng = np.random.default_rng(21)
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(SERVE_REQUESTS)]
    bodies = [cv2.imencode(".png", im)[1].tobytes() for im in images]
    clf_images = [rng.integers(0, 256, (*CLASSIFY_HW, 3), dtype=np.uint8)
                  for _ in range(SERVE_CLASSIFY - 1)]
    clf_images.append(rng.integers(0, 256, (*CLASSIFY_SMALL_HW, 3), dtype=np.uint8))
    clf_bodies = [cv2.imencode(".png", im)[1].tobytes() for im in clf_images]

    # The direct stylize of each image, one at a time: what a served image is held to.
    direct = [stylize(golden, im[None], device=device)[0].cpu().numpy() for im in images]
    direct_ms = {}
    if on_card:
        x = torch.as_tensor(np.stack(images[:SERVE_MAX_BATCH]), device=device)

    cv2t = TimedCv2(cv2)
    real_cv2 = hs._cv2
    hs._cv2 = lambda: cv2t
    servers = []

    def start(registry, **kw):
        srv = timed_server(registry=registry, max_batch=SERVE_MAX_BATCH,
                           max_wait_ms=SERVE_MAX_WAIT_MS, device=device)
        httpd = hs.make_http_server(registry, srv, host="127.0.0.1", port=0,
                                    request_timeout_s=600.0, **kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append((httpd, srv))
        return httpd, srv, f"http://127.0.0.1:{httpd.server_port}"

    def body_files(kind: str, blobs: list[bytes]) -> list[str]:
        paths = [os.path.join(tmp, f"{kind}{i}.png") for i in range(len(blobs))]
        for path, blob in zip(paths, blobs):
            with open(path, "wb") as fh:
                fh.write(blob)
        return paths

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        stylize_req = [(f"/v1/stylize?model={name}&format=png", f)
                       for f in body_files("s", bodies)]
        classify_req = [("/v1/classify", f) for f in body_files("c", clf_bodies)]
        per = SERVE_REQUESTS // SERVE_CLASSIFY
        mixed = [r for i in range(SERVE_CLASSIFY)
                 for r in stylize_req[i * per:(i + 1) * per] + classify_req[i:i + 1]]
        gram_kernel.LAUNCHES = 0  # K1 over every serve path below: none computes a Gram
        # --- f32 stylize: a registry on a .pth file (reloaded below) ---
        reload_pth = os.path.join(tmp, "transfer_17-25_2.pth")
        shutil.copy(golden_pth, reload_pth)
        registry = ModelRegistry(device=device)
        registry.register(name, path=reload_pth)
        httpd, srv, base = start(registry, classifier_params=clf)
        require(http_get(base + "/healthz") == {"status": "ok"}, "serve: /healthz")
        require(http_get(base + "/v1/models") == {"models": [name]}, "serve: /v1/models")
        warm_batches(srv, images, name)
        http_round(base, stylize_req)  # warm-up round
        f32_rounds = []
        for _ in range(SERVE_ROUNDS):
            cv2t.decode.clear()
            cv2t.encode.clear()
            stats0 = http_get(base + "/statsz")
            results, wall = http_round(base, stylize_req)
            stats1 = http_get(base + "/statsz")
            require(all(r[0] == 200 for r in results),
                    f"serve f32: statuses {[r[0] for r in results]}")
            dbs = [psnr(cv2.imdecode(np.frombuffer(r[1], np.uint8), cv2.IMREAD_COLOR), d)
                   for r, d in zip(results, direct)]
            require(min(dbs) > 45.0, f"serve f32: {min(dbs)} dB against a direct stylize")
            report = round_report(results, wall, srv, stats0, stats1, cv2t, size)
            require(report["batches"] < report["images"],
                    f"serve f32: {report['batches']} batches for {report['images']} images: "
                    "no coalescing")
            f32_rounds.append({**report, "min_psnr_db": min(dbs)})
        if on_card:
            with torch.inference_mode():
                direct_ms["stylize"] = time_ms(lambda: golden(x.float()).clamp(0, 255).to(
                    torch.uint8).cpu(), iters=5) / SERVE_MAX_BATCH
        if profile:
            profile_window("serve_f32", lambda: http_round(base, stylize_req), SERVE_REQUESTS,
                           "request")

        # Hot reload: the file rewritten with a second seeded net, then POST .../reload.
        second = init_transformer(torch.Generator().manual_seed(1)).to(device).eval()
        export_pth(reload_pth, second)
        status, body = http_post(base + f"/v1/models/{name}/reload", b"")
        require(status == 200 and json.loads(body) == {"model": name, "reloaded": True},
                f"serve reload: {status} {body[:200]}")
        status, body = http_post(base + stylize_req[0][0], bodies[0])
        got = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        want = stylize(second, images[0][None], device=device)[0].cpu().numpy()
        reload_db, old_db = psnr(got, want), psnr(got, direct[0])
        require(status == 200 and reload_db > 45.0 and old_db < 30.0,
                f"serve reload: {reload_db} dB to the new net, {old_db} dB to the old")

        # --- int8 stylize and classify together ---
        registry_q = ModelRegistry(quantize=True, device=device)
        registry_q.register(name, path=golden_pth)
        qmodel = registry_q.get(name)
        httpd_q, srv_q, base_q = start(registry_q, classifier_params=clf)
        warm_batches(srv_q, images, name)
        require(http_post(base_q + "/v1/classify", clf_bodies[0])[0] == 200,
                "serve: the classify cold start failed")
        clf_srv = httpd_q.RequestHandlerClass.server_ctx["clf_state"]["server"]
        warm_batches(clf_srv, [hs.classify_crop(cv2, im) for im in images])
        http_round(base_q, mixed)  # warm-up round
        clf_batches, real_apply = [], clf_srv._apply

        def recorded(p, xb):
            out = real_apply(p, xb)
            clf_batches.append((xb.cpu().numpy(), out))
            return out

        clf_srv._apply = recorded
        qclf = quantize_classifier(clf)
        int8_rounds = []
        k2_mixed = k1_mixed = s_batches = c_batches = 0
        for _ in range(SERVE_ROUNDS):
            srv_q.batches = []
            clf_batches.clear()
            cv2t.decode.clear()
            cv2t.encode.clear()
            stats0 = http_get(base_q + "/statsz")
            # The counters zeroed just before the round and read just after it; the
            # serial replays of check_int8_round launch K2 too and stay outside.
            sync()
            qconv_kernel.LAUNCHES = 0
            k1_before = gram_kernel.LAUNCHES
            results, wall = http_round(base_q, mixed)
            sync()
            k2_mixed += qconv_kernel.LAUNCHES
            k1_mixed += gram_kernel.LAUNCHES - k1_before
            stats1 = http_get(base_q + "/statsz")
            s_batches += stats1["batches"] - stats0["batches"]
            c_batches += stats1["classify"]["batches"] - stats0["classify"]["batches"]
            require(all(r[0] == 200 for r in results),
                    f"serve int8: statuses {[r[0] for r in results]}")
            int8_rounds.append(check_int8_round(
                results, wall, mixed, images, clf_images, direct, srv_q, clf_batches, qmodel,
                qclf, stats0, stats1, cv2t, size, device))
        want_k2 = QCONV_TRANSFORMER * s_batches + QCONV_RESNET * c_batches
        require(not on_card or (k2_mixed == want_k2 and k1_mixed == 0),
                f"serve int8: {k2_mixed} K2 launches, not 16 x {s_batches} + 52 x {c_batches}; "
                f"{k1_mixed} K1")
        srv_q.batches = None
        clf_srv._apply = real_apply
        if on_card:
            with torch.inference_mode():
                direct_ms["stylize_int8"] = time_ms(lambda: qmodel(x, accum=torch.bfloat16)
                                                    .float().clamp(0, 255).to(torch.uint8)
                                                    .cpu(), iters=5) / SERVE_MAX_BATCH
        # Each path alone, its counter zeroed just before and read just after.
        counts = {}
        for path, reqs, per_batch, key in (("serve_int8_stylize", stylize_req, QCONV_TRANSFORMER,
                                            None),
                                           ("serve_classify", classify_req, QCONV_RESNET,
                                            "classify")):
            s0 = http_get(base_q + "/statsz")
            sync()
            qconv_kernel.LAUNCHES = 0
            rs, _ = http_round(base_q, reqs)
            sync()
            counts[path] = qconv_kernel.LAUNCHES
            s1 = http_get(base_q + "/statsz")
            s0, s1 = (s[key] if key else s for s in (s0, s1))
            nb = s1["batches"] - s0["batches"]
            require(all(r[0] == 200 for r in rs), f"{path}: statuses {[r[0] for r in rs]}")
            require(not on_card or counts[path] == per_batch * nb,
                    f"{path}: {counts[path]} K2 launches, not {per_batch} x {nb} batches")
        if profile:
            profile_window("serve_int8", lambda: http_round(base_q, mixed), len(mixed), "request")
        k1 = gram_kernel.LAUNCHES
        require(k1 == 0, f"serve: {k1} K1 launches on paths with no Gram")

        # --- the CLI in a subprocess: a reference tree with a .pth and an .npz of one epoch ---
        tree = os.path.join(tmp, "models", "Golden", "random")
        os.makedirs(tree)
        export_pth(os.path.join(tree, "transfer_17-25_2.pth"), golden)
        save_params_npz(os.path.join(tree, "transfer_17-25_2.npz"), golden)
        cli = serve_cli(os.path.join(tmp, "models"), clf_cli_pth, device, bodies[0], direct[0],
                        clf_bodies[0])
    finally:
        hs._cv2 = real_cv2
        for httpd, srv in servers:
            httpd.shutdown()
            httpd.server_close()
            srv.close()
            hs.close_classify_server(httpd)
        shutil.rmtree(tmp, ignore_errors=True)
    emit("serve", size=size, requests=SERVE_REQUESTS, clients=SERVE_CLIENTS,
         max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_MAX_WAIT_MS, rounds=SERVE_ROUNDS,
         f32=medians(f32_rounds), int8=medians(int8_rounds), f32_rounds=f32_rounds,
         int8_rounds=int8_rounds, int8_k2_launches=k2_mixed, int8_k1_launches=k1_mixed,
         int8_stylize_batches=s_batches, int8_classify_batches=c_batches,
         reload_psnr_db=reload_db, reload_psnr_vs_old_db=old_db,
         direct_ms_per_image=direct_ms, k2_launches=counts, k1_launches=k1, cli=cli, card=smi)
    return {"k1_launches": {"serve": k1}, "launches": counts}


def serve_cli(models_dir: str, clf_pth: str, device: str, body: bytes, direct: np.ndarray,
              clf_body: bytes) -> dict:
    """``python -m ...infer.http_server`` with ``--quantize``, a classifier and ``--port 0``:
    the .npz chosen, its port read from stdout, one stylize and one classify answered, and
    an exit 0 within 10 s of SIGINT."""
    import queue
    import signal
    import threading

    import cv2

    cmd = [sys.executable, "-m", "artist_style_transfer_tpu_torch.infer.http_server",
           "--models-dir", models_dir, "--quantize", "--classifier-path", clf_pth,
           "--host", "127.0.0.1", "--port", "0"]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=port_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def read() -> None:
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    seen = []
    try:
        while not (seen and seen[-1].startswith("serving")):
            try:
                line = lines.get(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
            except queue.Empty:
                line = None
            require(line is not None, f"serve CLI: no 'serving' line: {''.join(seen)[-1500:]}")
            seen.append(line)
        startup_s = time.perf_counter() - t0
        npz = os.path.join(models_dir, "Golden", "random", "transfer_17-25_2.npz")
        require(f"registered Golden/random <- {npz}\n" in seen,
                f"serve CLI: the .npz was not chosen: {seen}")
        port = int(seen[-1].rsplit(":", 1)[1])
        base = f"http://127.0.0.1:{port}"
        status, out = http_post(base + "/v1/stylize?model=Golden/random&format=png", body)
        got = cv2.imdecode(np.frombuffer(out, np.uint8), cv2.IMREAD_COLOR)
        require(status == 200 and got is not None, f"serve CLI stylize: {status} {out[:200]}")
        db = psnr(got, direct)
        require(db > 45.0, f"serve CLI: int8 stylize {db} dB against the f32 stylize")
        status, out = http_post(base + "/v1/classify", clf_body)
        require(status == 200, f"serve CLI classify: {status} {out[:200]}")
        answer = json.loads(out)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        try:
            code = proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            code = None
        stop_s = time.perf_counter() - t1
        require(code == 0, f"serve CLI: exit {code} {stop_s:.1f} s after SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    return {"startup_s": startup_s, "port": port, "stylize_psnr_vs_f32_db": db,
            "classify": answer, "sigint_exit_s": stop_s, "exit_code": code}


def walled(mesh, fn, args: tuple, kwargs: dict) -> tuple:
    """``fn(mesh, *args, **kwargs)`` in a rank, with the host clock's time at its start
    and end (``time.time()``: one host, so comparable with the launching process's)."""
    start = time.time()
    out = fn(mesh, *args, **kwargs)
    return out, start, time.time()


def run_rank_phases(phases: dict, device: str = "cuda",
                    seconds: dict[str, float] | None = None) -> dict:
    """Run the rank jobs of several phases in one launch of gloo ranks a world size.

    Each phase is a generator that does its work in this process, yields its rank jobs
    by world size (``{2: [(fn, args, kwargs), ...], 4: [...]}``), takes back each rank's
    results of its own jobs, in order (``{2: [rank 0's, rank 1's], 4: [...]}``), checks
    them and returns. A launch pays process start-up, imports and each rank's first CUDA
    work once (10-15 s before an empty job over 2 or 4 ranks on the card's host:
    ``bench_launch.py``), so the jobs of every phase at one world size share it. Returns each phase's value by name, and adds
    to ``seconds`` each phase's own seconds (its work in this process) and each launch's,
    under ``ranks_<n>``. ``device="cpu"`` runs the ranks on the CPU."""
    from artist_style_transfer_tpu_torch.parallel import launch, workers

    on_card = device == "cuda"
    seconds = {} if seconds is None else seconds
    asks = {}
    for name, gen in phases.items():
        t0 = time.perf_counter()
        asks[name] = next(gen)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
    if on_card:  # the ranks share the card: give back what this process's allocator holds
        torch.cuda.empty_cache()
    got: dict[str, dict] = {name: {} for name in phases}
    for n in sorted({n for ask in asks.values() for n in ask}):
        jobs = [(walled, job, {}) for ask in asks.values() for job in ask.get(n, [])]
        t0, start = time.perf_counter(), time.time()
        timed = launch(workers.run_jobs, n, jobs, backend="gloo",
                       device="cuda:0" if on_card else "cpu",
                       threads=None if on_card else max(1, 4 // n), timeout_s=900)
        seconds[f"ranks_{n}"] = time.perf_counter() - t0
        ranks = [[out for out, _, _ in r] for r in timed]
        # Rank 0's job by job: the host seconds of each (set-up, and the profiler's own
        # work after a profiled job, included), the seconds before its first job
        # (start-up, imports, the jobs' arguments) and after its last (results, teardown).
        emit("rank_launch", ranks=n, jobs=len(jobs), seconds=seconds[f"ranks_{n}"],
             before_first_job_s=timed[0][0][1] - start,
             after_last_job_s=start + seconds[f"ranks_{n}"] - timed[0][-1][2],
             rank0_job_wall_s=[round(b - a, 3) for _, a, b in timed[0]],
             rank0_job_secs=[round(r.get("secs", 0.0), 3) if isinstance(r, dict) else None
                             for r in ranks[0]],
             phases={name: len(ask.get(n, [])) for name, ask in asks.items()})
        at = 0
        for name, ask in asks.items():
            k = len(ask.get(n, []))
            got[name][n] = [r[at:at + k] for r in ranks]
            at += k
    out = {}
    for name, gen in phases.items():
        t0 = time.perf_counter()
        try:
            gen.send(got[name])
        except StopIteration as done:
            out[name] = done.value
        else:
            raise RuntimeError(f"chip_smoke: phase {name} asked for a second launch")
        seconds[name] += time.perf_counter() - t0
    return out


def par_trajectory(name: str, got: np.ndarray, want: np.ndarray, rtol: float) -> float:
    """The largest relative difference of two loss arrays, required under ``rtol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    require(got.shape == want.shape and bool(np.isfinite(got).all()),
            f"parallel {name}: {got.shape} vs {want.shape}")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    require(rel <= rtol, f"parallel {name}: losses {rel} apart (bar {rtol})")
    return rel


def stat(runs, key: str) -> float:
    """The sum of a stat over the worker results that have it."""
    return float(sum(r.get(key, 0.0) for r in runs))


def phase_parallel(peaks: dict | None, device: str = "cuda", train_size: int = TRAIN_SIZE,
                   spatial: int = PAR_SPATIAL, eval_size: int = EVAL_SIZE,
                   clf_size: int = ARTIST_CLF_SIZE, clf_n: int = ARTIST_CLF_IMAGES,
                   clf_batch: int = ARTIST_CLF_BATCH,
                   clf_rtol: float = PAR_CLF_RTOL) -> Generator[dict, dict, dict]:
    """Data-parallel training and evaluation and row-sharded stylization at full width:
    part 1 a world of one over NCCL in this process through the normal entry points,
    against their mesh-less runs; part 2 two ranks on cuda:0 over gloo, against part 1's
    single-process runs; then K2 against its plain version at every band shape part 2's
    ranks launched it at. A generator for :func:`run_rank_phases`, which runs part 2's
    jobs in its launch of 2 ranks; returns the kernels line's launches and the band
    shapes' K2 sums. ``device="cpu"`` (with small sizes) rehearses it on the CPU, both
    parts over gloo and without the K2 checks; ``clf_rtol`` is the classifier's loss
    bar (at 32², B=8 on the CPU the world of one reads 5.0e-3: its last stage
    normalizes 8 values a channel)."""
    on_card = device == "cuda"
    import torch.distributed as dist

    from artist_style_transfer_tpu_torch import train_style_transfer
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier
    from artist_style_transfer_tpu_torch.infer.stylize import (
        load_transfer_params,
        stylize,
        stylize_int8,
    )
    from artist_style_transfer_tpu_torch.models import transformer_q as tq
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
    from artist_style_transfer_tpu_torch.ops.cuda import qconv_kernel
    from artist_style_transfer_tpu_torch.ops.qconv import conv_i8, quant_i8
    from artist_style_transfer_tpu_torch.parallel import make_mesh, workers
    from artist_style_transfer_tpu_torch.parallel.launch import free_port
    from artist_style_transfer_tpu_torch.train import train
    from artist_style_transfer_tpu_torch.train.classifier import train_classifier

    content, paintings = train_data(train_size)
    train_kw = dict(style_method="cycle", artist="A", num_epochs=PAR_TRAIN_EPOCHS,
                    batch_size=TRAIN_BATCH, content_images=content, paintings=paintings,
                    vgg=init_vgg16(torch.Generator().manual_seed(0)), model_dir=None,
                    wordy=False)
    steps = PAR_TRAIN_EPOCHS * TRAIN_CONTENT // TRAIN_BATCH
    k1_expect = 4 * -(-TRAIN_PAINTINGS // 8) + 4 * steps if on_card else 0
    model = load_transfer_params(os.path.join(GOLDENS, "golden_transfer.pth"), device="cpu")
    calib = (np.random.default_rng(7).random((2, 128, 128, 3)) * 255).astype(np.float32)
    qmodel = tq.quantize_transformer(model, calib)
    image = np.random.default_rng(9).integers(0, 256, (spatial, spatial, 3), dtype=np.uint8)
    images = [np.ascontiguousarray(im[:eval_size, :eval_size])
              for im in eval_data()[:PAR_EVAL_IMAGES]]
    artist = ARTISTS_19.index(CLF_ARTIST)
    clf, dclf = seeded_classifier("cpu"), decisive_classifier("cpu", artist)
    eval_kw = dict(batch_size=PAR_EVAL_IMAGES, artists=ARTISTS_19,
                   crop_size=min(256, eval_size))
    corpus, labels = artist_corpus(clf_n, clf_size)
    clf_kw = dict(num_classes=ARTIST_CLF_CLASSES, num_epochs=PAR_CLF_EPOCHS,
                  batch_size=clf_batch, wordy=False)

    # Single-process references, on the device, no mesh.
    cuda = lambda m: copy_to(m, device)  # noqa: E731
    _, single_losses = train(device=device, **train_kw)
    single_f32 = stylize(cuda(model), image[None], clip=False, device=device)[0].cpu().numpy()
    single_i8 = stylize_int8(cuda(qmodel), image[None], clip=False,
                             device=device)[0].float().cpu().numpy()
    single_eval = {}
    for name, c, q in (("f32", clf, False), ("int8", dclf, True)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            acc = evaluate_with_classifier(cuda(model), cuda(c), images, artist, quantize=q,
                                           device=device, **eval_kw)
        single_eval[name] = (acc, out.getvalue())
    _, single_clf = train_classifier(corpus, labels, device=device, **clf_kw)
    # DP training with the int8 options: quantize_loss (its int8 Gram on by "auto") and
    # QAT "trunk", every dynamic scale the whole batch's.
    int8_kw = dict(train_kw, quantize_loss=True, qat="trunk")
    qconv_kernel.LAUNCHES = 0
    with workers.recorded_scales() as scales:
        _, single_int8 = train(device=device, **int8_kw)
    single_int8_k2, single_int8_scales = qconv_kernel.LAUNCHES, np.asarray(scales)
    qcuda = cuda(qmodel)
    x0 = tq._in_relu_bf16(tq._reflect_conv_bf16(
        torch.as_tensor(image, device=device)[None].to(torch.bfloat16).permute(0, 3, 1, 2)
        .contiguous(memory_format=torch.channels_last), qcuda.stem_w, qcuda.stem_b),
        qcuda.stem_gamma, qcuda.stem_beta)
    first = qcuda.encoder[0]
    x0_codes = quant_i8(x0, first.sin)
    x0_acc = conv_i8(x0_codes, first.wq, first.stride, first.padding, 1, "reflect")

    # Part 1: a world of one over NCCL, through the entry points.
    t0 = time.perf_counter()
    backend1 = "nccl" if on_card else "gloo"
    dist.init_process_group(backend1, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        mesh = make_mesh(device=device)
        require(mesh.backend == backend1 and mesh.size == 1, f"parallel: mesh {mesh}")
        one = {"train": workers.train_rank(mesh, train_kw, profile=True)}
        one["train_rel"] = par_trajectory("world of one train()", one["train"]["losses"],
                                          single_losses, 1e-4)
        require(one["train"]["launches"]["k1"] == k1_expect,
                f"parallel: world-of-one train() made {one['train']['launches']} launches")
        ws = data_workspace(tmp, size_range=(train_size + 16, train_size + 97),
                            painting_range=(train_size, train_size + 77),
                            n_content=PAR_CLI_CONTENT, artists=(("Seeded Artist", 8),))
        argv = ["--style_method", "cycle", "--artist", ws["artist"], "--num_epochs", "1",
                "--batch_size", str(TRAIN_BATCH), "--content_data_size", str(PAR_CLI_CONTENT),
                "--train_size", str(train_size), "--content_dir", ws["content"],
                "--archive_dir", ws["archive"], "--cache_dir", ws["cache"], "--vgg_path",
                ws["vgg"], "--device", device, "--quiet"]
        _, cli_losses = train_style_transfer.main(argv + ["--model_dir",
                                                          os.path.join(tmp, "one")])
        one["cli"] = workers.train_cli_rank(mesh, argv + ["--model_dir",
                                                          os.path.join(tmp, "dp")])
        one["cli_rel"] = par_trajectory("world of one CLI", one["cli"]["losses"], cli_losses,
                                        1e-4)
        one["clf"] = workers.train_classifier_rank(mesh, corpus, labels, clf_kw, profile=True)
        one["clf_rel"] = par_trajectory("world of one train_classifier",
                                        one["clf"]["history"]["train_loss"],
                                        single_clf["train_loss"], clf_rtol)
        # ROADMAP Queue 3: where the world of one parts from the mesh-less trainer.
        # The mesh-less trainer is itself not reproducible on the card (its backward's
        # cuDNN algorithms and atomics), so the lockstep runs twice: as the trainers run,
        # and with deterministic algorithms, where two mesh-less trainers must agree.
        for deterministic in (False, True):
            lock = classifier_lockstep(mesh, corpus, labels, clf_batch, device, deterministic)
            emit("parallel_lockstep", **lock)
        require(not lock["first_part"]["meshless_again"],
                f"parallel: two deterministic mesh-less trainers part: "
                f"{lock['first_part']['meshless_again']}")
        for name, c, q in (("f32", clf, False), ("int8", dclf, True)):
            r = workers.evaluate_rank(mesh, model, c, images, artist,
                                      dict(eval_kw, quantize=q), profile=True)
            require((r["acc"], r["stdout"]) == single_eval[name],
                    f"parallel: world-of-one eval {name}: {r['acc']} vs {single_eval[name][0]}")
            one[f"eval_{name}"] = r
        for name, net, want in (("spatial_f32", model, single_f32),
                                ("spatial_int8", qmodel, single_i8)):
            r = workers.stylize_rows_rank(mesh, net, image, False, profile=True)
            r["psnr_db"] = psnr(np.clip(r.pop("out"), 0, 255), np.clip(want, 0, 255))
            require(r["psnr_db"] > 45.0, f"parallel: world-of-one {name} {r['psnr_db']} dB")
            one[name] = r
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    part1_s = time.perf_counter() - t0
    runs1 = [v for v in one.values() if isinstance(v, dict)]

    # Part 2: two ranks on cuda:0 over gloo, in the joint launch.
    jobs = [(workers.train_rank, (train_kw,), {"profile": True}),
            (workers.stylize_rows_rank, (model, image, False), {"profile": True}),
            (workers.stylize_rows_rank, (qmodel, image, False),
             {"profile": True, "record_k2": True}),
            (workers.first_int8_conv_rows_rank, (qmodel, x0.float().cpu().numpy()), {}),
            (workers.evaluate_rank, (model, dclf, images, artist, dict(eval_kw, quantize=True)),
             {"profile": True}),
            (workers.train_classifier_rank, (corpus, labels, clf_kw), {"profile": True}),
            (workers.train_rank, (int8_kw,), {"profile": True, "record_scales": True})]
    ranks = (yield {PAR_RANKS: jobs})[PAR_RANKS]
    part2_s = sum(r.get("secs", 0.0) for r in ranks[0])
    train_r, f32_r, i8_r, conv_r, eval_r, clf_r, tq8_r = ranks[0]
    for other in ranks[1:]:
        for i, name in ((0, "DP 'cycle'"), (5, "train_classifier"), (6, "DP int8")):
            require(all(np.array_equal(v, ranks[0][i]["params"][k])
                        for k, v in other[i]["params"].items()),
                    f"parallel: the {name} ranks' params or running statistics differ")
        require(np.array_equal(other[0]["losses"], train_r["losses"])
                and np.array_equal(other[6]["losses"], tq8_r["losses"])
                and np.array_equal(other[6]["scales"], tq8_r["scales"]),
                "parallel: the DP ranks' losses or int8 scales differ")
        require(np.array_equal(other[2]["out"], i8_r["out"]),
                "parallel: the ranks' int8 images differ")
    two = {"train_rel": par_trajectory("2-rank DP 'cycle'", train_r["losses"], single_losses,
                                       1e-4),
           "clf_rel": par_trajectory("2-rank train_classifier", clf_r["history"]["train_loss"],
                                     single_clf["train_loss"], clf_rtol),
           "int8_train_rel": par_trajectory("2-rank DP int8", tq8_r["losses"], single_int8,
                                            1e-4)}
    # The ranks' int8 scales are bit-identical (checked above: each rank's own scales
    # would differ). Against the single process the first quarter of the run (the
    # targets and the first step) is read, not held: a forward scale should equal the
    # single process's and a backward one be twice it (each rank's loss is the mean
    # over its half), but cuDNN rounds a batch of 2 apart from one of 4 in the last bit,
    # an int8 code on a rounding edge flips, and the flip moves the next absmax (the
    # CPU, whose convs round each image alike, reads 0; an H100 80GB HBM3 at 700 W
    # read 4.1e-2 and 4.0e-2 at most, a median of 1.6e-3).
    require(tq8_r["scales"].shape == single_int8_scales.shape,
            f"parallel: DP int8 took {tq8_r['scales'].shape} scales, not "
            f"{single_int8_scales.shape}")
    ratio = (tq8_r["scales"] / single_int8_scales)[: len(single_int8_scales) // 4]
    gap = np.minimum(np.abs(ratio - 1.0), np.abs(ratio / PAR_RANKS - 1.0))
    two["int8_scale_gap"] = {"max": float(gap.max()), "median": float(np.median(gap)),
                             "exact_share": float(np.mean(gap == 0.0))}
    require(tq8_r["launches"]["k2"] == single_int8_k2 and (single_int8_k2 > 0) == on_card,
            f"parallel: DP int8 rank 0 made {tq8_r['launches']['k2']} K2 launches, the "
            f"single process {single_int8_k2}")
    require(train_r["launches"]["k1"] == k1_expect,
            f"parallel: DP rank 0 made {train_r['launches']} launches, not {k1_expect} K1")
    two["f32_psnr_db"] = psnr(np.clip(f32_r["out"], 0, 255), np.clip(single_f32, 0, 255))
    require(two["f32_psnr_db"] > 45.0, f"parallel: stylize_spatial {two['f32_psnr_db']} dB")
    diff = np.abs(i8_r["out"] - single_i8)
    two["int8_max_abs"], two["int8_mean_abs"] = float(diff.max()), float(diff.mean())
    require(two["int8_max_abs"] <= 1.5 and two["int8_mean_abs"] < 0.2,
            f"parallel: stylize_spatial_int8 off by {two['int8_max_abs']} "
            f"(mean {two['int8_mean_abs']})")
    require(i8_r["launches"]["k2"] == (QCONV_TRANSFORMER if on_card else 0),
            f"parallel: a band made {i8_r['launches']['k2']} K2 launches")
    codes_ok = bool(np.array_equal(conv_r["codes"], x0_codes.cpu().numpy()))
    acc_ok = bool(np.array_equal(conv_r["acc"], x0_acc.cpu().numpy()))
    require(codes_ok and acc_ok, f"parallel: first banded int8 conv codes {codes_ok}, "
                                 f"int32 {acc_ok}")
    require((eval_r["acc"], eval_r["stdout"]) == single_eval["int8"],
            f"parallel: sharded int8 eval Acc={eval_r['acc']} vs {single_eval['int8'][0]}")
    require(eval_r["launches"]["k2"] == (QCONV_TRANSFORMER + QCONV_RESNET if on_card else 0)
            and eval_r["launches"]["k1"] == 0,
            f"parallel: sharded int8 eval made {eval_r['launches']} launches")
    require(ranks[1][4]["stdout"] == "", "parallel: rank 1 printed the eval")

    # K2 against its plain version at every band shape either rank launched it at.
    band_calls = []
    for rank in ranks:
        for (xn, wn, *rest), count in rank[2]["k2_calls"]:
            x = torch.from_numpy(xn).cuda().contiguous(memory_format=torch.channels_last)
            w = torch.from_numpy(wn).cuda().contiguous(memory_format=torch.channels_last)
            band_calls += [(x, w, *rest)] * count
    band = (check_qconv_shapes(band_calls, "stylize_spatial_int8_band", peaks) if on_card
            else {"shapes": 0, "launches": 0, "s32_max_abs_err": 0})
    runs2 = [r for r in ranks[0] if "secs" in r]
    emit("parallel", ranks=PAR_RANKS, backends={"part1": backend1, "part2": "gloo"},
         part1_wall_s=part1_s, part2_rank0_jobs_s=part2_s,
         part1_device_ms=stat(runs1, "device_ms"), part2_rank0_device_ms=stat(runs2, "device_ms"),
         part1_nccl_device_ms=stat(runs1, "collective_device_ms"),
         world_of_one={k: (v if not isinstance(v, dict) else
                           {kk: v[kk] for kk in ("secs", "launches", "device_ms",
                                                 "collective_device_ms", "psnr_db")
                            if kk in v})
                       for k, v in one.items()},
         two_ranks={**two, "codes_equal": codes_ok, "int32_equal": acc_ok,
                    "eval_int8_acc": eval_r["acc"],
                    "jobs": {name: {kk: r[kk] for kk in ("secs", "launches", "device_ms")
                                    if kk in r}
                             for name, r in zip(("train_dp", "stylize_spatial",
                                                 "stylize_spatial_int8", "first_conv",
                                                 "eval_int8_dp", "train_classifier_dp",
                                                 "train_dp_int8"),
                                                ranks[0])}},
         k2_band_shapes=band["shapes"], k2_band_launches=band["launches"],
         k2_band_s32_max_abs_err=band["s32_max_abs_err"])
    return {"k1_launches": {"train_dp": train_r["launches"]["k1"],
                            "train_dp_int8": tq8_r["launches"]["k1"]},
            "k2_launches": {"stylize_spatial_int8": i8_r["launches"]["k2"],
                            "eval_int8_dp": eval_r["launches"]["k2"],
                            "train_dp_int8": tq8_r["launches"]["k2"]},
            "band": band}


def step_records(model_dir: str, mode: str = "cycle", artist: str = "A") -> np.ndarray:
    """The per-step [content, style, total] losses of a run's ``metrics.jsonl``."""
    events = read_jsonl(os.path.join(model_dir, artist, mode, "metrics.jsonl"))
    return np.array([[e["content_loss"], e["style_loss"], e["total_loss"]]
                     for e in events if e["event"] == "batch"])


def check_k1_shape(shape: tuple, dtype: str, peaks: dict) -> dict:
    """K1 against its plain version and an f64 product at one input shape, on seeded
    relu-like input, with phase gram's error measures and bars; its warm time, cold
    device time, the plain version's, ``torch.bmm``'s, and the bound."""
    from artist_style_transfer_tpu_torch.ops import gram as gram_ops
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel

    n, h, w, c = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(h * w + c)
    f = torch.rand(shape, generator=gen, device="cuda").to(dt)
    g_kernel = gram_kernel.gram_matrix_cuda(f)
    g_plain = gram_ops.gram_matrix_plain(f.float())
    abs_err = (g_kernel - g_plain).abs().max().item()
    rel_err = abs_err / g_plain.abs().max().item()
    f64 = f.double().reshape(n, h * w, c)
    g64 = torch.bmm(f64.transpose(1, 2), f64) / float(c * h * w)
    kernel_vs_f64 = (g_kernel.double() - g64).abs().max().item() / g64.abs().max().item()
    require(rel_err <= (1e-4 if dt == torch.float32 else 1e-3),
            f"space_train: K1 {shape} {dtype}: rel err {rel_err}")
    require(dt != torch.float32 or kernel_vs_f64 <= 5e-6,
            f"space_train: K1 {shape}: kernel vs f64 {kernel_vs_f64}")
    f3, scale = f.reshape(n, h * w, c), 1.0 / float(c * h * w)
    run = lambda: gram_kernel.gram_matrix_cuda(f)  # noqa: E731
    t_ops, t_bytes = gram_bound(n, h * w, c, dt, peaks)
    return {"max_abs_err": abs_err, "max_rel_err": rel_err, "kernel_vs_f64_rel": kernel_vs_f64,
            "ms": time_ms(run), "device_ms": device_ms(run, "gram_tile_kernel"),
            "plain_ms": time_ms(lambda: gram_ops.gram_matrix_plain(f)),
            "library_ms": time_ms(lambda: torch.bmm(f3.transpose(1, 2), f3) * scale),
            "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops, "bytes_ms": t_bytes}


def phase_space_train(peaks: dict | None, smi: str, device: str = "cuda",
                      size: int = TRAIN_SIZE, mem_size: int = SPACE_MEM_SIZE,
                      wide_epochs: int = SPACE_EPOCHS) -> Generator[dict, dict, dict]:
    """Training over a ('data', 'space') mesh at full width ('cycle', the TransformerNet
    and VGG16 to relu4_3, global B=4, 16 seeded images, 8 paintings), each image's rows
    over the 'space' ranks. In this process: the one-process ``train()`` and a
    one-process step at 1024², B=1 (its peak memory), then a world of one over NCCL with
    mesh (1, 1) (the banded code with no exchange). Then 2 gloo ranks on cuda:0 (NCCL
    refuses two ranks on one card): a (1, 2) epoch in f32 (per-step losses within rtol
    1e-4 of the one process, the ranks' params bit-identical), two bf16 epochs (finite,
    falling), a streamed epoch through ``content_stream=`` (within rtol 1e-3 of the
    resident one) and the 1024² step (each rank's peak memory); and 4 gloo ranks with
    mesh (2, 2): the f32 epoch again. 'classifier' mode and the int8 options over the
    axis are :func:`space_train_more`. A generator for :func:`run_rank_phases`, whose
    launches of 2 and 4 ranks run the rank jobs. K1's launches a rank are counted, and
    the band shapes the ranks launched it at returned (:func:`space_k1_rows` holds K1
    against its plain version at each). ``device="cpu"`` (with small sizes) rehearses
    it on the CPU over gloo, without K1 and K2."""
    import torch.distributed as dist

    from artist_style_transfer_tpu_torch.models.transformer import init_transformer
    from artist_style_transfer_tpu_torch.parallel import make_mesh, workers
    from artist_style_transfer_tpu_torch.parallel.launch import free_port
    from artist_style_transfer_tpu_torch.train import train

    on_card = device == "cuda"
    kw = space_train_kw(size, wide_epochs)
    content, vgg = kw["content_images"], kw["vgg"]
    steps = TRAIN_CONTENT // TRAIN_BATCH
    rng = np.random.default_rng(12)
    mem_setup = dict(model=init_transformer(torch.Generator().manual_seed(0)), vgg=vgg,
                     content=rng.uniform(0, 255, (1, mem_size, mem_size, 3)).astype(np.float32),
                     paintings=rng.uniform(0, 255, (1, mem_size, mem_size, 3)).astype(
                         np.float32),
                     batch_size=1, content_weight=17.0, style_weight=25.0, step=0)
    k1_expect = (4 * -(-TRAIN_PAINTINGS // 8) + 4 * steps * wide_epochs) if on_card else 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_space_")
    run_dir = lambda name: os.path.join(tmp, name)  # noqa: E731
    try:
        # The one-process references, in this process.
        t0 = time.perf_counter()
        train(device=device, model_dir=run_dir("one"), **kw)
        one_s = time.perf_counter() - t0
        one_steps = step_records(run_dir("one"))
        require(one_steps.shape == (steps * wide_epochs, 3),
                f"space_train: one process logged {one_steps.shape}")
        mem_one = workers.space_step_rank(make_mesh(device=device), None, mem_setup)

        # A world of one over NCCL, mesh (1, 1): the banded code, no exchange.
        t0 = time.perf_counter()
        backend = "nccl" if on_card else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        try:
            workers.train_rank(make_mesh(device=device),
                               dict(kw, model_dir=run_dir("solo")), shape=(1, 1))
        finally:
            dist.destroy_process_group()
        solo_s = time.perf_counter() - t0
        solo_rel = par_trajectory(f"space (1, 1) world of one over {backend}",
                                  step_records(run_dir("solo")), one_steps, 1e-4)

        # Two gloo ranks on one card: (1, 2); four: (2, 2).
        stream_kw = {k: v for k, v in kw.items() if k != "content_images"}
        stream_kw.update(content_stream=workers.ArrayStream(content, TRAIN_BATCH, 2),
                         content_data_size=TRAIN_CONTENT, train_size=size,
                         model_dir=run_dir("stream"))
        jobs = [(workers.train_rank, (dict(kw, model_dir=run_dir("s12")),),
                 {"shape": (1, 2), "profile": True, "record_k1": True}),
                (workers.train_rank, (dict(kw, num_epochs=2, compute_dtype="bfloat16",
                                           model_dir=None),),
                 {"shape": (1, 2), "record_k1": True}),
                (workers.train_rank, (stream_kw,), {"shape": (1, 2)}),
                (workers.space_step_rank, ((1, 2), mem_setup), {})]
        jobs4 = [(workers.train_rank, (dict(kw, model_dir=run_dir("s22")),),
                  {"shape": (2, 2), "profile": True, "record_k1": True})]
        ranks = yield {2: jobs, 4: jobs4}
        two, four = ranks[2], ranks[4]
        s12, s22 = step_records(run_dir("s12")), step_records(run_dir("s22"))
        stream_steps = step_records(run_dir("stream"))
        epoch_secs = {name: [e["secs"] for e in read_jsonl(os.path.join(
            run_dir(name), "A", "cycle", "metrics.jsonl")) if e["event"] == "epoch"]
            for name in ("one", "solo", "s12", "s22", "stream")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rels = {"s12_rel": par_trajectory("space (1, 2)", s12, one_steps, 1e-4),
            "s22_rel": par_trajectory("space (2, 2)", s22, one_steps, 1e-4),
            "stream_rel": par_trajectory("space (1, 2) streamed", stream_steps, s12,
                                         SPACE_STREAM_RTOL),
            "mem_step_rel": par_trajectory("space (1, 2) 1024² step", two[0][3]["losses"],
                                           mem_one["losses"], 1e-4)}
    for name, ranks, jobs_at in (("(1, 2)", two, (0, 1, 2)), ("(2, 2)", four, (0,))):
        for other in ranks[1:]:
            for i in jobs_at:
                require(np.array_equal(other[i]["losses"], ranks[0][i]["losses"])
                        and all(np.array_equal(v, ranks[0][i]["params"][k])
                                for k, v in other[i]["params"].items()),
                        f"space_train: the {name} ranks' params or losses differ (job {i})")
    bf16 = two[0][1]["losses"]
    require(bool(np.isfinite(bf16).all()) and bf16[-1, 2] < bf16[0, 2],
            f"space_train: bf16 epochs {bf16[:, 2].tolist()} not finite and falling")
    for name, ranks, i in (("(1, 2)", two, 0), ("(2, 2)", four, 0), ("(1, 2) bf16", two, 1)):
        want = k1_expect if i == 0 else (4 + 4 * steps * 2 if on_card else 0)
        got = [r[i]["launches"]["k1"] for r in ranks]
        require(all(g == want for g in got),
                f"space_train: {name} K1 launches by rank {got}, not {want} each")
    # K1 against its plain version at every band shape the ranks launched it at. The
    # images are square, so a band has fewer rows than columns; the targets' whole
    # paintings (phase train's shapes) have as many.
    shapes: dict[tuple, int] = {}
    for ranks, i in ((two, 0), (two, 1), (four, 0)):
        for r in ranks:
            for shape, dtype, count in r[i].get("k1_shapes", []):
                if shape[1] < shape[2]:
                    shapes[(tuple(shape), dtype)] = shapes.get((tuple(shape), dtype), 0) + count
    require(not on_card or len(shapes) == 12,
            f"space_train: K1 ran at {len(shapes)} band shapes, not 4 taps x 3 runs")
    mem = {"one_process": mem_one.get("peak_mem_gib"),
           "ranks_1x2": [r[3].get("peak_mem_gib") for r in two]}
    timing = {name: {k: r.get(k) for k in ("secs", "device_ms")}
              for name, r in (("s12_rank0", two[0][0]), ("s22_rank0", four[0][0]))}
    emit("space_train", size=size, batch=TRAIN_BATCH, steps=steps * wide_epochs,
         one_process_s=one_s, solo_s=solo_s, epoch_secs=epoch_secs, solo_rel=solo_rel, **rels,
         bf16_epoch_totals=bf16[:, 2].tolist(), k1_launches_rank0={
             "s12": two[0][0]["launches"]["k1"], "s22": four[0][0]["launches"]["k1"],
             "s12_bf16": two[0][1]["launches"]["k1"]},
         k1_band_shapes=len(shapes), peak_mem_gib=mem, mem_size=mem_size, timing=timing,
         card=smi)
    return {"k1_launches": {"train_space": two[0][0]["launches"]["k1"],
                            "train_space_2x2": four[0][0]["launches"]["k1"],
                            "train_space_bf16": two[0][1]["launches"]["k1"]},
            "k1_shapes": shapes}


def space_train_kw(size: int = TRAIN_SIZE, epochs: int = SPACE_EPOCHS) -> dict:
    """``train()``'s arguments for phase space_train's 'cycle' run: global B=4, 16
    seeded images, 8 paintings, the VGG16 from seed 0."""
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    content, paintings = train_data(size)
    return dict(style_method="cycle", artist="A", num_epochs=epochs, batch_size=TRAIN_BATCH,
                content_images=content, paintings=paintings,
                vgg=init_vgg16(torch.Generator().manual_seed(0)), save_every=0, wordy=False,
                log_every_batches=1)


def space_k1_rows(shape_counts: list[dict], peaks: dict | None, smi: str,
                  size: int = TRAIN_SIZE) -> dict:
    """K1 against its plain version at every band shape that phase space_train's runs
    and :func:`space_train_more`'s launched it at (``shape_counts``: each one's
    launches by shape and dtype), each shape once, with the launches of all; and K1's
    row of one (1, 2) f32 step: the sums over rank 0's band of each tap."""
    shapes: dict[tuple, int] = {}
    for counts in shape_counts:
        for k, n in counts.items():
            shapes[k] = shapes.get(k, 0) + n
    k1_rows = {}
    for (shape, dtype), count in sorted(shapes.items()):
        row = check_k1_shape(shape, dtype, peaks)
        emit("space_train_k1", shape=list(shape), dtype=dtype, launches=count, **row,
             bound_by="operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes", card=smi)
        k1_rows[f"{'x'.join(map(str, shape))}_{dtype}"] = dict(row, launches=count)
    band = [f"{TRAIN_BATCH}x{size // (2 * d)}x{size // d}x{c}_float32" for _, d, c in TAPS]
    require(all(b in k1_rows for b in band), f"space_train: K1 missed a (1, 2) band tap: {band}")
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    step_taps = {k: sum(k1_rows[b][k] for b in band) for k in keys}
    emit("space_train_k1_rows", band_shapes=len(shapes), step_taps_1x2=step_taps, card=smi)
    return {"k1_rows": k1_rows, "step_taps": step_taps}


def space_train_more(peaks: dict | None, smi: str, device: str = "cuda",
                     size: int = TRAIN_SIZE,
                     mem_size: int = SPACE_MEM_SIZE) -> Generator[dict, dict, dict]:
    """Phase space_train's runs of 'classifier' mode and the int8 options over the
    'space' axis, at full width (the TransformerNet, the VGG16 to relu4_3, the ResNet-50
    with 19 classes; the phase's 'cycle' run, :func:`space_train_kw`): 2 gloo ranks on
    cuda:0 with mesh (1, 2), one epoch each of (a) 'classifier' f32, (b) 'classifier' bf16, (c) 'cycle'
    ``quantize_loss=True``, (d) 'cycle' ``qat=True, quantize_gram=True`` (the int8 Gram
    on the real VGG16's taps), (e) 'cycle' ``qat="all"``, (f) 'classifier' through
    ``quantize_classifier`` with ``quantize_loss=True`` (on ``SPACE_QCLF_CONTENT``
    images), and (g) one 'classifier' f32 step at 1024², B=1 (each rank's peak memory);
    then 4 gloo ranks with mesh (2, 2), (d) and (f). A generator: it yields its rank jobs
    by world size and takes their results back (:func:`run_rank_phases` runs it beside
    phase space_train). Each run against the one-process ``train()`` in this process:
    f32 per-step losses within rtol 1e-4, the int8 runs' within ``SPACE_INT8_RTOL``,
    bf16 finite; the ranks' params, losses and every dynamic int8 scale bit-identical;
    K1's and K2's launches a rank counted; K2 held against its plain version at every
    shape the ranks launched it at (the band shapes, forward and dgrad); returns K1's
    band shapes for :func:`space_k1_rows`."""
    from artist_style_transfer_tpu_torch.models.resnet import init_classifier
    from artist_style_transfer_tpu_torch.models.resnet_q import quantize_classifier
    from artist_style_transfer_tpu_torch.models.transformer import init_transformer
    from artist_style_transfer_tpu_torch.parallel import make_mesh, workers
    from artist_style_transfer_tpu_torch.train import train

    on_card = device == "cuda"
    kw = space_train_kw(size)
    clf = init_classifier(torch.Generator().manual_seed(3))
    ckw = dict(kw, style_method="classifier", artist=CLF_ARTIST, classifier=clf)
    runs = {"clf": ckw, "clf_bf16": dict(ckw, compute_dtype="bfloat16"),
            "qloss": dict(kw, quantize_loss=True),
            "qat_qgram": dict(kw, qat=True, quantize_gram=True),
            "qat_all": dict(kw, qat="all"),
            "qclf": dict(ckw, classifier=quantize_classifier(clf), quantize_loss=True,
                         content_images=kw["content_images"][:SPACE_QCLF_CONTENT])}
    steps = {name: -(-len(r["content_images"]) // r["batch_size"]) for name, r in runs.items()}
    mode_of = {name: r["style_method"] for name, r in runs.items()}
    artist_of = {name: r["artist"] for name, r in runs.items()}
    rng = np.random.default_rng(13)
    mem_setup = dict(mode="classifier", model=init_transformer(torch.Generator().manual_seed(0)),
                     vgg=kw["vgg"], classifier=clf,
                     content=rng.uniform(0, 255, (1, mem_size, mem_size, 3)).astype(np.float32),
                     batch_size=1, content_weight=17.0, style_weight=25.0, step=0)

    four_names = ("qat_qgram", "qclf")
    runs_at = (("one", runs), ("s12", runs), ("s22", four_names))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_space_more_")
    run_dir = lambda name: os.path.join(tmp, name)  # noqa: E731

    def jobs(names, where, shape):
        return [(workers.train_rank, (dict(runs[n], model_dir=run_dir(f"{where}_{n}")),),
                 {"shape": shape, "record_k1": True, "record_k2": on_card,
                  "record_scales": n not in ("clf", "clf_bf16")}) for n in names]

    try:
        t0 = time.perf_counter()
        for name, r in runs.items():
            train(device=device, model_dir=run_dir(f"one_{name}"), **r)
        one_s = time.perf_counter() - t0
        mem_one = workers.space_step_rank(make_mesh(device=device), None, mem_setup)
        ranks = yield {2: jobs(list(runs), "s12", (1, 2))
                       + [(workers.space_step_rank, ((1, 2), mem_setup), {})],
                       4: jobs(four_names, "s22", (2, 2))}
        records = {(where, name): step_records(run_dir(f"{where}_{name}"), mode_of[name],
                                               artist_of[name])
                   for where, names in runs_at for name in names}
        epoch_secs = {f"{where}_{name}": [e["secs"] for e in read_jsonl(os.path.join(
            run_dir(f"{where}_{name}"), artist_of[name], mode_of[name], "metrics.jsonl"))
            if e["event"] == "epoch"] for where, names in runs_at for name in names}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    two, four = ranks[2], ranks[4]

    rels = {}
    for name in runs:
        rtol = (SPACE_INT8_RTOL if name.startswith("q")
                else 1e-4 if name == "clf" else float("inf"))
        rels[f"s12_{name}"] = par_trajectory(f"space (1, 2) {name}", records["s12", name],
                                             records["one", name], rtol)
    for name in four_names:
        rels[f"s22_{name}"] = par_trajectory(f"space (2, 2) {name}", records["s22", name],
                                             records["one", name], SPACE_INT8_RTOL)
    rels["mem_step"] = par_trajectory("space (1, 2) 'classifier' 1024² step",
                                      two[0][-1]["losses"], mem_one["losses"], 1e-4)
    k1_want = {"qloss": 4 + 2 * steps["qloss"], "qat_qgram": 4 + 2 * steps["qat_qgram"],
               "qat_all": 4 + 4 * steps["qat_all"]}
    k1_launches, k2_launches, k2_calls, k1_shapes = {}, {}, [], {}
    for label, ranks, names in (("s12", two, list(runs)), ("s22", four, four_names)):
        for i, name in enumerate(names):
            for other in ranks[1:]:
                same = (np.array_equal(other[i]["losses"], ranks[0][i]["losses"])
                        and np.array_equal(other[i].get("scales", []),
                                           ranks[0][i].get("scales", []))
                        and all(np.array_equal(v, ranks[0][i]["params"][k])
                                for k, v in other[i]["params"].items()))
                require(same, f"space_train: {label} {name}: the ranks' params, losses or "
                              "int8 scales differ")
            k1 = [r[i]["launches"]["k1"] for r in ranks]
            k2 = [r[i]["launches"]["k2"] for r in ranks]
            want1 = k1_want.get(name, 0) if on_card else 0
            want2 = (SPACE_K2_STEP.get(name, 0) * steps[name]
                     + (QCONV_VGG_DEEP if name == "qloss" else 0)) if on_card else 0
            require(all(n == want1 for n in k1) and all(n == want2 for n in k2),
                    f"space_train: {label} {name}: K1 {k1} (not {want1}) and K2 {k2} (not "
                    f"{want2}) launches by rank")
            k1_launches[f"train_space_{name}" + ("_2x2" if label == "s22" else "")] = k1[0]
            k2_launches[f"train_space_{name}" + ("_2x2" if label == "s22" else "")] = k2[0]
            for r in ranks:
                if name.startswith("q"):
                    require(len(r[i]["scales"]) > 0, f"space_train: {label} {name}: no scale")
                for (xn, wn, *rest), count in r[i].get("k2_calls", []):
                    x = torch.from_numpy(xn).cuda().contiguous(memory_format=torch.channels_last)
                    w = torch.from_numpy(wn).cuda().contiguous(memory_format=torch.channels_last)
                    k2_calls += [(x, w, *rest)] * count
                for shape, dtype, count in r[i].get("k1_shapes", []):
                    if shape[1] < shape[2]:  # a band, not a whole painting
                        key = (tuple(shape), dtype)
                        k1_shapes[key] = k1_shapes.get(key, 0) + count
    bf16 = records["s12", "clf_bf16"]
    require(bool(np.isfinite(bf16).all()), "space_train: 'classifier' bf16 losses not finite")
    k2 = (check_qconv_shapes(k2_calls, "train_space", peaks, cold=False) if on_card
          else {"shapes": 0, "launches": 0, "s32_max_abs_err": 0})
    emit("space_train_more", one_process_s=one_s, steps=steps, **rels, epoch_secs=epoch_secs,
         scales_a_rank={f"s12_{n}": len(two[0][i].get("scales", []))
                        for i, n in enumerate(runs)},
         k1_launches_rank0=k1_launches, k2_launches_rank0=k2_launches,
         k2_shapes=k2["shapes"], k2_launches_checked=k2["launches"],
         k2_s32_max_abs_err=k2["s32_max_abs_err"], k1_band_shapes=len(k1_shapes),
         peak_mem_gib={"one_process": mem_one.get("peak_mem_gib"),
                       "ranks_1x2": [r[-1].get("peak_mem_gib") for r in two]},
         mem_size=mem_size, card=smi)
    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "k2": k2,
            "k1_shapes": k1_shapes}


def phase_space_more(peaks: dict | None, smi: str, device: str = "cuda",
                     eval_size: int = EVAL_SIZE, crop: int = 256,
                     clf_size: int = ARTIST_CLF_SIZE, clf_n: int = ARTIST_CLF_IMAGES,
                     clf_batch: int = ARTIST_CLF_BATCH, clf_rtol: float = PAR_CLF_RTOL,
                     diff_size: int = DIFF_SIZE, diff_base: int = DIFF_BASE, diff_T: int = DIFF_T,
                     diff_n: int = SPACE_MORE_DIFF_IMAGES, mem: dict | None = None,
                     grad_rtol: float = SPACE_MORE_GRAD_RTOL,
                     stats_rtol: float = SPACE_MORE_STATS_RTOL) -> Generator[dict, dict, dict]:
    """Evaluation, artist-classifier training and diffusion training over a ('data',
    'space') mesh at full width, each image's rows over the 'space' ranks, on gloo ranks
    on cuda:0 (NCCL refuses two ranks on one card). In this process first: the one-process
    runs. Then 2 ranks with mesh (1, 2) and 4 with mesh (2, 2), in the launches of
    :func:`run_rank_phases` (this phase is a generator for it):

    - (a) ``evaluate_with_classifier`` of one batch of the eval phase's 1024² images, B=4,
      crop 256, f32 (the seeded classifier) and ``quantize=True`` (the decisive one), over
      (1, 2) and (2, 2): ``Acc=`` and ``Pred=`` equal to the one process's, the f32 logits
      within 1e-3 of its largest with its argmax, 0 K1 launches, 68 K2 launches a rank in
      int8 (16 TransformerNet and 52 ResNet-50 convs), and K2 held against its plain
      version at every band shape the ranks launched it at;
    - (b) ``train_classifier`` at 256², B=32, on 160 seeded paintings, one epoch with
      ``freeze_body=True`` and one unfrozen, over (1, 2): the frozen epoch's loss within
      ``clf_rtol`` of the one process (the DP bar), the unfrozen one's printed beside
      the one process's own distance from a second run of it (read, not held: see
      PERF.md §6), the ranks' params and running
      statistics bit-identical, the frozen convs bit-unchanged, 0 K1 and 0 K2; and one
      unfrozen step at 512², B=8: its loss within 1e-4 of the one process's, its synced
      gradients and BN statistics bit-identical on the ranks, the statistics within
      ``stats_rtol`` of each leaf's largest of the one process's, the gradients' distance
      printed, and each rank's peak memory beside the one process's; the same step in
      f64, its gradients and statistics within ``SPACE_MORE_F64_RTOL`` of each leaf's
      (gradients: its module's) largest of the one process's;
    - (c) ``train_diffusion`` at the diffusion CLI's defaults (64², base 64, B=32, T=1000,
      19 classes) on 128 seeded images, one epoch, over (1, 2) and (2, 2), from a UNet
      with redrawn weights (:func:`redrawn_diff_model`: the init's near-zero output convs
      make the loss about mean(noise²) whatever the UNet computes): the epoch loss within
      1e-4 of the one process, the ranks bit-identical, 0 K1 and 0 K2; and one step at
      256², B=8, from redrawn weights too: its loss within 1e-4, its synced gradients
      bit-identical on the ranks and each leaf within ``grad_rtol`` of its module's
      largest of the one process's, and each rank's peak memory beside the one process's.
      Each step is run twice in the one process, and the distance of the two printed
      beside the bands'.

    Every run's ms a step is printed. Returns the kernels line's launches and K2's
    band-shape sums. ``device="cpu"`` (with small sizes, and bars ``clf_rtol``,
    ``grad_rtol`` and ``stats_rtol`` for them) rehearses it over gloo on the CPU, without
    the K2 checks."""
    from artist_style_transfer_tpu_torch.diffusion.train import train_diffusion
    from artist_style_transfer_tpu_torch.infer.evaluate import eval_logits, evaluate_with_classifier
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, init_classifier
    from artist_style_transfer_tpu_torch.parallel import workers
    from artist_style_transfer_tpu_torch.train.classifier import train_classifier

    on_card = device == "cuda"
    mem = dict(SPACE_MORE_MEM, **(mem or {}))
    artist = ARTISTS_19.index(CLF_ARTIST)
    model = load_transfer_params(os.path.join(GOLDENS, "golden_transfer.pth"), device="cpu")
    clf, dclf = seeded_classifier("cpu"), decisive_classifier("cpu", artist)
    images = [np.ascontiguousarray(im[:eval_size, :eval_size])
              for im in eval_data()[:SPACE_MORE_EVAL]]
    eval_kw = dict(batch_size=SPACE_MORE_EVAL, artists=ARTISTS_19, crop_size=crop)
    corpus, labels = artist_corpus(clf_n, clf_size)
    clf_kw = {f: dict(num_classes=ARTIST_CLF_CLASSES, num_epochs=SPACE_MORE_CLF_EPOCHS,
                      batch_size=clf_batch, freeze_body=f, wordy=False) for f in (True, False)}
    clf_steps = int(round(clf_n * 0.8)) // clf_batch * SPACE_MORE_CLF_EPOCHS
    dimgs, dlabels = synthetic_paintings(diff_n, 3, diff_size, DIFF_CLASSES)
    diff_kw = dict(num_classes=DIFF_CLASSES, num_timesteps=diff_T, num_epochs=1,
                   batch_size=DIFF_BATCH, base_channels=diff_base, wordy=False,
                   params=redrawn_diff_model(DIFF_CLASSES, diff_base, 5))
    diff_steps = diff_n // DIFF_BATCH
    rng = np.random.default_rng(14)
    b = SPACE_MORE_MEM_BATCH
    clf_mem = dict(model=init_classifier(torch.Generator().manual_seed(2),
                                         num_classes=ARTIST_CLF_CLASSES),
                   x=rng.standard_normal((b, mem["classifier"], mem["classifier"], 3)).astype(
                       np.float32), y=np.arange(b) % ARTIST_CLF_CLASSES, freeze_body=False,
                   device=device)
    hd = mem["diffusion"]
    diff_mem = dict(model=redrawn_diff_model(DIFF_CLASSES, diff_base, 6),
                    x0=rng.uniform(-1, 1, (b, hd, hd, 3)).astype(np.float32),
                    y=np.arange(b) % DIFF_CLASSES, t=rng.integers(0, diff_T, b),
                    noise=rng.standard_normal((b, hd, hd, 3)).astype(np.float32),
                    num_timesteps=diff_T, device=device)

    # The one process, in this process, no mesh.
    t0 = time.perf_counter()
    one_eval = {}
    for name, c, q in (("f32", clf, False), ("int8", dclf, True)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            acc, _, k = counted(lambda: evaluate_with_classifier(
                copy_to(model, device), copy_to(c, device), images, artist, quantize=q,
                device=device, **eval_kw))
        one_eval[name] = (acc, out.getvalue(), k)
    with torch.inference_mode():
        one_logits = eval_logits(copy_to(model, device), copy_to(clf, device),
                                 torch.as_tensor(np.stack(images)).to(device), crop).cpu().numpy()
    one_clf = {f: counted(lambda: train_classifier(corpus, labels, device=device, **kw))
               for f, kw in clf_kw.items()}
    # The unfrozen body's epoch is read beside the one process's own run-to-run distance
    # (cuDNN's backward algorithms): Adam moves every gradient entry by about the lr
    # whatever its size, so a rounding that flips a near-zero entry's sign moves the
    # trajectory, in the one process as in the bands (PERF.md §6).
    (_, again), _, _ = counted(lambda: train_classifier(corpus, labels, device=device,
                                                        **clf_kw[False]))
    unfrozen_noise = par_trajectory("one process's unfrozen epoch run again",
                                    again["train_loss"], one_clf[False][0][1]["train_loss"],
                                    float("inf"))
    one_clf_mem = workers.classifier_step_rank(None, None, clf_mem)
    clf_f64 = dict(clf_mem, x=clf_mem["x"].astype(np.float64))
    one_clf_f64 = workers.classifier_step_rank(None, None, clf_f64)
    one_diff = counted(lambda: train_diffusion(dimgs, dlabels, device=device, **diff_kw))
    one_diff_mem = workers.diffusion_step_rank(None, None, dict(diff_mem))
    # Each step run again: the one process's own run-to-run distance of its gradients,
    # printed beside the bands' (cuDNN's backward algorithms need not be deterministic).
    again = {"clf": workers.classifier_step_rank(None, None, clf_mem),
             "diffusion": workers.diffusion_step_rank(None, None, dict(diff_mem))}
    one_s = time.perf_counter() - t0

    def eval_jobs(shape):
        return [(workers.evaluate_rank, (model, c, images, artist, dict(eval_kw, quantize=q)),
                 {"shape": shape, "record_k2": q and on_card})
                for c, q in ((clf, False), (dclf, True))] + [
            (workers.eval_logits_rank, (shape, model, clf, np.stack(images), crop), {})]

    diff_job = lambda shape: (workers.diffusion_rank, (dimgs, dlabels, diff_kw),  # noqa: E731
                              {"shape": shape})
    ranks = yield {2: eval_jobs((1, 2)) + [
        (workers.train_classifier_rank, (corpus, labels, clf_kw[f]),
         {"shape": (1, 2)}) for f in (True, False)] + [
        (workers.classifier_step_rank, ((1, 2), clf_mem), {}), diff_job((1, 2)),
        (workers.diffusion_step_rank, ((1, 2), diff_mem), {}),
        (workers.classifier_step_rank, ((1, 2), clf_f64), {})],
        4: eval_jobs((2, 2)) + [diff_job((2, 2))]}
    two, four = ranks[2], ranks[4]

    # (a) evaluation
    report: dict = {"one_process_s": one_s, "clf_unfrozen_one_process_noise": unfrozen_noise}
    k2_calls, k2_launches, k1_launches = [], {}, {}
    for label, ranks, shape in (("1x2", two, (1, 2)), ("2x2", four, (2, 2))):
        for j, name in enumerate(("f32", "int8")):
            acc, stdout, _ = one_eval[name]
            require((ranks[0][j]["acc"], ranks[0][j]["stdout"]) == (acc, stdout),
                    f"space_more: eval {name} {label} Acc={ranks[0][j]['acc']} vs {acc}")
            require(all(r[j]["acc"] == acc and r[j]["stdout"] == "" for r in ranks[1:]),
                    f"space_more: eval {name} {label}: another rank printed or differs")
            want_k2 = QCONV_TRANSFORMER + QCONV_RESNET if on_card and name == "int8" else 0
            got = [r[j]["launches"] for r in ranks]
            require(all(g == {"k1": 0, "k2": want_k2} for g in got),
                    f"space_more: eval {name} {label} launches by rank {got}, not 0 K1 and "
                    f"{want_k2} K2")
            k1_launches[f"eval_{name}_space_{label}"] = got[0]["k1"]
            if name == "int8":
                k2_launches[f"eval_int8_space_{label}"] = got[0]["k2"]
                for r in ranks:
                    for (xn, wn, *rest), count in r[j].get("k2_calls", []):
                        x = torch.from_numpy(xn).cuda().contiguous(
                            memory_format=torch.channels_last)
                        w = torch.from_numpy(wn).cuda().contiguous(
                            memory_format=torch.channels_last)
                        k2_calls += [(x, w, *rest)] * count
            emit("space_more_run", run=f"eval_{name}_{label}", images=SPACE_MORE_EVAL,
                 size=eval_size, ms_per_batch=ranks[0][j]["secs"] * 1e3, card=smi)
        logits = np.concatenate([ranks[i * shape[1]][2]["logits"] for i in range(shape[0])])
        rel = float(np.abs(logits - one_logits).max() / np.abs(one_logits).max())
        require(rel <= 1e-3 and np.array_equal(logits.argmax(-1), one_logits.argmax(-1)),
                f"space_more: eval f32 {label} logits {rel} of the largest apart, argmax "
                f"{logits.argmax(-1).tolist()} vs {one_logits.argmax(-1).tolist()}")
        report[f"eval_f32_{label}_logits_rel"] = rel
    t0 = time.perf_counter()
    k2 = (check_qconv_shapes(k2_calls, "eval_int8_space", peaks, cold=False) if on_card
          else {"shapes": 0, "launches": 0, "s32_max_abs_err": 0})
    report["k2_check_s"] = time.perf_counter() - t0

    # (b) artist-classifier training over (1, 2)
    start = init_classifier(torch.Generator().manual_seed(2), num_classes=ARTIST_CLF_CLASSES)
    for j, f in ((3, True), (4, False)):
        name = "frozen" if f else "unfrozen"
        runs = [r[j] for r in two]
        (_, hist), secs, k = one_clf[f]
        report[f"clf_{name}_rel"] = par_trajectory(
            f"space (1, 2) train_classifier {name}", runs[0]["history"]["train_loss"],
            hist["train_loss"], clf_rtol if f else float("inf"))
        require(all(np.array_equal(v, runs[0]["params"][key]) for r in runs[1:]
                    for key, v in r["params"].items()),
                f"space_more: train_classifier {name}: the ranks' params differ")
        frozen = [key for key in ("0.0.weight", "0.5.0.conv2.weight")
                  if np.array_equal(runs[0]["params"][key], start.state_dict()[key].numpy())]
        require(len(frozen) == (2 if f else 0),
                f"space_more: train_classifier {name}: convs unchanged {frozen}")
        got = [r["launches"] for r in runs] + [k]
        require(all(g == {"k1": 0, "k2": 0} for g in got),
                f"space_more: train_classifier {name} launches {got}")
        k1_launches[f"train_classifier_space_{name}"] = got[0]["k1"]
        emit("space_more_run", run=f"train_classifier_{name}_1x2", steps=clf_steps,
             ms_per_step=runs[0]["secs"] * 1e3 / clf_steps,
             one_process_ms_per_step=secs * 1e3 / clf_steps, card=smi)
    # The unfrozen step before any update: the loss within 1e-4 of the one process's, the
    # BN statistics and, in f64, the gradients leaf by leaf.
    report["clf_step_rel"] = par_trajectory("space (1, 2) 512² unfrozen classifier step",
                                            two[0][5]["metrics"][:, 0],
                                            one_clf_mem["metrics"][:, 0], 1e-4)
    flat_stats = lambda r: {f"{k}.{i}": s[i] for k, s in r["stats"].items()  # noqa: E731
                            for i in range(2)}
    for key, get, rtol in (("grads", lambda r: r["grads"], float("inf")),
                           ("stats", flat_stats, stats_rtol)):
        report[f"clf_step_{key}_one_process_noise"] = held_leaves(
            f"the one process's 512² classifier step {key} run again",
            [get(again["clf"])], get(one_clf_mem), float("inf"), key == "grads")
        report[f"clf_step_{key}"] = held_leaves(
            f"space (1, 2) 512² classifier step {key}", [get(r[5]) for r in two],
            get(one_clf_mem), rtol, key == "grads")
        report[f"clf_step_f64_{key}"] = held_leaves(
            f"space (1, 2) 512² f64 classifier step {key}", [get(r[8]) for r in two],
            get(one_clf_f64), SPACE_MORE_F64_RTOL, key == "grads")

    # (c) diffusion training over (1, 2) and (2, 2)
    (_, _, one_losses), one_diff_s, k = one_diff
    require(k == {"k1": 0, "k2": 0}, f"space_more: one-process train_diffusion launches {k}")
    for label, ranks, j in (("1x2", two, 6), ("2x2", four, 3)):
        runs = [r[j] for r in ranks]
        report[f"diffusion_{label}_rel"] = par_trajectory(
            f"space {label} train_diffusion", runs[0]["losses"], one_losses,
            SPACE_MORE_DIFF_RTOL)
        require(all(np.array_equal(r["losses"], runs[0]["losses"])
                    and all(np.array_equal(v, runs[0]["params"][key])
                            for key, v in r["params"].items()) for r in runs[1:]),
                f"space_more: train_diffusion {label}: the ranks differ")
        got = [r["launches"] for r in runs]
        require(all(g == {"k1": 0, "k2": 0} for g in got),
                f"space_more: train_diffusion {label} launches {got}")
        k1_launches[f"diffusion_train_space_{label}"] = got[0]["k1"]
        emit("space_more_run", run=f"train_diffusion_{label}", steps=diff_steps,
             ms_per_step=runs[0]["secs"] * 1e3 / diff_steps,
             one_process_ms_per_step=one_diff_s * 1e3 / diff_steps, card=smi)
    report["diffusion_step_rel"] = par_trajectory(
        "space (1, 2) 256² diffusion step", [two[0][7]["loss"]], [one_diff_mem["loss"]], 1e-4)
    report["diffusion_step_grads_one_process_noise"] = held_leaves(
        "the one process's 256² UNet step gradients run again", [again["diffusion"]["grads"]],
        one_diff_mem["grads"], float("inf"), True)
    report["diffusion_step_grads"] = held_leaves(
        "space (1, 2) 256² UNet step gradients", [r[7]["grads"] for r in two],
        one_diff_mem["grads"], grad_rtol, True)
    peak = {"classifier_512": {"one_process": one_clf_mem.get("peak_mem_gib"),
                               "ranks_1x2": [r[5].get("peak_mem_gib") for r in two]},
            "diffusion_256": {"one_process": one_diff_mem.get("peak_mem_gib"),
                              "ranks_1x2": [r[7].get("peak_mem_gib") for r in two]}}
    emit("space_more", **report, peak_mem_gib=peak, mem_batch=SPACE_MORE_MEM_BATCH,
         k1_launches_rank0=k1_launches, k2_launches_rank0=k2_launches,
         k2_shapes=k2["shapes"], k2_launches_checked=k2["launches"],
         k2_s32_max_abs_err=k2["s32_max_abs_err"],
         k2_sums={k: k2.get(k) for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                                         "cudnn_bf16_ms", "library_ms", "library_k2_ms",
                                         "library_launches", "bf16_mismatches",
                                         "dequant_max_rel_err")}, card=smi)
    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "k2": k2}


def held_leaves(name: str, ranks: list[dict], want: dict, rtol: float,
                by_module: bool = False) -> dict:
    """Holds the ranks' arrays (one dict of leaves a rank) bit-identical to one another and
    rank 0's within ``rtol`` of each leaf's largest entry of ``want``, or with
    ``by_module`` of the largest entry of its module's leaves (a parameter name's prefix:
    a bias that feeds a GroupNorm of one channel a group has a gradient of rounding
    alone); returns the largest share, its leaf, and the largest relative L2 distance of
    a leaf."""
    got = ranks[0]
    require(got.keys() == want.keys(), f"space_more {name}: leaves {sorted(got)[:4]}... vs "
                                       f"{sorted(want)[:4]}...")
    require(all(np.array_equal(r[k], got[k]) for r in ranks[1:] for k in got),
            f"space_more {name}: the ranks differ")
    module = (lambda k: k.rsplit(".", 1)[0]) if by_module else (lambda k: k)  # noqa: E731
    largest: dict = {}
    for k, w in want.items():
        largest[module(k)] = max(largest.get(module(k), 1e-30), float(np.abs(w).max()))
    worst, leaf, l2 = 0.0, None, 0.0
    for k, w in want.items():
        w64, g64 = np.asarray(w, np.float64), np.asarray(got[k], np.float64)
        rel = float(np.abs(g64 - w64).max()) / largest[module(k)]
        if rel >= worst:
            worst, leaf = rel, k
        l2 = max(l2, float(np.linalg.norm(g64 - w64) / max(np.linalg.norm(w64), 1e-30)))
    require(worst <= rtol, f"space_more {name}: leaf {leaf} {worst} of its largest apart "
                           f"(bar {rtol})")
    return {"max_rel": worst, "leaf": leaf, "max_l2_rel": l2}


def classifier_lockstep(mesh, images: np.ndarray, labels: np.ndarray, batch: int,
                        device: str, deterministic: bool = False,
                        num_classes: int = ARTIST_CLF_CLASSES, seed: int = 2,
                        lr: float = 1e-3, weight_decay: float = 1e-2) -> dict:
    """The world of one's ``train_classifier`` and the mesh-less one stepped in lockstep
    (ROADMAP Queue 3): ``train_classifier``'s first epoch written out (its split, init,
    optimizer, permutation and updates) for three trainers from one state on the same
    batches: the mesh-less one, one over ``mesh`` (global-batch BN through
    ``_GlobalBatchNormFunction``, the gradients through ``sync_gradients``), and a second
    mesh-less one, the control for nondeterminism. Each step compares with the mesh-less
    trainer, in order, every BN's output, the gradients (after the all-reduce), the
    running statistics and the parameters after the step, and records the first step and
    layer where each parts. At the first step both are also held against the same step
    in f64 (the mesh-less trainer's model and batch in float64): each layer's BN output
    and each gradient, relative to its largest magnitude. ``deterministic`` runs it all
    with cuDNN's deterministic algorithms and ``torch.use_deterministic_algorithms``
    (warn only), and returns the ops that warned: those with no deterministic form."""
    import warnings

    flags = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if deterministic:
                torch.backends.cudnn.deterministic = True
                torch.use_deterministic_algorithms(True, warn_only=True)
            out = _lockstep(mesh, images, labels, batch, device, num_classes, seed, lr,
                            weight_decay)
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])
    out["deterministic"] = deterministic
    out["nondeterministic_ops"] = sorted({str(w.message).split(" does not have")[0][:160]
                                          for w in caught if "determinis" in str(w.message)})
    return out


def _lockstep(mesh, images, labels, batch, device, num_classes, seed, lr, weight_decay):
    import copy

    import torch.nn.functional as F

    from artist_style_transfer_tpu_torch.models import resnet as resnet_mod
    from artist_style_transfer_tpu_torch.models.resnet import (
        classifier_apply_train,
        init_classifier,
        update_running_stats,
    )
    from artist_style_transfer_tpu_torch.train.classifier import (
        _split_train_val,
        make_classifier_optimizer,
    )
    from artist_style_transfer_tpu_torch.train.loop import epoch_permutation, sync_gradients

    train_idx, _ = _split_train_val(len(images), 0.2, seed)
    corpus = torch.as_tensor(np.asarray(images, np.float32)[train_idx]).to(device)
    ys = torch.as_tensor(np.asarray(labels)[train_idx], dtype=torch.int64).to(device)
    steps = len(train_idx) // batch
    start = init_classifier(torch.Generator().manual_seed(seed), device, num_classes)
    trainers = {}
    for name, m, dtype in (("meshless", None, torch.float32), ("world_of_one", mesh, torch.float32),
                           ("meshless_again", None, torch.float32), ("f64", None, torch.float64)):
        model = copy.deepcopy(start).to(dtype)
        opt, sched = make_classifier_optimizer(model, lr, steps, weight_decay, True)
        trainers[name] = (model, opt, sched, m)
    perm = epoch_permutation(seed, 0, len(train_idx)).to(device)
    real_bn = resnet_mod.batch_norm_train

    def step(model, opt, sched, m, xb, yb) -> dict:
        outs = []

        def recording(h, *args, **kw):
            out = real_bn(h, *args, **kw)
            outs.append(out[0].detach())
            return out

        resnet_mod.batch_norm_train = recording
        try:
            logits, stats = classifier_apply_train(model, xb.to(next(model.parameters()).dtype),
                                                   mesh=m)
        finally:
            resnet_mod.batch_norm_train = real_bn
        loss = F.cross_entropy(logits, yb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        metrics = loss.detach()[None]
        if m is not None:
            metrics = sync_gradients([p for _, p in named], metrics, m, sharded=True)
        opt.step()
        sched.step()
        update_running_stats(model, stats, 0.1)
        buffers = dict(model.named_buffers())
        return {"loss": float(metrics[0]), "bn_output": list(zip(stats, outs)),
                "gradient": [(n, p.grad.detach().clone()) for n, p in named],
                "running_stat": [(f"{k}.{s}", buffers[f"{k}.{s}"].clone()) for k in stats
                                 for s in ("running_mean", "running_var")],
                "parameter": [(n, p.detach().clone()) for n, p in model.named_parameters()]}

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))

    kinds = ("bn_output", "gradient", "running_stat", "parameter")
    first = {name: {} for name in ("world_of_one", "meshless_again")}
    worst = {name: dict.fromkeys(kinds, 0.0) for name in first}
    losses = {name: [] for name in ("meshless", "world_of_one", "meshless_again")}
    vs_f64 = {}
    for s in range(steps):
        idx = perm[s * batch: (s + 1) * batch]
        xb, yb = corpus[idx], ys[idx]
        recs = {name: step(*t, xb, yb) for name, t in trainers.items()
                if name != "f64" or s == 0}
        ref = recs["meshless"]
        for name in losses:
            losses[name].append(recs[name]["loss"])
        if s == 0:  # both f32 trainers against the f64 step, layer by layer
            for name in ("meshless", "world_of_one"):
                vs_f64[name] = {}
                for kind in ("bn_output", "gradient"):
                    errs = [rel(a, b) for (_, a), (_, b) in zip(recs[name][kind],
                                                                recs["f64"][kind])]
                    vs_f64[name][kind] = {"max": max(errs), "median": float(np.median(errs))}
            del trainers["f64"]
        for name in first:
            for kind in kinds:
                diffs = [(k, rel(a, b)) for (k, a), (_, b) in zip(recs[name][kind], ref[kind])]
                worst[name][kind] = max(worst[name][kind], max(d for _, d in diffs))
                parted = [(k, d) for k, d in diffs if d > 0.0]
                if parted and kind not in first[name]:
                    first[name][kind] = {"step": s, "layer": parted[0][0], "rel": parted[0][1],
                                         "layers_parted": len(parted), "layers": len(diffs)}
        del recs, ref
    loss_rel = {name: float(np.max(np.abs(np.asarray(losses[name]) - losses["meshless"])
                                   / np.abs(losses["meshless"])))
                for name in first}
    return {"steps": steps, "batch": batch, "first_part": first, "worst_rel": worst,
            "step0_vs_f64": vs_f64, "step_losses": losses, "step_loss_rel": loss_rel}


def phase_kernel_rows(peaks: dict, smi: str) -> dict:
    """The kernel-table rows of paths whose kernel times were not taken apart: K1 at the
    DP 'cycle' taps (224x224, N=2 a rank, f32), and K2 at the shapes of the serve batches
    (``stylize_int8`` at 512x512 and the int8 classify at 256x256, B = 1, 2 and 8; B = 4 is
    phase int8's), the sharded int8 eval (N = 2 a rank) and DP int8 training (one step at
    N = 2 a rank, ``quantize_loss`` + QAT trunk): each recorded from a call of the path's
    own function at that batch, K2 held against its plain version at every shape."""
    from artist_style_transfer_tpu_torch.infer.evaluate import eval_logits, quantize_eval_pipeline
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize_int8
    from artist_style_transfer_tpu_torch.models.resnet_q import (
        classifier_apply_int8,
        quantize_classifier,
    )
    from artist_style_transfer_tpu_torch.models.transformer_q import quantize_transformer
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16, quantize_vgg16_loss
    from artist_style_transfer_tpu_torch.ops import gram as gram_ops
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel
    from artist_style_transfer_tpu_torch.ops.image import torchvision_normalize

    # K1 at the DP 'cycle' rank's taps: 224x224, N=2, f32.
    gen = torch.Generator(device="cuda").manual_seed(3)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    k1 = dict.fromkeys(keys, 0.0)
    n = TRAIN_BATCH // PAR_RANKS
    for tap, down, c in TAPS:
        side = TRAIN_SIZE // down
        f = torch.rand((n, side, side, c), generator=gen, device="cuda")
        err = rel_to_max(gram_kernel.gram_matrix_cuda(f), gram_ops.gram_matrix_plain(f))
        require(err <= 1e-4, f"kernel_rows: K1 {tap} N={n}: rel err {err}")
        f3, scale = f.reshape(n, side * side, c), 1.0 / float(c * side * side)
        run = lambda: gram_kernel.gram_matrix_cuda(f)  # noqa: E731
        t_ops, t_bytes = gram_bound(n, side * side, c, torch.float32, peaks)
        vals = (time_ms(run), device_ms(run, "gram_tile_kernel"),
                time_ms(lambda: gram_ops.gram_matrix_plain(f)),
                time_ms(lambda: torch.bmm(f3.transpose(1, 2), f3) * scale),
                max(t_ops, t_bytes), t_ops, t_bytes)
        for k, v in zip(keys, vals):
            k1[k] += v
    emit("kernel_rows_k1", path="train_dp", size=TRAIN_SIZE, n=n, dtype="float32",
         taps=len(TAPS), **k1, bound_by="operations" if k1["ops_ms"] >= k1["bytes_ms"]
         else "bytes", card=smi)

    # K2 at the serve, sharded-eval and DP int8 shapes, without the profiler's cold time.
    model = load_transfer_params(os.path.join(GOLDENS, "golden_transfer.pth"), device="cuda")
    calib = (np.random.default_rng(7).random((2, 128, 128, 3)) * 255).astype(np.float32)
    qmodel = quantize_transformer(model, calib)
    clf = seeded_classifier("cuda")
    qclf = quantize_classifier(clf)
    rng = np.random.default_rng(11)
    rows = {}
    for b in SERVE_ROW_BATCHES:
        images = rng.integers(0, 256, (b, INT8_SIZE, INT8_SIZE, 3), dtype=np.uint8)
        crops = torch.as_tensor(rng.random((b, CLF_SIZE, CLF_SIZE, 3)), dtype=torch.float32,
                                device="cuda")
        rows[f"serve_stylize_b{b}"] = check_qconv_shapes(
            record_qconv_calls(lambda: stylize_int8(qmodel, images, device="cuda")),
            f"serve_stylize_b{b}", peaks, cold=False)
        rows[f"serve_classify_b{b}"] = check_qconv_shapes(
            record_qconv_calls(lambda: classifier_apply_int8(qclf, torchvision_normalize(crops))),
            f"serve_classify_b{b}", peaks, cold=False)
    pair = np.stack(eval_data()[:PAR_RANKS])
    qm_eval, qc_eval = quantize_eval_pipeline(model, clf, pair)
    rows["eval_int8_dp"] = check_qconv_shapes(
        record_qconv_calls(lambda: eval_logits(qm_eval, qc_eval, torch.as_tensor(
            pair, device="cuda"))), "eval_int8_dp", peaks, cold=False)
    vgg = init_vgg16(torch.Generator().manual_seed(0), device="cuda")
    content, paintings = train_data()
    fns, data, r22 = train_step_fns(quantize_vgg16_loss(vgg, "deep", torch.float32), content,
                                    paintings, "auto", "cuda", qat="trunk")
    rows["train_dp_int8"] = check_qconv_shapes(
        record_qconv_calls(lambda: fns.step_fn(data[:n], r22[:n], 0)), "train_dp_int8", peaks,
        cold=False)
    for name, r in rows.items():
        emit("kernel_rows_k2", path=name, **r, card=smi)
    return {"k1_train_dp": k1, "k2": rows}


def cfid_curve_orderings(curve: dict[str, float]) -> list[str]:
    """The orderings of ``tests/test_diffusion.py``'s CFID-curve test that do not fail on
    ``curve`` ({sampler config: CFID}), read at the committed artifact's 3-decimal
    rounding; the empty list when all hold."""
    c = {k: round(float(v), 3) for k, v in curve.items()}
    checks = {
        "ddpm-1000 best": c["ddpm-1000"] == min(c.values()),
        "dpmpp-12 <= 1.05 ddim-50": c["dpmpp-12"] <= c["ddim-50"] * 1.05 + 1e-9,
        "dpmpp-4 <= 1.05 ddim-50": c["dpmpp-4"] <= c["ddim-50"] * 1.05 + 1e-9,
        "ddim-50 <= ddim-5 <= ddim-3 <= ddim-2": (c["ddim-50"] <= c["ddim-5"] <= c["ddim-3"]
                                                 <= c["ddim-2"]),
        "ddim-2 >= 1.05 ddim-50": c["ddim-2"] >= c["ddim-50"] * 1.05,
        "dpmpp-12 <= dpmpp-2": c["dpmpp-12"] <= c["dpmpp-2"],
    }
    return [name for name, ok in checks.items() if not ok]


def synthetic_paintings(n: int, seed: int, size: int = CURVE_SIZE,
                        classes: int = CURVE_CLASSES) -> tuple[np.ndarray, np.ndarray]:
    """(NHWC BGR [0,255] images, labels): the class-structured synthetic distribution of
    ``tools/diffusion_quality_curve.py`` ``make_synthetic``, copied: class-oriented
    gratings of random frequency and phase under a class-coloured Gaussian blob (blue
    for even classes, red for odd), plus pixel noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    imgs = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        c = labels[i]
        axis = yy if c % 2 == 0 else xx
        grating = np.sin(2 * np.pi * rng.uniform(5.0, 9.0) * axis + rng.uniform(0.0, 2 * np.pi))
        img = np.stack([110 + 70 * grating] * 3, axis=-1)
        cy, cx = rng.uniform(0.25, 0.75, size=2)
        sig = rng.uniform(0.10, 0.18)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig * sig)))
        img[..., 0 if c % 2 == 0 else 2] += 120 * blob
        img += rng.normal(0.0, 4.0, img.shape)
        imgs[i] = np.clip(img, 0, 255)
    return imgs, labels.astype(np.int64)


def redrawn_diff_model(num_classes: int, base: int, seed: int):
    """A ``DiffModel`` with every weight redrawn at U(+-1/sqrt(fan_in)), biases and betas at
    U(+-0.1), gammas at U(0.8, 1.2) and the class embedding at N(0, 0.5^2): the init's
    near-zero ``conv2``, ``attn.proj`` and ``conv_out`` would make every residual branch
    and the output about 0, and a card-vs-CPU check on it nearly empty."""
    from artist_style_transfer_tpu_torch.diffusion.unet import DiffModel

    model = DiffModel(num_classes, base)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            u = torch.rand(p.shape, generator=g)
            if name.endswith("weight"):
                p.copy_((u * 2 - 1) / p[0].numel() ** 0.5)
            elif name == "class_emb":
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
            elif name.endswith("gamma"):
                p.copy_(0.8 + 0.4 * u)
            else:
                p.copy_((u * 2 - 1) * 0.1)
    return model


def sampler_evals(name: str, steps: int, T: int) -> int:
    """Model evaluations of a sampler run (DPM++ takes one fewer than its timesteps)."""
    from artist_style_transfer_tpu_torch.diffusion.sample import timestep_subsequence

    if name == "ddpm":
        return T
    n = len(timestep_subsequence(T, steps))
    return n if name == "ddim" else n - 1


def counted(fn):
    """``fn()`` with the K1 and K2 counters zeroed just before it and read just after:
    (result, seconds ending in a sync, {"k1": n, "k2": n})."""
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel, qconv_kernel

    sync()
    gram_kernel.LAUNCHES = qconv_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    sync()
    secs = time.perf_counter() - t0
    return out, secs, {"k1": gram_kernel.LAUNCHES, "k2": qconv_kernel.LAUNCHES}


def phase_diffusion(peaks: dict | None, smi: str, device: str = "cuda", size: int = DIFF_SIZE,
                    base: int = DIFF_BASE, T: int = DIFF_T, n_train: int = DIFF_TRAIN_IMAGES,
                    curve_epochs: int = CURVE_EPOCHS, curve_T: int = DIFF_T,
                    cli_samples: int = DIFF_CLI_SAMPLES) -> dict:
    """Class-conditional diffusion at the CLI's defaults (64x64, base 64, 19 classes,
    T = 1000, B = 32): the UNet and guided DDIM-20 on the card against the port's CPU,
    ``train_diffusion`` (2 epochs on 128 seeded images: finite, falling, warm ms/step,
    the step's FLOPs and bound, peak memory), ms per model evaluation of each sampler
    at B = 16 with and without guidance, and the CLI's train, sample and eval on a seeded
    workspace (at T = 250); then the CFID quality curve at the config of
    ``tests/goldens/diffusion_cfid_curve.json`` (32x32, 2 classes, 256 real and 128
    generated images, 80 epochs, base 32, cosine schedule) with its orderings held.
    K1 and K2 are on none of these paths: each path's counters are zeroed just before
    it and must read 0 just after. ``device="cpu"`` with small sizes rehearses it (the
    card-vs-CPU checks then compare the CPU with itself, and the curve's orderings are
    printed, not held)."""
    from artist_style_transfer_tpu_torch.diffusion import (
        GaussianDiffusion,
        cfid,
        diff_model_apply,
        diff_sample,
        diff_sample_ddim,
        diff_sample_dpmpp,
        train_diffusion,
    )
    from artist_style_transfer_tpu_torch.diffusion import cli as diff_cli
    from artist_style_transfer_tpu_torch.diffusion.train import diffusion_step
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, init_classifier
    from torch.utils.flop_counter import FlopCounterMode

    on_card = device == "cuda"
    launches: dict[str, dict] = {}
    samplers = {"ddpm": diff_sample, "ddim": diff_sample_ddim, "dpmpp": diff_sample_dpmpp}

    # The UNet and guided DDIM-20 on the device against the port's CPU, from one state.
    cpu_model = redrawn_diff_model(DIFF_CLASSES, base, 3)
    model = copy_to(cpu_model, device)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((DIFF_CPU_IMAGES, size, size, 3), generator=g)
    t, y = torch.tensor([3, T - 129]), torch.tensor([4, 17])
    with torch.no_grad():
        want = diff_model_apply(cpu_model, x, t, y)
        got = diff_model_apply(model, x.to(device), t.to(device), y.to(device)).cpu()
    apply_rel = rel_to_max(got, want)
    require(apply_rel <= 1e-4, f"diffusion: diff_model_apply {apply_rel} of max from the CPU")
    emit("diffusion_apply", size=size, base=base, classes=DIFF_CLASSES, n=DIFF_CPU_IMAGES,
         params=sum(p.numel() for p in model.parameters()), rel_to_max=apply_rel,
         max_abs_out=float(want.abs().max()), card=smi)
    d_cpu, d_dev = GaussianDiffusion.make(T), GaussianDiffusion.make(T, device=device)
    clf_cpu = seeded_classifier("cpu")
    clf = copy_to(clf_cpu, device)
    kw = dict(shape=(size, size), steps=DIFF_CPU_DDIM_STEPS, guidance_scale=2.0,
              classifier_y=[ARTISTS_19.index(CLF_ARTIST)] * 2)
    x_T = torch.randn((DIFF_CPU_IMAGES, size, size, 3), generator=g)
    t0 = time.perf_counter()
    ref = diff_sample_ddim(cpu_model, d_cpu, None, y, classifier=clf_cpu, x_T=x_T,
                           device="cpu", **kw).numpy()
    cpu_s = time.perf_counter() - t0
    out, secs, launches["diffusion_ddim_guided"] = counted(lambda: diff_sample_ddim(
        model, d_dev, None, y, classifier=clf, x_T=x_T, device=device, **kw))
    db = psnr(out.cpu().numpy(), ref)
    require(db > 45.0, f"diffusion: guided DDIM-{DIFF_CPU_DDIM_STEPS} {db} dB from the CPU")
    emit("diffusion_ddim_guided", steps=DIFF_CPU_DDIM_STEPS, n=DIFF_CPU_IMAGES, size=size,
         guidance_scale=2.0, psnr_db=db, secs=secs, cpu_secs=cpu_s,
         saturated_share=float(np.mean((ref == 0.0) | (ref == 255.0))), card=smi)
    del cpu_model, clf_cpu

    # train_diffusion: 2 epochs on seeded images, then warm steps, FLOPs and the bound.
    images, labels = synthetic_paintings(n_train, 1, size, DIFF_CLASSES)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    (trained, _, losses), train_s, launches["diffusion_train"] = counted(lambda: train_diffusion(
        images, labels, num_classes=DIFF_CLASSES, num_timesteps=T, num_epochs=DIFF_EPOCHS,
        batch_size=DIFF_BATCH, base_channels=base, wordy=False, device=device))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"diffusion: train_diffusion losses {losses.tolist()}")
    step_model = copy_to(trained, device)
    opt = torch.optim.Adam(step_model.parameters(), lr=1e-4)
    xb = torch.as_tensor(images[:DIFF_BATCH], device=device) / 127.5 - 1.0
    yb = torch.as_tensor(labels[:DIFF_BATCH], device=device)
    tb = torch.randint(0, T, (DIFF_BATCH,), generator=torch.Generator().manual_seed(2)).to(device)
    nb = torch.randn(xb.shape, generator=torch.Generator().manual_seed(3)).to(device)
    run_step = lambda: diffusion_step(step_model, opt, d_dev, xb, yb, tb, nb)  # noqa: E731
    for _ in range(3):
        run_step()
    _, warm_s, _ = counted(lambda: [run_step() for _ in range(DIFF_WARM_STEPS)])
    with FlopCounterMode(display=False) as counter:
        run_step()
    flops = counter.get_total_flops()
    bound_ms = min(flops / peaks["fp32"], 3 * flops / peaks["tf32"]) * 1e3 if peaks else None
    ms_step = warm_s * 1e3 / DIFF_WARM_STEPS
    emit("diffusion_train", size=size, base=base, classes=DIFF_CLASSES, T=T, batch=DIFF_BATCH,
         images=n_train, epochs=DIFF_EPOCHS, epoch_losses=losses.tolist(), train_secs=train_s,
         warm_ms_per_step=ms_step, images_per_sec=DIFF_BATCH * 1e3 / ms_step,
         step_gflop=flops / 1e9, step_bound_ms=bound_ms,
         bound_share=None if bound_ms is None else bound_ms / ms_step, peak_mem_gib=peak_gib,
         k1_launches=launches["diffusion_train"]["k1"],
         k2_launches=launches["diffusion_train"]["k2"], card=smi)
    del step_model, opt

    # ms per model evaluation of each sampler at B = 16, unguided and guided. DDPM runs
    # over a 50-step schedule: its work a model evaluation does not depend on T.
    ys = [i % DIFF_CLASSES for i in range(DIFF_SAMPLE_BATCH)]
    d_ddpm = GaussianDiffusion.make(min(T, 50), device=device)
    # A sampler's warm-up: 2 model evaluations of the timed run's shapes, with its guidance.
    d_warm = GaussianDiffusion.make(2, device=device)
    per_eval, sampled = {}, {"k1": 0, "k2": 0}
    for name, steps in (("ddpm", None), ("ddim", DIFF_DDIM_STEPS), ("dpmpp", DIFF_DPMPP_STEPS)):
        for guided in (False, True):
            skw = dict(shape=(size, size), device=device)
            if steps is not None:
                skw["steps"] = steps
            if guided:
                skw.update(classifier=clf, guidance_scale=1.0, classifier_y=ys)
            dd = d_ddpm if name == "ddpm" else d_dev
            def fn(name=name, dd=dd, skw=skw):
                return samplers[name](trained, dd, torch.Generator().manual_seed(0), ys, **skw)

            warm = skw if steps is None else dict(skw, steps=2)
            samplers[name](trained, d_warm if steps is None else dd,
                           torch.Generator().manual_seed(0), ys, **warm)
            out, secs, n = counted(fn)
            require(bool(torch.isfinite(out).all()), f"diffusion: {name} samples not finite")
            evals = sampler_evals(name, steps or 0, dd.num_timesteps)
            per_eval[f"{name}{'_guided' if guided else ''}"] = {
                "evals": evals, "secs": secs, "ms_per_eval": secs * 1e3 / evals}
            sampled = {k: sampled[k] + n[k] for k in sampled}
    launches["diffusion_sample"] = sampled
    emit("diffusion_samplers", batch=DIFF_SAMPLE_BATCH, size=size, ddim_steps=DIFF_DDIM_STEPS,
         dpmpp_steps=DIFF_DPMPP_STEPS, ddpm_T=d_ddpm.num_timesteps, guidance_scale=1.0,
         per_eval=per_eval, card=smi)
    del trained

    # The CLI: train, sample (DDIM guided, DPM++) and eval on a seeded workspace.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_diffusion_")
    try:
        ws = data_workspace(tmp, painting_range=(size, 2 * size), n_content=1,
                            artists=DIFF_CLI_ARTISTS)
        clf_path = os.path.join(ws["models"], "best-2.pth")
        torch.save({"model": seeded_classifier("cpu").state_dict()}, clf_path)
        npz = os.path.join(ws["models"], "diffusion", "diff_model.npz")
        common = ["--image_size", str(size), "--num_timesteps", str(min(T, DIFF_CLI_T)),
                  "--base_channels", str(base), "--device", device]
        artist = DIFF_CLI_ARTISTS[0][0].replace(" ", "_")
        n_paint = sum(k for _, k in DIFF_CLI_ARTISTS)

        def cli_runs():
            out = {"train": diff_cli.main(
                ["train", "--num_epochs", str(DIFF_EPOCHS), "--batch_size", str(DIFF_CLI_BATCH),
                 "--archive_dir", ws["archive"], "--cache_dir", ws["cache"], "--out", npz,
                 *common])}
            for flags, name in ((["--ddim_steps", str(DIFF_DDIM_STEPS), "--guidance_scale",
                                  "1.0"], "ddim_guided"),
                                (["--dpmpp_steps", str(DIFF_DPMPP_STEPS)], "dpmpp")):
                out[name] = diff_cli.main(
                    ["sample", "--model", npz, "--artist", artist, "--num_samples", "4",
                     "--classifier_path", clf_path, "--out",
                     os.path.join(tmp, "figs", f"{name}.png"), *flags, *common])
            out["eval"] = diff_cli.main(
                ["eval", "--model", npz, "--artist", artist, "--num_samples", str(cli_samples),
                 "--classifier_path", clf_path, "--archive_dir", ws["archive"], "--cache_dir",
                 ws["cache"], *common])
            return out

        with contextlib.redirect_stdout(io.StringIO()) as printed:
            cli, cli_s, launches["diffusion_cli"] = counted(cli_runs)
        import cv2

        with open(npz + ".labels.json") as fh:
            names = json.load(fh)["names"]
        require(names == [a.replace(" ", "_") for a, _ in DIFF_CLI_ARTISTS],
                f"diffusion CLI: label space {names}")
        grids = {k: cv2.imread(cli[k]) for k in ("ddim_guided", "dpmpp")}
        shapes = [None if v is None else v.shape for v in grids.values()]
        require(shapes == [(size, 4 * size, 3)] * len(grids), f"diffusion CLI: grids {shapes}")
        require(bool(np.isfinite(cli["eval"])) and cli["eval"] >= 0.0,
                f"diffusion CLI: CFID {cli['eval']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("diffusion_cli", paintings=n_paint, epochs=DIFF_EPOCHS, batch=DIFF_CLI_BATCH,
         eval_samples=cli_samples, cfid=cli["eval"], secs=cli_s,
         stdout=printed.getvalue().strip().splitlines(), card=smi)

    # The CFID quality curve, at the committed JAX artifact's config, on the port.
    real, real_labels = synthetic_paintings(CURVE_REAL, 0)
    held_out, _ = synthetic_paintings(CURVE_REAL, 100)
    feats = copy_to(init_classifier(torch.Generator().manual_seed(7)), device)  # fixed, random
    (cmodel, cdiff, closses), curve_train_s, launches["diffusion_curve_train"] = counted(
        lambda: train_diffusion(real, real_labels, num_classes=CURVE_CLASSES,
                                num_timesteps=curve_T, num_epochs=curve_epochs,
                                batch_size=CURVE_BATCH, lr=CURVE_LR, seed=0,
                                base_channels=CURVE_BASE, schedule="cosine", wordy=False,
                                device=device))
    floor = cfid(feats, real, held_out, device=device)
    cy = [i % CURVE_CLASSES for i in range(CURVE_GEN)]
    curve, curve_launches = {}, {"k1": 0, "k2": 0}
    for cfg in CURVE_CONFIGS:
        name, steps = cfg.split("-")
        skw = {} if name == "ddpm" else {"steps": int(steps)}
        out, secs, n = counted(lambda: samplers[name](
            cmodel, cdiff, torch.Generator().manual_seed(42), cy,
            shape=(CURVE_SIZE, CURVE_SIZE), device=device, **skw))
        curve[cfg] = {"cfid": cfid(feats, real, out.cpu().numpy(), device=device),
                      "sample_secs": secs}
        curve_launches = {k: curve_launches[k] + n[k] for k in curve_launches}
    launches["diffusion_curve_sample"] = curve_launches
    failed = cfid_curve_orderings({k: v["cfid"] for k, v in curve.items()})
    emit("diffusion_curve", size=CURVE_SIZE, classes=CURVE_CLASSES, n_real=CURVE_REAL,
         n_gen=CURVE_GEN, epochs=curve_epochs, base=CURVE_BASE, schedule="cosine",
         T=cdiff.num_timesteps, train_secs=curve_train_s, epoch_losses=[closses[0], closses[-1]],
         real_vs_real_floor=floor, curve=curve, orderings_failed=failed, card=smi)
    require(not failed or not on_card, f"diffusion: CFID curve orderings fail: {failed}")
    for path, n in launches.items():
        require(n == {"k1": 0, "k2": 0}, f"diffusion: {path} made {n} K1/K2 launches")
    emit("diffusion", launches=launches)
    return {"k1_launches": {k: v["k1"] for k, v in launches.items()},
            "k2_launches": {k: v["k2"] for k, v in launches.items()}}


def copy_to(module: torch.nn.Module, device: str) -> torch.nn.Module:
    """A copy of ``module`` on ``device`` (the original stays where it is)."""
    import copy

    return copy.deepcopy(module).to(device)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def copy_timeline(prof, wall_ms: float) -> dict:
    """The host-to-device copies of a traced window against the kernels: the pinned
    batch copies' time each, their streams, and how much of it ran while a kernel of
    another stream ran; the device's busy share as the union of every interval."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.time_range.elapsed_us() > 0]
    span = lambda e: (e.time_range.start, e.time_range.end)  # noqa: E731
    stream = lambda e: getattr(e, "device_resource_id", None)  # noqa: E731
    copies = [e for e in evs if "Memcpy HtoD" in e.name and "Pinned" in e.name]
    kernels = [e for e in evs if "Memcpy" not in e.name and "Memset" not in e.name]
    copy_streams = {stream(e) for e in copies}
    busy = merged([span(e) for e in kernels if stream(e) not in copy_streams])
    overlap_us = 0.0
    for e in copies:
        a, b = span(e)
        overlap_us += sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    copy_us = sum(e.time_range.elapsed_us() for e in copies)
    union_us = sum(b - a for a, b in merged([span(e) for e in evs]))
    names: dict[str, int] = {}
    for e in evs:
        if "Memcpy" in e.name:
            names[e.name] = names.get(e.name, 0) + 1
    return {"pinned_copies": len(copies), "memcpy_names": names,
            "copy_ms_per_batch": copy_us / 1e3 / max(1, len(copies)),
            "copy_streams": sorted(str(s) for s in copy_streams),
            "kernel_streams": sorted({str(stream(e)) for e in kernels}),
            "copy_overlap_share": overlap_us / copy_us if copy_us else None,
            "device_busy_union_ms": union_us / 1e3,
            "device_idle_share_union": 1 - union_us / 1e3 / wall_ms}


class TimedStream:
    """A content stream whose batches are timed as the loop takes them: ``waits`` holds
    the host seconds each ``next()`` of the last epoch took (decode not yet done)."""

    def __init__(self, stream):
        self.stream, self.waits = stream, []

    def __call__(self, epoch: int):
        self.waits = []
        it = iter(self.stream(epoch))
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.waits.append(time.perf_counter() - t0)
            if batch is None:
                return
            yield batch


# Kernel-name fragments of the int8 training windows' groups: K2, K1, cuBLASLt's int8
# GEMM (the int8 Gram), the quantize passes (round, clip; the scale and the cast to int8
# are kernels shared with other ops and are not counted), the absmax (abs, max reduce).
INT8_GROUPS = {"k2": ("qconv_kernel",), "k1": ("gram_tile_kernel",),
               "int_mm": ("gemm_s8",),
               "quantize": ("round_kernel", "clamp"),
               "absmax": ("AbsFunctor", "MaxNanFunctor")}


def profile_window(path: str, run, units: int, unit: str, timeline: bool = False,
                   decode_wait: TimedStream | None = None, groups: dict | None = None) -> None:
    """Device time by kernel over one warm call of ``run`` (``--profile`` only).

    Only device-side kernel events count: the host-side ``aten::`` rows carry
    their kernels' time too, and so does the device-side range of a user
    annotation (``Optimizer.step#Adam.step``); summing them would count it twice.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    require(total_us > 0, f"profile of {path}: no device time recorded")
    extra = {"copies": copy_timeline(prof, wall_ms)} if timeline else {}
    if decode_wait is not None:
        extra["decode_wait_ms"] = [w * 1e3 for w in decode_wait.waits]
    if groups:  # each group's share of the device time, by kernel-name fragment
        hits = {g: [r for r in rows if any(f in r[1] for f in frags)] for g, frags in groups.items()}
        extra["shares"] = {g: sum(r[0] for r in rs) / total_us for g, rs in hits.items()}
        extra["share_kernels"] = {g: sorted({r[1][:100] for r in rs}) for g, rs in hits.items()}
    # Host calls that wait on the device, pin memory or launch kernels.
    host = {ev.key: {"calls": ev.count, "ms": ev.cpu_time_total / 1e3}
            for ev in prof.key_averages() if ev.device_type == DeviceType.CPU
            and ev.key in HOST_CALLS}
    emit("profile", path=path, units=units, unit=unit, wall_ms=wall_ms, host_calls=host, **extra,
         device_busy_ms=total_us / 1e3, device_idle_share=1 - total_us / 1e3 / wall_ms,
         kernels_launched=sum(r[2] for r in rows),
         # cuDNN's weight-gradient and data-gradient kernels, and its layout copies
         calls_by_kind={kind: sum(r[2] for r in rows if kind in r[1])
                        for kind in ("wgrad", "dgrad", "nhwcToNchw", "nchwToNhwc")},
         top=[{"kernel": k[:120], "ms": us / 1e3, "calls": cnt, "share": us / total_us}
              for us, k, cnt in rows[:60 if groups else 20]])


def phase_profile() -> None:
    """Where the device time goes: 10 Gatys steps, one stylize batch of 4 at 512², one
    'cycle' training epoch of 4 steps at 224², B=4, one eval batch of 4 at 1024², one
    'classifier' training epoch of 4 steps at 224², B=4, 8 streamed 'cycle' steps at
    224², B=4 (JPEGs decoded ahead, pinned copies on the copy stream), an int8 stylize
    batch of 4 at 512² and an int8 eval batch of 4 at 1024² (the quantized pair made
    beforehand, as ``evaluate_with_classifier(quantize=True)`` makes it once a call)."""
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize_batched
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
    from artist_style_transfer_tpu_torch.train.gatys import gatys_stylize

    vgg = init_vgg16(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(1)
    content = rng.uniform(0, 255, (GATYS_SIZE, GATYS_SIZE, 3)).astype(np.float32)
    steps = 10
    profile_window("gatys", lambda: gatys_stylize(vgg, content, content, num_steps=steps,
                                                  device="cuda"), steps, "step")
    model = load_transfer_params(os.path.join(GOLDENS, "golden_transfer.pth"), device="cuda")
    batch = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(4)]
    profile_window("stylize", lambda: stylize_batched(model, batch, batch_size=4, device="cuda"),
                   4, "image")
    content, paintings = train_data()
    fns, data, r22 = train_step_fns(vgg, content, paintings, "auto", "cuda")
    perm = torch.arange(len(data))
    profile_window("train", lambda: fns.epoch_fn(data, r22, perm, 0), fns.steps_per_epoch,
                   "step")
    clf = seeded_classifier("cuda")
    images = eval_data()[:CLF_BATCH]
    profile_window("eval", lambda: evaluate_with_classifier(
        model, clf, images, 0, batch_size=CLF_BATCH, wordy=False, device="cuda"), CLF_BATCH,
        "image")
    fns, data, r22 = train_step_fns(vgg, content, None, "auto", "cuda", classifier=clf)
    profile_window("train_classifier", lambda: fns.epoch_fn(data, r22, perm, 0),
                   fns.steps_per_epoch, "step")
    profile_stream(vgg)
    profile_int8(model, clf, batch, images)
    profile_int8_train(vgg, clf)


def profile_int8_train(vgg, clf) -> None:
    """One bf16 epoch of 4 steps at 224², B=4 of each int8 training run: the int8 loss
    extractor ("deep", with the int8 Gram), QAT "trunk" with it, and 'classifier' through
    the quantized classifier; and the bf16 'cycle' epoch without them."""
    from artist_style_transfer_tpu_torch.models.resnet_q import quantize_classifier
    from artist_style_transfer_tpu_torch.models.vgg import quantize_vgg16_loss

    content, paintings = train_data()
    qvgg = quantize_vgg16_loss(vgg, "deep", dtype=torch.bfloat16)
    perm = torch.arange(len(content))
    for path, net, kw in (("train_bf16", vgg, {}), ("int8_train_quantize_loss", qvgg, {}),
                          ("int8_train_qat_trunk", qvgg, {"qat": "trunk"}),
                          ("int8_train_classifier", vgg,
                           {"classifier": quantize_classifier(clf)})):
        fns, data, r22 = train_step_fns(net, content, None if "classifier" in kw else paintings,
                                        "auto", "cuda", compute_dtype="bfloat16", **kw)
        profile_window(path, lambda: fns.epoch_fn(data, r22, perm, 0), fns.steps_per_epoch,
                       "step", groups=INT8_GROUPS)


def profile_int8(model, clf, batch: list[np.ndarray], images: list[np.ndarray]) -> None:
    from artist_style_transfer_tpu_torch.infer.evaluate import eval_logits, quantize_eval_pipeline
    from artist_style_transfer_tpu_torch.infer.stylize import stylize_int8

    qmodel, qclf = quantize_eval_pipeline(model, clf, np.stack(images[:2]))
    stacked = np.stack(batch)
    profile_window("stylize_int8", lambda: stylize_int8(qmodel, stacked, device="cuda"),
                   len(batch), "image")
    x = torch.as_tensor(np.stack(images), device="cuda")
    profile_window("eval_int8", lambda: eval_logits(qmodel, qclf, x).argmax(-1).cpu(),
                   len(images), "image")


def profile_stream(vgg) -> None:
    """DATA_PROFILE_STEPS streamed 'cycle' steps through ``train()``'s streamed epoch."""
    from artist_style_transfer_tpu_torch.data import content_file_stream
    from artist_style_transfer_tpu_torch.train.api import _run_stream_epoch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_stream_")
    try:
        ws = data_workspace(tmp)
        os.remove(ws["bad"])
        content, paintings = train_data()
        fns, _, _ = train_step_fns(vgg, content[:TRAIN_BATCH], paintings, "auto", "cuda")
        stream = content_file_stream(ws["content"], TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE,
                                     content_data_size=DATA_PROFILE_STEPS * TRAIN_BATCH, seed=2)
        timed = TimedStream(stream)
        profile_window("train_stream", lambda: _run_stream_epoch(
            fns, timed, 0, 0, torch.device("cuda")), DATA_PROFILE_STEPS, "step", timeline=True,
            decode_wait=timed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ok_line() -> str:
    """The last line: the run passed, on this card."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


PHASES = ("gram", "stylize", "gatys", "train", "classifier", "eval", "train_classifier", "data",
          "display", "int8", "int8_train", "train_artist_classifier", "serve", "parallel",
          "space_train", "space_more", "kernel_rows", "diffusion", "in_q8")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--profile", action="store_true",
                        help="also profile Gatys steps, a stylize batch, train steps of both "
                             "modes, an eval batch and streamed train steps by kernel")
    parser.add_argument("--phases", nargs="+", choices=PHASES, metavar="PHASE",
                        help="run only these phases after header and build (serve adds "
                             "train_artist_classifier, whose classifier it serves), print the "
                             "timing line but no kernels line, and end with a line that names "
                             "the probe instead of the ok line; default: every phase")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import artist_style_transfer_tpu_torch  # noqa: F401  (fails outside a checkout)

    chosen = set(args.phases or PHASES)
    if "serve" in chosen:
        chosen.add("train_artist_classifier")
    if "space_train" in chosen:  # its 'classifier' and int8 runs, and K1 at their bands
        chosen |= {"space_train_more", "space_train_k1"}
    seconds: dict[str, float] = {}
    start = time.perf_counter()

    def run(name: str, fn, *a, **kw):
        """Run one phase when it was chosen, on the host clock; None when it was not."""
        if name not in chosen and name not in ("header", "build", "profile"):
            return None
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            seconds[name] = time.perf_counter() - t0

    smi = run("header", phase_header)
    variant, peaks = peaks_for(smi)
    run("build", phase_build)
    gram = run("gram", phase_gram, peaks)
    run("stylize", phase_stylize)
    launches = {"gatys": run("gatys", phase_gatys)}
    launches["train"], launches["train_bf16"] = run("train", phase_train, peaks) or (None, None)
    run("classifier", phase_classifier, peaks)
    launches["eval"] = run("eval", phase_eval)
    launches["train_classifier"] = run("train_classifier", phase_train_classifier, peaks)
    torch.cuda.reset_peak_memory_stats()
    launches["train_cli"], launches["train_stream"] = run("data", phase_data) or (None, None)
    run("display", phase_display)
    int8 = run("int8", phase_int8, peaks, smi) or {"k1_launches": {}}
    launches.update(int8["k1_launches"])
    int8_train = run("int8_train", phase_int8_train, peaks, smi) or {"k1_launches": {}}
    launches.update(int8_train["k1_launches"])
    artist_clf = run("train_artist_classifier", phase_train_artist_classifier, peaks, smi)
    serve = {"k1_launches": {}}
    if artist_clf is not None:
        launches["train_artist_classifier"] = artist_clf["launches"]
        try:
            serve = run("serve", phase_serve, smi, artist_clf["best"], artist_clf["cli_pth"],
                        profile=args.profile) or serve
        finally:
            shutil.rmtree(artist_clf["tmp"], ignore_errors=True)
    launches.update(serve["k1_launches"])
    # The phases with gloo ranks on the card share one launch a world size.
    rank_phases = {name: fn(*a) for name, fn, a in (
        ("parallel", phase_parallel, (peaks,)), ("space_train", phase_space_train, (peaks, smi)),
        ("space_train_more", space_train_more, (peaks, smi)),
        ("space_more", phase_space_more, (peaks, smi))) if name in chosen}
    ranked = run_rank_phases(rank_phases, seconds=seconds) if rank_phases else {}
    par, space, space_modes, space_more = (
        ranked.get(name, {"k1_launches": {}, "k1_shapes": {}})
        for name in ("parallel", "space_train", "space_train_more", "space_more"))
    for value in (par, space, space_modes, space_more):
        launches.update(value["k1_launches"])
    space_k1 = run("space_train_k1", space_k1_rows,
                   [space["k1_shapes"], space_modes["k1_shapes"]], peaks, smi)
    rows = run("kernel_rows", phase_kernel_rows, peaks, smi)
    diff = run("diffusion", phase_diffusion, peaks, smi) or {"k1_launches": {}}
    launches.update(diff["k1_launches"])
    in_q8 = run("in_q8", phase_in_q8, peaks, smi)
    if args.profile:
        run("profile", phase_profile)
    # Each phase's seconds on the host clock, build included: where a cut of depth pays.
    print(json.dumps({"phase": "timing", "seconds": seconds,
                      "total_s": time.perf_counter() - start}), flush=True)
    print(smi, flush=True)
    if args.phases:  # a probe: not the contract's line
        print(json.dumps({"probe": args.phases, "passed": True}), flush=True)
        return 0
    # K2's times: the sums over the 68 launches of one int8 eval batch (the main path).
    k2 = {k: int8["shapes"]["eval_transformer_1024"][k] + int8["shapes"]["eval_resnet_256"][k]
          for k in ("ms", "device_ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                    "cudnn_bf16_ms", "library_ms", "library_k2_ms", "library_k2_device_ms",
                    "library_launches", "library_failed_launches")}
    paths = {**int8["shapes"], **int8_train["shapes"], "stylize_spatial_int8_band": par["band"],
             "train_space_band": space_modes["k2"], "eval_int8_space_band": space_more["k2"]}
    k2_err = {k: max(v[k] for v in paths.values())
              for k in ("s32_max_abs_err", "dequant_max_rel_err")}
    # K2's data gradients: the sums over one step's dgrad launches of each int8 training net.
    dgrad = {k: sum(v[k] for p, v in paths.items() if p.endswith("_dgrad"))
             for k in ("ms", "device_ms", "plain_ms", "bound_ms", "cudnn_bf16_ms", "launches")}
    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": GRAM_SOURCE,
        "replaces": GRAM_REPLACES,
        "launches": launches["gatys"],
        "launches_by_path": launches,
        "max_abs_err": gram["max_abs_err"],
        "max_rel_err": gram["max_rel_err"],
        "ms": gram["ms"],
        "device_ms": gram["device_ms"],
        "plain_ms": gram["plain_ms"],
        "bound_ms": gram["bound_ms"],
        "bound_by": "operations" if gram["ops_ms"] >= gram["bytes_ms"] else "bytes",
        "library_ms": gram["library_ms"],
        "device_ms_sources": DEVICE_MS_SOURCES.get("gram_tile_kernel"),
        "library_device_ms_sources": DEVICE_MS_SOURCES.get(""),
        "launches_are": "launches: the Gatys main path; launches_by_path: each path's own "
                        "count, its counter zeroed just before it; eval, train_classifier, "
                        "stylize_int8, eval_int8, int8_train_classifier, "
                        "train_artist_classifier and serve (every request of phase serve) "
                        "compute no Gram and must count 0; the int8_train runs 2 a step "
                        "(relu1_2, relu2_2) "
                        "and 4 for the targets, their bf16 baseline 4 a step; "
                        "train_cli is the training CLI from directories, train_stream "
                        "train() over content_file_stream; train_dp rank 0 of 2 ranks on one "
                        "card over gloo, 'cycle' at 224x224, global B=4, one epoch (4 for the "
                        "targets, 4 a step on the rank's 2 images), train_dp_int8 the same "
                        "with quantize_loss and QAT trunk (4 for the targets, 2 a step); "
                        "train_space rank 0 of 2 ranks on one card over gloo training over "
                        "a ('data', 'space') mesh (1, 2), 'cycle' at 224x224, global B=4, "
                        "one epoch, each image's rows over the ranks (4 for the targets, "
                        "4 a step on the rank's band of each tap), train_space_2x2 rank 0 "
                        "of 4 ranks with mesh (2, 2) (the same counts), train_space_bf16 "
                        "two bf16 epochs over (1, 2) (4 + 4 a step); "
                        "eval_<f32|int8>_space_<1x2|2x2>, train_classifier_space_<frozen|"
                        "unfrozen> and diffusion_train_space_<1x2|2x2> rank 0 of phase "
                        "space_more's runs over a ('data', 'space') mesh compute no Gram: 0; "
                        "train_space_<run> rank 0 of the (1, 2) runs of 'classifier' mode "
                        "and the int8 options (one f32 epoch each at 224x224, global B=4): "
                        "clf, clf_bf16 and qclf compute no Gram (0), qloss and qat_qgram 2 a "
                        "step on the band of relu1_2 and relu2_2 + 4 for the targets, qat_all "
                        "4 + 4 a step; the _2x2 ones rank 0 of 4 with mesh (2, 2), the same "
                        "counts; "
                        "the diffusion_* paths (guided DDIM, training, the samplers, the CLI, "
                        "the CFID curve's training and sampling) compute no Gram: 0",
        "times_are": f"sum over the 4 VGG taps of one Gatys step ({GATYS_SIZE}x{GATYS_SIZE}, "
                     "N=1, f32); ms warm by CUDA events, device_ms cold-L2 by the profiler; "
                     f"train_taps the same over one train step ({TRAIN_SIZE}x{TRAIN_SIZE}, "
                     f"N={TRAIN_BATCH}, f32), train_taps_bf16 in bf16, int8_train_taps_bf16 "
                     "over relu1_2 and relu2_2 in bf16 (the taps of an int8 training step), "
                     f"train_dp_taps over the taps of a DP 'cycle' rank's step "
                     f"({TRAIN_SIZE}x{TRAIN_SIZE}, N=2, f32), train_space_taps over a "
                     f"(1, 2) ('data', 'space') rank's band of each tap "
                     f"({TRAIN_BATCH}x{TRAIN_SIZE // 2}x{TRAIN_SIZE}x64 and on, f32), "
                     "train_space_shapes each band shape those runs launched K1 at; "
                     "device_ms_sources counts the kernel's device_ms readings by source "
                     "(profiler, or events: CUDA events of the whole flushed call where no "
                     "profiled window recorded a device event), library_device_ms_sources "
                     "the library's",
        "train_taps": gram["train_taps"],
        "train_taps_bf16": gram["train_taps_bf16"],
        "int8_train_taps_bf16": gram["int8_train_taps_bf16"],
        "train_dp_taps": rows["k1_train_dp"],
        "train_space_taps": space_k1["step_taps"],
        "train_space_shapes": space_k1["k1_rows"],
        "peaks": variant,
    }, {
        "name": "qconv_i8",
        "route": "cuda",
        "source": QCONV_SOURCE,
        "replaces": QCONV_REPLACES,
        "launches": int8["launches"]["eval_int8"],
        "launches_by_path": {**int8["launches"], **int8_train["launches"],
                             **serve["launches"], **par["k2_launches"], **space_modes["k2_launches"],
                             **space_more["k2_launches"], **diff["k2_launches"]},
        "max_abs_err": k2_err["s32_max_abs_err"],
        "bf16_mismatches": sum(v["bf16_mismatches"] for v in paths.values()),
        "dequant_max_rel_err": k2_err["dequant_max_rel_err"],
        "ms": k2["ms"],
        "device_ms": k2["device_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": "operations" if k2["ops_ms"] >= k2["bytes_ms"] else "bytes",
        "library_ms": k2["library_ms"],
        "library_launches": k2["library_launches"],
        "library_failed_launches": k2["library_failed_launches"],
        "library_k2_ms": k2["library_k2_ms"],
        "library_k2_device_ms": k2["library_k2_device_ms"],
        "cudnn_bf16_ms": k2["cudnn_bf16_ms"],
        "device_ms_sources": DEVICE_MS_SOURCES.get("qconv_kernel"),
        "launches_are": "launches: the int8 eval main path (16 images, 4 batches of 68: 16 "
                        "TransformerNet and 52 ResNet-50 convs), counter zeroed just before; "
                        "stylize_int8 one 512x512 B=4 forward; eval_cli_int8 the --quantize "
                        "CLI's one batch; int8_train_* the int8 training runs of phase "
                        "int8_train (224x224 B=4 bf16, each int8 conv forward and dgrad a "
                        "step, the targets' forward once): quantize_loss 3 epochs x 4 steps "
                        "x 12 + 6, qat_trunk x 38 + 6, qat_all 1 epoch x 44 + 6, "
                        "classifier 4 steps x 104, cli the --quantize_loss --qat CLI; "
                        "serve_int8_stylize and serve_classify phase serve's int8 stylize and "
                        "classify requests, each path alone over HTTP (16 a stylize batch, 52 "
                        "a classify batch); stylize_spatial_int8 and eval_int8_dp rank 0 of 2 "
                        "ranks on one card over gloo: one 512x512 image's band of rows (16), "
                        "one 1024x1024 B=4 eval batch's 2 images (68); train_dp_int8 rank 0 "
                        "of DP 'cycle' training at 224x224, global B=4, one epoch, with "
                        "quantize_loss and QAT trunk (4 steps x 38 + 6, the single "
                        "process's count); train_space_<run> rank 0 of 2 ranks on one card "
                        "over gloo training over a ('data', 'space') mesh (1, 2), one f32 "
                        "epoch of 4 steps at 224x224, global B=4 (qclf 2 steps, 8 images), "
                        "each conv forward and dgrad on the rank's band: qloss 4 x 12 + 6 "
                        "(the targets), qat_qgram 4 x 26, qat_all 4 x 32, qclf 2 x 104, clf "
                        "and clf_bf16 0; the _2x2 ones "
                        "rank 0 of 4 with mesh (2, 2), the same counts; "
                        "eval_int8_space_1x2 and eval_int8_space_2x2 rank 0 of the int8 eval "
                        "over a ('data', 'space') mesh (1, 2) and (2, 2) on gloo ranks on one "
                        "card: one 1024x1024 B=4 batch, each rank its data slice's band of "
                        "rows, 68 (16 + 52); "
                        "the diffusion_* paths run the f32 ResNet-50 and no int8 conv: 0",
        "times_are": "sums over the 68 launches of one int8 eval batch (TransformerNet at "
                     "1024x1024, ResNet-50 at 256x256, B=4), each launch one kernel: a "
                     "transpose conv's sub-pixel classes and split-K's final sum and epilogue "
                     "run inside it; ms warm by CUDA events, device_ms "
                     "cold-L2 by the profiler; no PyTorch call computes an int8 conv: "
                     "library_ms is torch._int_mm summed over the batch's 1x1 stride-1 "
                     "launches alone (library_launches of them; library_failed_launches where "
                     "it refused the shape), library_k2_ms and library_k2_device_ms K2's "
                     "sums over the same launches; "
                     "cudnn_bf16_ms the bf16 conv of each shape, the real dtype's reference; "
                     "paths holds each path's sums (train_*: one step of the int8 training "
                     "nets, forward and dgrad launches apart; stylize_spatial_int8_band both "
                     "ranks' launches at the row-band shapes of a 512x512 image over 2 "
                     "ranks; train_space_band every rank's launches of phase space_train's "
                     "int8 runs over (1, 2) and (2, 2), forward and dgrad, at their band "
                     "shapes, warm events only; eval_int8_space_band every rank's launches "
                     "of phase space_more's int8 eval over (1, 2) and (2, 2) at their band "
                     "shapes, warm events only), dgrad the sums over the train_*_dgrad paths, kernel_rows the sums "
                     "of phase kernel_rows' paths (warm events only), and each qconv line "
                     "its shape's plan; device_ms_sources counts K2's device_ms readings "
                     "by source (profiler, or events: CUDA events of the whole flushed call "
                     "where no profiled window recorded a device event)",
        "paths": paths,
        "dgrad": dgrad,
        "kernel_rows": rows["k2"],
        "peaks": variant,
    }, {
        "name": "in_q8",
        "route": "cuda",
        "source": IN_Q8_SOURCE,
        "replaces": "none: the JAX package's _in_act and _quant_act are XLA fusions",
        "launches": in_q8["launches"]["stylize_int8"],
        "launches_by_path": in_q8["launches"],
        **in_q8["worst"],
        **{k: in_q8["paths"][f"forward_{IN_Q8_SIZE}_b{IN_Q8_BATCHES[0]}_bfloat16"][k]
           for k in ("ms", "plain_ms", "bound_ms", "moved_bound_ms", "square_device_ms",
                     "apply_device_ms")},
        "device_ms": in_q8["paths"][f"forward_{IN_Q8_SIZE}_b{IN_Q8_BATCHES[0]}_bfloat16"][
            "call_device_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "launches_are": "launches: fused calls (each PyTorch's two means, the squares and the "
                        "apply) of one stylize_int8 "
                        f"batch of {IN_Q8_BATCHES[0]} at {IN_Q8_SIZE}x{IN_Q8_SIZE}, counter "
                        "zeroed just before: the stem's and the 16 int8 convs' instance norms",
        "times_are": f"sums over the {IN_Q8_FORWARD} calls of one int8 TransformerNet forward "
                     f"at {IN_Q8_SIZE}x{IN_Q8_SIZE}, B={IN_Q8_BATCHES[0]}, bf16 accumulators; "
                     "ms warm by CUDA events, device_ms the whole call's cold-L2 device time "
                     "by the profiler (PyTorch's means included), square_device_ms and "
                     "apply_device_ms the two kernels', plain_ms the plain op's, bound_ms the "
                     "bytes read once and written once at the HBM peak, moved_bound_ms the "
                     "bytes the call moves (the accumulator read three times, the f32 "
                     "squares written and read); no PyTorch call computes the fused op; "
                     "paths holds each forward's sums (B = 8 and 4, bf16 and int32 "
                     "accumulators)",
        "paths": in_q8["paths"],
        "peaks": variant,
    }]}), flush=True)
    print(ok_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
