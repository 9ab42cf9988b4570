#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``artist_style_transfer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py             # every phase, one card
    python3 chip_smoke.py --profile   # plus device time by kernel: Gatys steps, a stylize
                                      # batch, 4 'cycle' training steps, an eval batch,
                                      # 4 'classifier' training steps, 8 streamed steps,
                                      # an int8 stylize batch and an int8 eval batch

Phases, one JSON line each; any failure raises and exits non-zero:

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
12. the kernels line; the card line; then ``{"ok": true, ...}`` last.

Imports neither JAX nor the JAX package, nor PIL; OpenCV only inside the
phases that write or read JPEGs (``eval``'s CLI step, ``data``). Without CUDA,
or without the port's package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

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


def device_ms(fn, kernel: str, iters: int = 20, attempts: int = 5) -> float:
    """Device time per call of ``fn`` from ``torch.profiler``, with L2 flushed before each call.

    Counts the kernels whose name holds ``kernel`` (``""``: every kernel of
    ``fn``), which must run the same number of times in every call; the
    flush's own fill kernel never counts. The profiler now and then drops
    device events (seen on the H100 machine: 11 or 18 of 20 launches
    recorded), so each window is a warm-up cycle of the profiler followed by
    the recorded one, and a window that still lost events is taken again, up
    to ``attempts`` times.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
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
            return sum(ev.self_device_time_total for ev in rows) / 1e3 / iters
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
                if sums is not None:
                    for k, v in zip(keys, (kernel_ms, kernel_dev, plain_ms, library_ms,
                                           bound_ms, t_ops, t_bytes)):
                        sums[k] += v
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **main, "train_taps": train,
            "train_taps_bf16": train_bf16}


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
                   device: str, compute_dtype: str = "float32", classifier=None):
    """Step functions from ``init_transformer`` seed 0, and the corpus on ``device``:
    'cycle', or 'classifier' when a classifier is given."""
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
                        classifier=classifier)
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


def data_workspace(root: str, size_range=(320, 641), painting_range=(200, 501)) -> dict:
    """The seeded workspace of the data phase under ``root``, in the reference's layout:
    ``images/content/`` (DATA_CONTENT JPEGs and one truncated file),
    ``images/archive/artists.csv`` and ``resized/resized/<name>_<i>.jpg``, an empty
    ``dicts/``, ``models/vgg16-00b39a1b.pth``. Images are smooth colour fields with
    noise, so they compress and decode like photographs rather than like white noise."""
    import cv2

    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    rng = np.random.default_rng(7)

    def image(lo: int, hi: int) -> np.ndarray:
        h, w = (int(v) for v in rng.integers(lo, hi, 2))
        coarse = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
        smooth = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
        return np.clip(smooth + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)

    ws = {k: os.path.join(root, v) for k, v in (
        ("content", "images/content"), ("archive", "images/archive"), ("cache", "dicts"),
        ("models", "models"))}
    for d in ws.values():
        os.makedirs(d)
    paintings = os.path.join(ws["archive"], "resized", "resized")
    os.makedirs(paintings)
    for i in range(DATA_CONTENT):
        cv2.imwrite(os.path.join(ws["content"], f"c{i:03d}.jpg"), image(*size_range))
    with open(os.path.join(ws["content"], "c000.jpg"), "rb") as fh:
        head = fh.read(200)  # inside the JPEG headers: no decoder gets an image out of it
    ws["bad"] = os.path.join(ws["content"], "truncated.jpg")
    with open(ws["bad"], "wb") as fh:
        fh.write(head)
    with open(os.path.join(ws["archive"], "artists.csv"), "w") as fh:
        fh.write("id,name,paintings\n")
        for k, (name, n) in enumerate(DATA_ARTISTS):
            fh.write(f"{k},{name},{n}\n")
            for i in range(1, n + 1):
                cv2.imwrite(os.path.join(paintings, f"{name.replace(' ', '_')}_{i}.jpg"),
                            image(*painting_range))
    ws["vgg"] = os.path.join(ws["models"], "vgg16-00b39a1b.pth")
    torch.save(init_vgg16(torch.Generator().manual_seed(0)).state_dict(), ws["vgg"])
    ws["artist"] = DATA_ARTISTS[0][0].replace(" ", "_")
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


def check_qconv_shapes(calls: list[tuple], path: str, peaks: dict) -> dict:
    """K2 against its plain f64 version on each distinct shape of ``calls`` (a path's
    launches), in all three epilogues, and its times; returns the path's sums over its
    launches (a shape counts as often as the path launches it)."""
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
        dev = device_ms(run, "qconv_kernel")
        plain_ms = time_ms(lambda: conv_i8_plain(x, w, stride, (lo, hi), dil, mode, out),
                           iters=3, warmup=1)
        t_ops, t_bytes, macs = qconv_bound(x, w, y, stride, dil, peaks)
        bound = max(t_ops, t_bytes)
        require(dev >= bound / 1.05, f"K2 {path} {key}: device {dev} ms under the bound "
                                     f"{bound} ms: the bound is miscounted")
        lib = qconv_library(x, w, stride, lo, hi, dil, exact)
        emit("qconv", path=path, x=list(x.shape), w=list(w.shape), stride=stride, pads=[lo, hi],
             lhs_dilation=dil, pad_mode=mode, epilogue=key[-1], launches=count,
             plan=plan_for(x, w, stride, lo, hi, dil, reflect).describe(),
             s32_max_abs_err=s32_err, bf16_mismatches=bf16_bad, dequant_max_rel_err=dq_rel,
             ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound,
             bound_by="operations" if t_ops >= t_bytes else "bytes", bound_share=bound / dev,
             gmac=macs / 1e9, tops=2 * macs / dev / 1e9, **lib)
        for k, v in zip(keys, (ms, dev, plain_ms, bound, t_ops, t_bytes, lib["cudnn_bf16_ms"])):
            sums[k] += v * count
    return {**sums, **worst, "launches": len(calls), "shapes": len(groups)}


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


def profile_window(path: str, run, units: int, unit: str, timeline: bool = False,
                   decode_wait: TimedStream | None = None) -> None:
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
              for us, k, cnt in rows[:20]])


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--profile", action="store_true",
                        help="also profile Gatys steps, a stylize batch, train steps of both "
                             "modes, an eval batch and streamed train steps by kernel")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import artist_style_transfer_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_header()
    variant, peaks = peaks_for(smi)
    phase_build()
    gram = phase_gram(peaks)
    phase_stylize()
    launches = {"gatys": phase_gatys()}
    launches["train"], launches["train_bf16"] = phase_train(peaks)
    phase_classifier(peaks)
    launches["eval"] = phase_eval()
    launches["train_classifier"] = phase_train_classifier(peaks)
    torch.cuda.reset_peak_memory_stats()
    launches["train_cli"], launches["train_stream"] = phase_data()
    phase_display()
    int8 = phase_int8(peaks, smi)
    launches.update(int8["k1_launches"])
    if args.profile:
        phase_profile()
    print(smi, flush=True)
    # K2's times: the sums over the 68 launches of one int8 eval batch (the main path).
    k2 = {k: int8["shapes"]["eval_transformer_1024"][k] + int8["shapes"]["eval_resnet_256"][k]
          for k in ("ms", "device_ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                    "cudnn_bf16_ms")}
    k2_err = {k: max(v[k] for v in int8["shapes"].values())
              for k in ("s32_max_abs_err", "dequant_max_rel_err")}
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
        "launches_are": "launches: the Gatys main path; launches_by_path: each path's own "
                        "count, its counter zeroed just before it; eval, train_classifier, "
                        "stylize_int8 and eval_int8 compute no Gram and must count 0; "
                        "train_cli is the training CLI from directories, train_stream "
                        "train() over content_file_stream",
        "times_are": f"sum over the 4 VGG taps of one Gatys step ({GATYS_SIZE}x{GATYS_SIZE}, "
                     "N=1, f32); ms warm by CUDA events, device_ms cold-L2 by the profiler; "
                     f"train_taps the same over one train step ({TRAIN_SIZE}x{TRAIN_SIZE}, "
                     f"N={TRAIN_BATCH}, f32), train_taps_bf16 in bf16",
        "train_taps": gram["train_taps"],
        "train_taps_bf16": gram["train_taps_bf16"],
        "peaks": variant,
    }, {
        "name": "qconv_i8",
        "route": "cuda",
        "source": QCONV_SOURCE,
        "replaces": QCONV_REPLACES,
        "launches": int8["launches"]["eval_int8"],
        "launches_by_path": int8["launches"],
        "max_abs_err": k2_err["s32_max_abs_err"],
        "bf16_mismatches": sum(v["bf16_mismatches"] for v in int8["shapes"].values()),
        "dequant_max_rel_err": k2_err["dequant_max_rel_err"],
        "ms": k2["ms"],
        "device_ms": k2["device_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": "operations" if k2["ops_ms"] >= k2["bytes_ms"] else "bytes",
        "library_ms": None,
        "cudnn_bf16_ms": k2["cudnn_bf16_ms"],
        "launches_are": "launches: the int8 eval main path (16 images, 4 batches of 68: 16 "
                        "TransformerNet and 52 ResNet-50 convs), counter zeroed just before; "
                        "stylize_int8 one 512x512 B=4 forward; eval_cli_int8 the --quantize "
                        "CLI's one batch",
        "times_are": "sums over the 68 launches of one int8 eval batch (TransformerNet at "
                     "1024x1024, ResNet-50 at 256x256, B=4), each launch one kernel: a "
                     "transpose conv's sub-pixel classes and split-K's final sum and epilogue "
                     "run inside it; ms warm by CUDA events, device_ms "
                     "cold-L2 by the profiler; library_ms null: no PyTorch call computes an "
                     "int8 conv (torch._int_mm only its 1x1 shapes, in the qconv lines); "
                     "cudnn_bf16_ms the bf16 conv of each shape, the real dtype's reference; "
                     "paths holds each path's sums, and each qconv line its shape's plan",
        "paths": int8["shapes"],
        "peaks": variant,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
