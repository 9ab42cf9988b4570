#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``artist_style_transfer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py             # every phase, one card
    python3 chip_smoke.py --profile   # plus device time by kernel: Gatys steps, a stylize batch

Phases, one JSON line each; any failure raises and exits non-zero:

0. header: torch/CUDA versions, the card (``nvidia-smi`` name and power
   limit), and both TF32 flags, which parity mode keeps False;
1. build: compiles ``csrc/*.cu`` with nvcc (set-up time);
2. gram: the Hopper Gram kernel against the plain PyTorch version at the
   VGG tap shapes of Gatys at 256x256 (N=1) and of a 512x512 batch of 4,
   in f32 and bf16, with its gradient, kernel / plain / cuBLAS / bound times;
3. stylize: the committed golden TransformerNet on the card against the
   golden image (> 35 dB) and against the port's own CPU result (> 45 dB),
   then a seeded 4x512x512 batch through ``stylize_batched``;
4. gatys: 5 steps with the kernel against 5 without (loss traces within
   1e-4), then the main path: 300 default steps with the kernel counter
   zeroed just before, which must count 4 + 4*300 = 1204 launches;
5. the kernels line; the card line; then ``{"ok": true, ...}`` last.

Imports neither JAX nor the JAX package, nor cv2 or PIL. Without CUDA, or
without the port's package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
GRAM_SOURCE = "artist_style_transfer_tpu_torch/csrc/gram.cu"
GRAM_REPLACES = "artist_style_transfer_tpu/ops/pallas/gram_kernel.py:60"  # gram_matrix_pallas

# Published dense peaks (NVIDIA data sheets) by H100 variant: FP32 outside
# the tensor cores, bf16 tensor cores, HBM bandwidth. At full power limit.
PEAKS = {
    "H100 SXM": {"fp32": 67e12, "bf16": 989e12, "hbm": 3.35e12},
    "H100 PCIe": {"fp32": 51e12, "bf16": 756e12, "hbm": 2.0e12},
    "H100 NVL": {"fp32": 60e12, "bf16": 835e12, "hbm": 3.9e12},
}

TAPS = (("relu1_2", 1, 64), ("relu2_2", 2, 128), ("relu3_3", 4, 256), ("relu4_3", 8, 512))
GATYS_SIZE = 256
GATYS_STEPS = 300


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
    emit(
        "header",
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(),
        nvidia_smi=smi,
        precision=precision.get_precision(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    require(not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 is on in parity mode")
    require(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on in parity mode")
    return smi


def phase_build() -> None:
    from artist_style_transfer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    info = build.last_build
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "smem" in ln]
    emit("build", seconds=time.perf_counter() - t0, compiled=info["built"],
         nvcc_seconds=info["seconds"], library=str(build.BUILD_DIR / build.LIB_NAME), ptxas=ptxas)


def phase_gram(peaks: dict) -> dict:
    from artist_style_transfer_tpu_torch.ops import gram as gram_ops
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_abs = worst_rel = 0.0
    main = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "ops_ms": 0.0, "bytes_ms": 0.0}
    for size, n in ((GATYS_SIZE, 1), (512, 4)):
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
                kernel_ms = time_ms(lambda: gram_kernel.gram_matrix_cuda(f))
                plain_ms = time_ms(lambda: gram_ops.gram_matrix_plain(f))
                library_ms = time_ms(lambda: torch.bmm(f3.transpose(1, 2), f3) * scale)
                flops = 2.0 * n * hw * c * c
                nbytes = n * hw * c * f.element_size() + n * c * c * 4
                # The kernel computes in f32 FMA; the least time for bf16 inputs
                # is the bf16 tensor-core rate with f32 accumulation.
                peak = peaks["fp32"] if dtype == torch.float32 else peaks["bf16"]
                t_ops, t_bytes = flops / peak * 1e3, nbytes / peaks["hbm"] * 1e3
                bound_ms = max(t_ops, t_bytes)
                emit("gram", tap=tap, size=size, n=n, hw=hw, c=c, dtype=str(dtype)[6:],
                     splits=gram_kernel.split_plan(n, hw, c, torch.cuda.get_device_properties(0)
                                                   .multi_processor_count)[0],
                     max_abs_err=abs_err, max_rel_err=rel_err, grad_rel_err=grad_rel,
                     kernel_vs_f64_rel=kernel_vs_f64, plain_vs_f64_rel=plain_vs_f64,
                     kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by="operations" if t_ops >= t_bytes else "bytes",
                     gflop=flops / 1e9, kernel_tflops=flops / kernel_ms / 1e9)
                if size == GATYS_SIZE and n == 1 and dtype == torch.float32:
                    for k, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                                 ("library_ms", library_ms), ("bound_ms", bound_ms),
                                 ("ops_ms", t_ops), ("bytes_ms", t_bytes)):
                        main[k] += v
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **main}


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


def profile_window(path: str, run, units: int, unit: str) -> None:
    """Device time by kernel over one warm call of ``run`` (``--profile`` only).

    Only device-side events count: the host-side ``aten::`` rows carry their
    kernels' time too, and summing both would count it twice.
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
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    require(total_us > 0, f"profile of {path}: no device time recorded")
    emit("profile", path=path, units=units, unit=unit, wall_ms=wall_ms,
         device_busy_ms=total_us / 1e3, device_idle_share=1 - total_us / 1e3 / wall_ms,
         kernels_launched=sum(r[2] for r in rows),
         top=[{"kernel": k[:120], "ms": us / 1e3, "calls": cnt, "share": us / total_us}
              for us, k, cnt in rows[:20]])


def phase_profile() -> None:
    """Where the device time goes: 10 Gatys steps, and one stylize batch of 4 at 512²."""
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--profile", action="store_true",
                        help="also profile a few Gatys steps by kernel")
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
    launches = phase_gatys()
    if args.profile:
        phase_profile()
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": GRAM_SOURCE,
        "replaces": GRAM_REPLACES,
        "launches": launches,
        "max_abs_err": gram["max_abs_err"],
        "max_rel_err": gram["max_rel_err"],
        "ms": gram["ms"],
        "plain_ms": gram["plain_ms"],
        "bound_ms": gram["bound_ms"],
        "bound_by": "operations" if gram["ops_ms"] >= gram["bytes_ms"] else "bytes",
        "library_ms": gram["library_ms"],
        "times_are": f"sum over the 4 VGG taps of one Gatys step ({GATYS_SIZE}x{GATYS_SIZE}, "
                     "N=1, f32)",
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
