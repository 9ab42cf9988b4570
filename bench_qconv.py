#!/usr/bin/env python3
"""The int8 conv kernel K2 on the card: device time at the main paths' shapes, for
A/B runs and tile sweeps.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 bench_qconv.py              # this checkout's K2, each shape at its plan's tile
    python3 bench_qconv.py --root DIR   # the K2 of the port package under DIR, e.g. an
                                        # earlier commit unpacked with git archive
    python3 bench_qconv.py --sweep      # this checkout's K2 at every tile and split-K
                                        # count the kernel has, beside the plan's pick
    python3 bench_qconv.py --fit FILE   # no card: the cost model's rates fitted to a
                                        # --sweep output, by launch-weighted regret

Shapes are the distinct int8 convs of the main paths on seeded random codes: the
quantized TransformerNet at 512x512 and 1024x1024 (B=4, bf16 epilogue, as
``stylize_int8`` and the int8 eval run it) and the quantized ResNet-50 at
256x256 (B=4, dequant to bf16). Each line holds the device time per call from
``torch.profiler`` with L2 flushed before each call (``chip_smoke.device_ms``),
the CUDA-event time of warm calls, the bound of ``chip_smoke.qconv_bound``,
whether the int32 epilogue equals the plain f64 conv, and the plan. Compare two
versions only within one run of the tool on one card, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke



def transformer_shapes(size: int, n: int = 4) -> list[tuple]:
    """(x shape, w shape, stride, lo, hi, lhs dilation, reflect) of the int8
    TransformerNet's 16 K2 convs on an n x size x size batch."""
    from artist_style_transfer_tpu_torch.models.transformer import DECODER_SPEC, ENCODER_SPEC
    from artist_style_transfer_tpu_torch.models.transformer_q import (
        DECODER_GEOMETRY,
        ENCODER_GEOMETRY,
        RESIDUAL_GEOMETRY,
    )

    shapes, s = [], size
    for (k, _, ci, co), (stride, pads, dil, mode) in zip(ENCODER_SPEC[1:], ENCODER_GEOMETRY):
        shapes.append(((n, ci, s, s), (co, ci, k, k), stride, *pads, dil, mode == "reflect"))
        s = (s + 2 * pads[0] - k) // stride + 1
    stride, pads, dil, mode = RESIDUAL_GEOMETRY
    shapes += [((n, 128, s, s), (128, 128, 3, 3), stride, *pads, dil, mode == "reflect")] * 10
    for (k, st, _, ci, co), (stride, pads, dil, mode) in zip(DECODER_SPEC, DECODER_GEOMETRY):
        shapes.append(((n, ci, s, s), (co, ci, k, k), stride, *pads, dil, mode == "reflect"))
        s *= st
    return shapes


def resnet_shapes(size: int = 256, n: int = 4) -> list[tuple]:
    """The int8 ResNet-50's 52 K2 convs (BN folded, zero pads) at size x size."""
    from artist_style_transfer_tpu_torch.models.resnet import RESNET50_STAGES

    shapes, s, cin = [], size // 4, 64  # after the bf16 stem (stride 2) and the max pool
    for blocks, width, stride in RESNET50_STAGES:
        for i in range(blocks):
            st = stride if i == 0 else 1
            so = (s + 2 - 3) // st + 1
            shapes += [((n, cin, s, s), (width, cin, 1, 1), 1, 0, 0, 1, False),
                       ((n, width, s, s), (width, width, 3, 3), st, 1, 1, 1, False),
                       ((n, width, so, so), (4 * width, width, 1, 1), 1, 0, 0, 1, False)]
            if i == 0:
                shapes.append(((n, cin, s, s), (4 * width, cin, 1, 1), st, 0, 0, 1, False))
            cin, s = 4 * width, so
    return shapes


def main_path_shapes() -> list[tuple[str, tuple, int]]:
    """(path, shape, launches on the path) of each distinct shape, in path order."""
    out: dict[tuple, int] = {}
    for path, shapes in (("transformer_512", transformer_shapes(512)),
                         ("transformer_1024", transformer_shapes(1024)),
                         ("resnet_256", resnet_shapes())):
        for shape in shapes:
            out[(path, shape)] = out.get((path, shape), 0) + 1
    return [(path, shape, count) for (path, shape), count in out.items()]


def candidate_tiles(qconv_plan, plan) -> list[tuple]:
    """Every (mode, BM, BN, splits, slots, group) the plan may pick for this shape."""
    return list(qconv_plan.candidates(plan.classes, plan.cin, plan.cout, plan.cstride))


def graph_ms(run, launches: int = 20, replays: int = 5) -> float:
    """Device time a call of ``run`` from a CUDA graph of ``launches`` calls, replayed
    (no host launch gaps; L2 warm): for ranking tiles, not for the record."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            run()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / (launches * replays)


def measure(label: str, sweep: bool, peaks: dict) -> None:
    from artist_style_transfer_tpu_torch.ops.cuda import qconv_kernel
    from artist_style_transfer_tpu_torch.ops.qconv import Dequant, conv_i8_plain

    planned = hasattr(qconv_kernel, "plan_for")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for path, shape, count in main_path_shapes():
        xs, ws, stride, lo, hi, dil, reflect = shape
        x = torch.randint(-127, 128, xs, generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, ws, generator=gen, device="cuda", dtype=torch.int8)
        x = x.contiguous(memory_format=torch.channels_last)
        w = w.contiguous(memory_format=torch.channels_last)
        if path.startswith("resnet"):
            out = Dequant(torch.tensor(0.0123, device="cuda"),
                          torch.rand(ws[0], generator=gen, device="cuda") * 1e-3,
                          torch.randn(ws[0], generator=gen, device="cuda"), torch.bfloat16)
        else:
            out = torch.bfloat16
        exact = conv_i8_plain(x, w, stride, (lo, hi), dil, "reflect" if reflect else "zeros")
        args = (x, w, stride, lo, hi, dil, reflect)
        run = lambda: qconv_kernel.conv_i8_cuda(*args, out)  # noqa: E731
        y = run()
        t_ops, t_bytes, _ = chip_smoke.qconv_bound(x, w, y, stride, dil, peaks)
        bound = max(t_ops, t_bytes)
        line = {"label": label, "path": path, "x": list(xs), "w": list(ws), "stride": stride,
                "pads": [lo, hi], "lhs_dilation": dil, "reflect": reflect, "launches": count,
                "bound_ms": bound}
        if sweep:
            from artist_style_transfer_tpu_torch.ops.cuda import qconv_plan

            pick = qconv_kernel.use_tile(*args, None)
            times = []
            for tile in candidate_tiles(qconv_plan, pick):
                plan = qconv_kernel.use_tile(*args, tile)
                exact_ok = bool(torch.equal(qconv_kernel.conv_i8_cuda(*args, torch.int32), exact))
                times.append({"tile": list(tile), "exact": exact_ok, "graph_ms": graph_ms(run),
                              "model_ms": qconv_plan.modelled_ns(plan) / 1e6})
            qconv_kernel.use_tile(*args, None)
            run()  # the plan's table reaches the device outside the graph's capture
            best = min(times, key=lambda t: t["graph_ms"])
            line.update(pick=[pick.mode, pick.bm, pick.bn, pick.splits, pick.slots, pick.group],
                        pick_graph_ms=graph_ms(run), best=best, all_exact=all(
                            t["exact"] for t in times), sweep=times)
        plan = qconv_kernel.plan_for(*args) if planned else None
        dev = chip_smoke.device_ms(run, "qconv_kernel", iters=10)
        line.update(plan=plan.describe() if plan else None,
                    exact=bool(torch.equal(qconv_kernel.conv_i8_cuda(*args, torch.int32), exact)),
                    device_ms=dev, ms=chip_smoke.time_ms(run), bound_share=bound / dev)
        print(json.dumps(line), flush=True)
        del x, w, exact


FIT_GRID = {  # the cost model's rates searched by --fit (qconv_plan's names)
    "_L2_PER_NS": (48.0, 64.0, 96.0),
    "_STORE_PER_NS": (2.0, 4.0, 8.0),
    "_LOAD_NS": (300.0, 600.0, 900.0),
    "_SYNC_NS": (600.0, 1000.0, 1500.0),
    "_BLOCK_NS": (1000.0, 2000.0, 3000.0),
    "_HALO_NS": (1000.0, 2000.0, 4000.0),
}


def fit(path: str) -> None:
    """Search FIT_GRID for the rates whose picks cost least on the sweep in ``path``:
    the sum over shapes of launches x the graph time of the tile the model picks,
    against the same sum over each shape's fastest tile (the regret)."""
    import itertools

    from artist_style_transfer_tpu_torch.ops.cuda import qconv_plan as qp

    shapes = []
    for ln in open(path):
        d = json.loads(ln) if ln.startswith('{"label') else None
        if d and "sweep" in d:
            shape = (tuple(d["x"]), tuple(d["w"]), d["stride"], *d["pads"], d["lhs_dilation"],
                     d["reflect"])
            shapes.append((qp.plan_qconv(*shape), d["launches"],
                           {tuple(t["tile"]): t["graph_ms"] for t in d["sweep"]}))

    def regret() -> tuple[float, float]:
        picked = best = worst = 0.0
        for base, launches, times in shapes:
            pick = min(times, key=lambda t: qp._cost(base.classes, base.cin, base.cout, base.n,
                                                     base.cstride, *t, 2))
            picked += launches * times[pick]
            best += launches * min(times.values())
            worst = max(worst, times[pick] / min(times.values()))
        return picked / best, worst

    print(json.dumps({"rates": {k: getattr(qp, k) for k in FIT_GRID}, "regret": regret()}))
    results = []
    for values in itertools.product(*FIT_GRID.values()):
        for k, v in zip(FIT_GRID, values):
            setattr(qp, k, v)
        results.append((regret(), dict(zip(FIT_GRID, values))))
    (total, worst), rates = min(results, key=lambda r: r[0])
    print(json.dumps({"fitted": rates, "regret": total, "worst_shape": worst,
                      "shapes": len(shapes)}))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                        help="directory holding the artist_style_transfer_tpu_torch package")
    parser.add_argument("--sweep", action="store_true",
                        help="time every tile and split-K count of the kernel at each shape")
    parser.add_argument("--fit", metavar="FILE",
                        help="fit the cost model's rates to a --sweep output (no card needed)")
    args = parser.parse_args(argv)
    if args.fit:
        fit(args.fit)
        return 0
    if not torch.cuda.is_available():
        print("bench_qconv: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import artist_style_transfer_tpu_torch  # noqa: F401
    from artist_style_transfer_tpu_torch.ops.cuda import build

    build.library()
    smi = chip_smoke.phase_header()
    variant, peaks = chip_smoke.peaks_for(smi)
    print(json.dumps({"root": root, "card": smi, "peaks": variant,
                      "build_seconds": build.last_build["seconds"],
                      "ptxas": [r for r in chip_smoke.ptxas_report(build.last_build["log"])
                                if "qconv" in r["function"]]}), flush=True)
    measure(os.path.basename(root.rstrip("/")) or root, args.sweep, peaks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
