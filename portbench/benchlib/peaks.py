"""Published peaks of the H100 and the least time of a kernel launch on it.

The table and the two bounds are ``chip_smoke.py``'s ``PEAKS``, ``gram_bound`` and
``qconv_bound``, copied here so that the yardstick lives with the benchmark; times are in
seconds here. Peaks are NVIDIA's data-sheet dense rates at the full power limit: FP32
outside the tensor cores, TF32, bf16 and int8 (operations/s) on the tensor cores, and
HBM bandwidth (bytes/s).
"""

from __future__ import annotations

PEAKS = {
    "H100 SXM": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12, "hbm": 3.35e12},
    "H100 PCIe": {"fp32": 51e12, "tf32": 378e12, "bf16": 756e12, "int8": 1513e12, "hbm": 2.0e12},
    "H100 NVL": {"fp32": 60e12, "tf32": 418e12, "bf16": 835e12, "int8": 1671e12, "hbm": 3.9e12},
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the H100 variant that ``torch.cuda.get_device_name()`` names."""
    if "PCIe" in device_name:
        return PEAKS["H100 PCIe"]
    if "NVL" in device_name:
        return PEAKS["H100 NVL"]
    return PEAKS["H100 SXM"]


def op_seconds(flops: float, precision: str, peaks: dict) -> float:
    """Least time for ``flops`` operations at ``precision``: f32 at full f32 accuracy is
    the CUDA cores' FP32 or 3xTF32 on the tensor cores, whichever is faster."""
    if precision == "f32":
        return min(flops / peaks["fp32"], 3 * flops / peaks["tf32"])
    return flops / peaks[precision]


def gram_bound(n: int, hw: int, c: int, elem_bytes: int, peaks: dict) -> float:
    """Least seconds of one Gram launch over (n, hw, c) features: the C(C+1)/2 distinct
    entries, HW*C*(C+1) operations an image, at f32 accuracy (4-byte input) or the bf16
    rate; the features read once and the f32 (C, C) Grams written once."""
    flops = float(n) * hw * c * (c + 1)
    t_ops = op_seconds(flops, "f32" if elem_bytes == 4 else "bf16", peaks)
    nbytes = n * hw * c * elem_bytes + n * c * c * 4
    return max(t_ops, nbytes / peaks["hbm"])


def qconv_bound(n: int, cin: int, h: int, w: int, cout: int, k: int, ho: int, wo: int,
                dilation: int, out_bytes: int, peaks: dict) -> float:
    """Least seconds of one int8 conv launch: 2 operations a MAC at the int8 rate, the
    int8 input (h, w: before any lhs dilation) and weights read once, the output written
    once. A transpose conv (lhs dilation > 1) counts its own MACs, each input pixel
    times k^2 * C_out, not the inserted zeros."""
    if dilation > 1:
        macs = float(n) * h * w * cin * cout * k * k
    else:
        macs = float(n) * ho * wo * cout * k * k * cin
    nbytes = n * cin * h * w + cout * cin * k * k + n * cout * ho * wo * out_bytes
    return max(2 * macs / peaks["int8"], nbytes / peaks["hbm"])
