"""The host plan of kernel K2 (``ops/cuda/qconv_plan.py``) held on the CPU.

The kernel cannot run here, so what it executes is held instead: a test-side
executor runs a plan's sub-pixel classes, their taps and input offsets, the K
order in ``K_STEP`` stages with the zero-filled tail, and the split-K ranges,
with torch f64 ops (exact: every sum of int8 products stays far below 2^53),
and must equal ``conv_i8_plain`` bit for bit in int32. Then: every output pixel
lies in exactly one class; the plan's MACs are the conv's own (``chip_smoke``'s
``qconv_bound`` count at the main path's shapes); the split ranges cover the K
steps once; every main-path shape of the TransformerNet at 512² and 1024² and
of the ResNet-50 at 256² gets a plan; the argument block matches what
``csrc/qconv.cu`` reads.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from artist_style_transfer_tpu.ops.qconv import _dgrad_pad
from artist_style_transfer_tpu_torch.ops.cuda import qconv_plan as qp
from artist_style_transfer_tpu_torch.ops.qconv import conv_i8_plain
from bench_qconv import resnet_shapes, transformer_shapes
from tests.test_torch_data import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def execute(plan: qp.QconvPlan, xq: torch.Tensor, wq: torch.Tensor):
    """Run ``plan`` as the kernel does, in f64 on the CPU: class by class, its K steps
    (gather: K_STEP bytes of the (tap, C_in) order, the tail zero; halo: one tap of one
    128-channel slice) split by split. Returns the int32 output (NCHW) and how many
    classes wrote each output pixel."""
    n, cin, h, w = xq.shape
    cout = wq.shape[0]
    x = xq.permute(0, 2, 3, 1).double()  # NHWC, as the kernel reads it
    wrows = wq.permute(0, 2, 3, 1).reshape(cout, -1).double()  # (C_out, kh*kw*C_in) rows
    out = torch.zeros((n, plan.ho, plan.wo, cout), dtype=torch.float64)
    written = torch.zeros((n, plan.ho, plan.wo), dtype=torch.int64)
    for c in plan.classes:
        k = len(c.taps) * cin
        a = torch.zeros((n, c.nh, c.nw, k), dtype=torch.float64)  # the rows of (tap, C_in)
        b = torch.zeros((cout, k), dtype=torch.float64)
        ih0 = torch.arange(c.nh) * plan.cstride
        iw0 = torch.arange(c.nw) * plan.cstride
        for j, (tap, off_h, off_w) in enumerate(c.taps):
            ih, iw = ih0 + off_h, iw0 + off_w
            if plan.reflect:
                ih = torch.where(ih < 0, -ih, ih)
                ih = torch.where(ih >= h, 2 * (h - 1) - ih, ih)
                iw = torch.where(iw < 0, -iw, iw)
                iw = torch.where(iw >= w, 2 * (w - 1) - iw, iw)
            ok = ((ih >= 0) & (ih < h))[:, None] & ((iw >= 0) & (iw < w))[None, :]
            g = x[:, ih.clamp(0, h - 1)][:, :, iw.clamp(0, w - 1)] * ok[None, :, :, None]
            a[..., j * cin:(j + 1) * cin] = g
            b[:, j * cin:(j + 1) * cin] = wrows[:, tap * cin:(tap + 1) * cin]
        a = a.reshape(n * c.nh * c.nw, k)
        acc = torch.zeros((a.shape[0], cout), dtype=torch.float64)
        for s in range(plan.splits):
            k0, k1 = qp.split_range(c.steps, plan.splits, s)
            for step in range(k0, k1):
                if plan.mode == "halo":
                    t, sl = step % len(c.taps), step // len(c.taps)
                    lo = t * cin + sl * qp.K_STEP
                    hi = lo + qp.slice_bytes(cin)
                else:
                    lo, hi = step * qp.K_STEP, min(k, (step + 1) * qp.K_STEP)
                acc += a[:, lo:hi] @ b[:, lo:hi].T
        rows = plan.period * torch.arange(c.nh) + c.ph
        cols = plan.period * torch.arange(c.nw) + c.pw
        out[:, rows[:, None], cols[None, :]] = acc.reshape(n, c.nh, c.nw, cout)
        written[:, rows[:, None], cols[None, :]] += 1
    return out.round().to(torch.int32).permute(0, 3, 1, 2), written


def own_macs(n, h, w, cin, cout, kh, kw, stride, lo, hi, d) -> int:
    """Products of the conv whose tap sits on the input's lattice, counted over the
    dilated, padded input: an input pixel, or a pad at the lattice's spacing (pads
    count, as they do in an undilated conv); the inserted zeros, and pads between
    lattice points, do not."""
    def axis(size, k):
        length = (size - 1) * d + 1 + lo + hi
        out = (length - k) // stride + 1
        on_lattice = (np.arange(length) - lo) % d == 0
        return sum(int(on_lattice[o * stride:o * stride + k].sum()) for o in range(out))
    return n * axis(h, kh) * axis(w, kw) * cin * cout


def grid_cases():
    """(d, k, stride, lo, hi, mode) over the plan's geometries."""
    cases = []
    for k in (1, 3):
        for stride in (1, 2):
            cases.append((1, k, stride, k // 2, k // 2, "zeros"))
            cases.append((1, k, stride, k // 2, k // 2, "reflect"))
            cases.append((1, k, stride, 0, 1, "zeros"))
            for d in (2, 3):  # transpose-conv pads, and none
                cases.append((d, k, stride, k - 1 - k // 2, k - 1 - k // 2 + d - 1, "zeros"))
                cases.append((d, k, stride, 0, 0, "zeros"))
    cases.append((2, 3, 1, 1, 2, "zeros"))  # the decoder's stride-2 transpose convs
    # JAX's dgrad of the stride-2 3x3 (pad 1) and 1x1 (pad 0) convs, at an even and an odd input.
    for k, pad in ((3, 1), (1, 0)):
        for i_size in (8, 9):
            o_size = (i_size + 2 * pad - k) // 2 + 1
            lo, hi = _dgrad_pad(i_size, o_size, k, 2, 1, pad)
            cases.append((2, k, 1, lo, hi, f"dgrad{i_size}"))
    return cases


def _inputs(seed, n, cin, h, w, cout, k):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (n, cin, h, w), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8))
    return (xq.contiguous(memory_format=torch.channels_last),
            wq.contiguous(memory_format=torch.channels_last))


def _grid_shape(mode):
    """(h, w) of a grid case: dgrad cases take the forward output of their input size."""
    if mode.startswith("dgrad"):
        i = int(mode[5:])
        return (i + 1) // 2, (i + 1) // 2
    return 7, 8


@pytest.mark.parametrize("case", grid_cases(), ids=lambda c: "d{}k{}s{}p{}-{}{}".format(*c))
@pytest.mark.parametrize("cin", [32, 96])
def test_plan_executes_to_the_plain_conv(case, cin):
    """The plan, run class by class, tap by tap and split by split, equals the plain
    conv bit for bit; every output pixel is written by exactly one class."""
    d, k, stride, lo, hi, mode = case
    h, w = _grid_shape(mode)
    xq, wq = _inputs(cin + 7 * k + d, 2, cin, h, w, 6, k)
    pad_mode = "reflect" if mode == "reflect" else "zeros"
    want = conv_i8_plain(xq, wq, stride, (lo, hi), d, pad_mode)
    pick = qp.plan_qconv(tuple(xq.shape), tuple(wq.shape), stride, lo, hi, d,
                         pad_mode == "reflect")
    tiles = [None] + [t for t in qp.candidates(pick.classes, cin, 6, pick.cstride)
                      if t[1:] in ((64, 32, 1, 3, 1), (64, 32, 2, 3, 1), (64, 32, 1, 3, 2))]
    # Halo mode at class stride 1 or 2 and whole slices (C_in 96 is neither 32, 64 nor 128k).
    assert any(t and t[0] == "halo" for t in tiles) == (pick.cstride <= 2 and cin != 96)
    if k == 3 and d == 1:  # one class of 9 taps: K enough for a 2-way split
        assert any(t and t[3] == 2 for t in tiles)
    for tile in tiles:  # the pick; each mode plain, with 2-way split-K, with 2-unit stages
        plan = qp.plan_qconv(tuple(xq.shape), tuple(wq.shape), stride, lo, hi, d,
                             pad_mode == "reflect", tile=tile)
        got, written = execute(plan, xq, wq)
        assert (plan.ho, plan.wo) == tuple(want.shape[2:])
        assert torch.equal(got, want.contiguous()), f"plan {plan.describe()}"
        assert bool((written == 1).all()), "an output pixel outside or in two classes"
        assert plan.macs == own_macs(2, h, w, cin, 6, k, k, stride, lo, hi, d)


@pytest.mark.parametrize("d,k,stride,lo,hi,size", [
    (2, 3, 1, 1, 2, 16), (3, 3, 1, 2, 4, 10), (2, 1, 1, 0, 1, 9), (2, 3, 2, 1, 1, 11),
    (3, 5, 2, 2, 3, 13), (1, 3, 2, 1, 1, 9), (4, 3, 1, 2, 5, 6)])
def test_axis_classes_partition_the_outputs(d, k, stride, lo, hi, size):
    """Along one axis the classes' outputs P*a + p cover every output once, and each
    class's taps are exactly the taps not on an inserted zero."""
    ax = qp.axis_plan(size, k, stride, lo, hi, d)
    outs = sorted(ax.period * a + p for p, count, _ in ax.phases for a in range(count))
    assert outs == list(range(ax.out))
    assert ax.period == d // math.gcd(stride, d) and ax.stride == stride // math.gcd(stride, d)
    for p, count, taps in ax.phases:
        for a in range(count):
            o = ax.period * a + p
            real = [r for r in range(k) if (o * stride + r - lo) % d == 0]
            assert [r for r, _ in taps] == real
            for r, off in taps:
                assert (o * stride + r - lo) // d == a * ax.stride + off


def halo_maps_agree(plan: qp.QconvPlan, c: qp.ConvClass, oy0: int, ox0: int) -> None:
    """The kernel's two halo index maps for the 8x8 patch at class output (oy0, ox0):
    the fill (halo pixel -> input pixel, stride-2 columns even then odd) and the MMA's
    read of tap (dh, dw) for output (y, x) (its start pixel, plus y rows of
    cstride * halo_w pixels, plus x) must meet at the input pixel the tap needs."""
    cs = plan.cstride
    hh, hw, min_dh, min_dw = c.halo(cs)
    even = (hw + 1) // 2 if cs == 2 else 0
    fill = []
    for pix in range(hh * hw):
        hy, hx = divmod(pix, hw)
        cx = hx if even == 0 else (2 * hx if hx < even else 2 * (hx - even) + 1)
        fill.append((oy0 * cs + min_dh + hy, ox0 * cs + min_dw + cx))
    for _, dh, dw in c.taps:
        e = dw - min_dw
        start = (dh - min_dh) * hw + (e if even == 0 else (even if e & 1 else 0) + (e >> 1))
        for y in range(qp.PATCH):
            for x in range(qp.PATCH):
                pix = start + y * cs * hw + x
                assert 0 <= pix < hh * hw
                assert fill[pix] == ((oy0 + y) * cs + dh, (ox0 + x) * cs + dw)


@pytest.mark.parametrize("case", grid_cases() + [(1, 3, 2, 1, 1, "zeros"),
                                                 (2, 3, 4, 1, 1, "zeros")],
                         ids=lambda c: "d{}k{}s{}p{}-{}{}".format(*c))
def test_halo_index_maps_meet(case):
    """Halo mode reads every tap's input through the halo: at class stride 1 and 2,
    for the first and an inner patch of every class."""
    d, k, stride, lo, hi, mode = case
    h, w = _grid_shape(mode)
    plan = qp.plan_qconv((1, 32, 4 * h, 4 * w), (6, 32, k, k), stride, lo, hi, d,
                         mode == "reflect")
    if plan.cstride > 2:
        assert not any(t[0] == "halo" for t in qp.candidates(plan.classes, 32, 6, plan.cstride))
        return
    for c in plan.classes:
        for oy0, ox0 in ((0, 0), (8, 8)):
            halo_maps_agree(plan, c, oy0, ox0)


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 7, 9, 18, 36])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8, 16])
def test_split_ranges_cover_the_k_steps_once(steps, splits):
    ranges = [qp.split_range(steps, splits, s) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 <= e - b <= -(-steps // splits) for b, e in ranges)


MAIN_PATHS = {"transformer_512": transformer_shapes(512),
              "transformer_1024": transformer_shapes(1024),
              "resnet_256": resnet_shapes(256)}


@pytest.mark.parametrize("path", sorted(MAIN_PATHS))
def test_every_main_path_shape_gets_a_plan(path):
    """Every conv of the main paths gets a plan the kernel can launch: a tile it has,
    at most its tables' classes and taps, a grid in range, one class per output pixel
    (by count), the transpose convs as 4 classes of 1, 2, 2 and 4 taps, and split-K
    only where every split keeps 2 K steps."""
    shapes = MAIN_PATHS[path]
    assert len(shapes) == (16 if path.startswith("transformer") else 52)
    for shape in shapes:
        plan = qp.plan_qconv(*shape)
        assert (plan.bm, plan.bn) in qp.TILES and plan.bn <= max(32, plan.cout * 2)
        assert 1 <= len(plan.classes) <= qp.MAX_CLASSES
        assert 0 < plan.grid[0] < 2**31 and plan.grid[2] == plan.splits in qp.SPLITS
        assert sum(plan.n * c.nh * c.nw for c in plan.classes) == plan.n * plan.ho * plan.wo
        if plan.dilation == 2:
            assert sorted(len(c.taps) for c in plan.classes) == [1, 2, 2, 4]
        else:
            assert len(plan.classes) == 1 and len(plan.classes[0].taps) == plan.kh * plan.kw
        if plan.splits > 1:
            assert min(c.steps for c in plan.classes) >= 2 * plan.splits
            assert plan.workspace_ints == plan.grid[0] * plan.bm * plan.bn
        assert len(plan.args()) == qp.HEADER
        assert len(plan.table()) == qp.CLASS_INTS * qp.MAX_CLASSES + 3 * qp.MAX_TAPS
    plans = [qp.plan_qconv(*s) for s in shapes]
    if path == "resnet_256":  # the 8x8 stage under-fills the card without split-K
        assert any(p.splits > 1 for p in plans if p.ho == 8)


@pytest.mark.parametrize("path", sorted(MAIN_PATHS))
def test_plan_macs_are_qconv_bound_macs(path):
    """At every main-path shape the MACs the kernel multiplies are the conv's own,
    as chip_smoke.qconv_bound counts them for the bound (a transpose conv's inserted
    zeros left out)."""
    import chip_smoke

    peaks = chip_smoke.PEAKS["H100 SXM"]
    for shape in MAIN_PATHS[path]:
        plan = qp.plan_qconv(*shape)
        x = torch.empty(shape[0], dtype=torch.int8, device="meta")
        w = torch.empty(shape[1], dtype=torch.int8, device="meta")
        y = torch.empty((plan.n, plan.cout, plan.ho, plan.wo), dtype=torch.bfloat16,
                        device="meta")
        _, _, macs = chip_smoke.qconv_bound(x, w, y, shape[2], shape[5], peaks)
        assert plan.macs == macs, shape


def test_argument_blocks_match_the_kernel_source():
    """The tables' layout constants and the tile list are the kernel's; a plan's host
    block and device table decode back to its geometry, classes and taps."""
    src = (ROOT / "artist_style_transfer_tpu_torch" / "csrc" / "qconv.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kKStep"), const("kMaxClasses"), const("kMaxTaps"), const("kClassInts")) == \
        (qp.K_STEP, qp.MAX_CLASSES, qp.MAX_TAPS, qp.CLASS_INTS)
    cases = {(int(m) // 1000, int(m) % 1000) for m in re.findall(r"case (\d+): return launch", src)}
    assert cases == set(qp.TILES)
    plan = qp.plan_qconv((2, 64, 9, 9), (32, 64, 3, 3), 1, 1, 2, 2, False)
    args = plan.args()
    assert len(args) == qp.HEADER
    assert args[:19] == [2, 9, 9, 64, 32, 576, plan.ho, plan.wo, 2, 1, 0, plan.splits,
                         len(plan.classes), plan.m_tiles, plan.n_tiles, plan.bm, plan.bn, 9,
                         plan.slots]
    assert args[21:] == [int(plan.mode == "halo"), args[22], plan.halo_pixels, plan.group, 0]
    assert (args[19] & 0xFFFFFFFF, args[20]) == qp.fast_divisor(plan.n_tiles)
    table = plan.table()
    assert len(table) == qp.CLASS_INTS * qp.MAX_CLASSES + 3 * qp.MAX_TAPS
    assert all(-2**31 <= v < 2**31 for v in args + table)
    taps = table[qp.CLASS_INTS * qp.MAX_CLASSES:]
    for i, c in enumerate(plan.classes):
        row = table[qp.CLASS_INTS * i:qp.CLASS_INTS * (i + 1)]
        tile0, nh, nw, ph, pw, tap0, ntaps, steps = row[:8]
        assert (tile0, nh, nw, ph, pw, ntaps, steps) == (c.tile0, c.nh, c.nw, c.ph, c.pw,
                                                         len(c.taps), c.steps)
        assert (row[8] & 0xFFFFFFFF, row[9]) == qp.fast_divisor(nh * nw)
        assert (row[10] & 0xFFFFFFFF, row[11]) == qp.fast_divisor(nw)
        assert [tuple(taps[3 * t:3 * t + 3]) for t in range(tap0, tap0 + ntaps)] == list(c.taps)


def _fast_div(n: np.ndarray, mul: int, shr: int) -> np.ndarray:
    """The kernel's fast_div in 32-bit unsigned arithmetic."""
    hi = (n.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32)
    return ((hi + n.astype(np.uint64)) & np.uint64(0xFFFFFFFF)) >> np.uint64(shr)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 9, 12, 25, 64, 100, 127, 128, 1000, 4096,
                               16384, 65536, 65537, 262144, 1 << 20, 999983, (1 << 30) + 3,
                               (1 << 31) - 1])
def test_fast_divisor_divides_exactly(d):
    """The multiply-shift division equals n // d for every n the kernel divides:
    0 <= n < 2^31 (random n, the edges, and n around multiples of d)."""
    mul, shr = qp.fast_divisor(d)
    rng = np.random.default_rng(d)
    k = rng.integers(0, (2**31 - 1) // d + 1, 2000)
    n = np.concatenate([rng.integers(0, 2**31, 20000), np.arange(min(3 * d + 3, 20000)),
                        k * d, k * d - 1, k * d + d - 1,
                        [2**31 - 1, 2**31 - 2, (2**31 - 1) // d * d, (2**31 - 1) // d * d - 1]])
    n = n[(n >= 0) & (n < 2**31)].astype(np.uint64)
    assert np.array_equal(_fast_div(n, mul, shr), n // np.uint64(d))


@pytest.mark.parametrize("bad,match", [
    (((1, 48, 8, 8), (8, 48, 3, 3), 1, 1, 1, 1, False), "multiple of 32"),
    (((1, 32, 8, 8), (7, 32, 3, 3), 1, 1, 1, 1, False), "even"),
    (((1, 32, 8, 8), (8, 32, 3, 3), 1, 1, 1, 2, True), "reflects only"),
    (((1, 32, 4, 4), (8, 32, 3, 3), 1, 4, 4, 1, True), "under the size"),
    (((1, 32, 8, 8), (8, 32, 3, 3), 1, 1, 1, 1, False, ("gather", 96, 64, 1, 4, 1)), "no tile"),
    (((1, 32, 8, 8), (8, 32, 3, 3), 1, 1, 1, 1, False, ("gather", 128, 256, 1, 8, 1)), "no tile"),
    (((1, 96, 8, 8), (8, 96, 3, 3), 1, 1, 1, 1, False, ("halo", 64, 32, 1, 4, 1)), "no tile"),
])
def test_plan_refuses_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        qp.plan_qconv(*bad)
