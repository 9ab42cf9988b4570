"""Host plan of kernel K2 (``csrc/qconv.cu``): plain Python, no CUDA calls.

For one (shape, geometry) of an int8 conv the plan gives what the kernel
executes:

- the **sub-pixel classes**. An lhs dilation ``d`` inserts ``d - 1`` zeros
  between input pixels; a tap that falls on one of them multiplies a zero.
  Along one axis the outputs ``o`` with the same ``o mod P`` (``P = d / gcd(s,
  d)``, ``s`` the window stride) see the same set of real taps, each at a fixed
  input offset. So each class ``(p_h, p_w)`` is an ordinary conv over the
  undilated input, with stride ``s / gcd(s, d)``, its own list of taps and
  offsets, writing the outputs ``(P a + p_h, P b + p_w)``. For ``d = 1`` there
  is one class with every tap, the offsets ``r - lo``. A tap that lands in
  the pads stays in its class (zero or reflect padding, as in the ``d = 1``
  conv); only the inserted zeros are left out.
- the **K order**: a class's K is (tap in class order, C_in), the weight's
  tap ``t`` read at offset ``t * C_in`` of each (C_out, kh, kw, C_in) row, so
  no repack; the kernel walks it in stages of :data:`K_STEP` bytes and
  zero-fills the tail past ``len(taps) * C_in``;
- the **mode** of A: ``gather`` copies each tap's input rows for BM output
  pixels (any tap count; the 1x1 convs); ``halo`` gives each warpgroup an 8x8
  patch of outputs and copies its input halo once a 128-channel slice, and the
  MMA reads every tap's rows out of the halo (the 3x3 convs and the sub-pixel
  classes: up to 9x fewer bytes gathered). A halo stage is one tap of one
  slice; stride 1 or 2 (stride-2 halo columns are stored by parity, so a tap's 8
  outputs are 8 consecutive halo pixels);
- the **tile** (BM output pixels x BN output channels), the K units a
  pipeline stage holds (``group``: each stage costs a block-wide barrier and
  the MMA's fences, so a stage of several units spends fewer of them), the depth
  of the cp.async ring (``slots``) and the **split-K** count, from a small cost
  model of the H100 (:func:`choose_tile`); a split takes the K units
  ``[s * steps // S, (s + 1) * steps // S)`` of its class (:func:`split_range`);
- the **argument blocks** of the C entry point ``ast_qconv``: the host ints
  (:meth:`QconvPlan.args`) and the class and tap table the kernel reads from
  device memory (:meth:`QconvPlan.table`), with multiply-shift divisors
  (:func:`fast_divisor`) so that no thread divides at run time.

The conv is :func:`artist_style_transfer_tpu_torch.ops.qconv.conv_i8`'s:
``padding = (lo, hi)`` on both axes, applied after the zero-insert dilation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from artist_style_transfer_tpu_torch.ops.qconv import conv_out_size

K_STEP = 128  # int8 reduction bytes of a K unit: one 128-byte swizzled row, 4 wgmma k32 steps
CIN_MULTIPLE = 32  # C_in granule: no 16-byte copy straddles a tap, no 32-byte k32 step a unit
PATCH = 8  # a warpgroup's halo-mode outputs: PATCH x PATCH, one 8-row MMA group an output row
MAX_CLASSES = 16  # sizes of the tables in the kernel's device table (csrc/qconv.cu)
MAX_TAPS = 64
HEADER = 26  # ints of the host block
CLASS_INTS = 24  # ints a class in the device table
TILES = ((64, 32), (64, 64), (64, 128), (64, 256), (128, 32), (128, 64), (128, 128),
         (128, 256), (256, 32), (256, 64), (256, 128))  # the kernel's (BM, BN) instantiations
MODES = ("gather", "halo")
# What the plan picks from (the kernel takes any split-K count, 3 to 8 slots and any
# group): the sets bench_qconv.py --sweep times on the card, so that the fitted cost
# model ranks only what was measured.
SPLITS = (1, 2, 4, 8)
SLOTS = (3, 4, 6)
GROUPS = (1, 2, 3)
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 228 * 1024
MAX_SMEM = 232448 - 2048  # a block's 227 KB, less the kernel's static tables
RESERVED_SMEM = 1024  # the runtime's shared memory per block


def slice_bytes(cin: int) -> int:
    """Channels (bytes) of a halo-mode slice: at most one 128-byte row."""
    return min(cin, K_STEP)


def halo_bytes(bm: int, cin: int, halo_pixels: int) -> int:
    """Shared memory of the halos: one buffer a warpgroup of halo_pixels x the slice,
    two (alternating slices) where C_in has more than one slice; a multiple of 1024."""
    buffers = 1 if cin <= K_STEP else 2
    return -(-(buffers * (bm // 64) * halo_pixels * slice_bytes(cin)) // 1024) * 1024


def smem_bytes(bm: int, bn: int, slots: int, halo_pixels: int = 0, cin: int = 0,
               group: int = 1) -> int:
    """Dynamic shared memory of one block, plus 1024 bytes to align the swizzled tiles:
    gather mode (halo_pixels 0) the ring of A and B stages, halo mode the halos and a
    ring of B stages, a stage ``group`` K units; or the staged output tile if larger.
    Mirrors ``smem_bytes`` of ``csrc/qconv.cu``."""
    if halo_pixels:
        body = halo_bytes(bm, cin, halo_pixels) + slots * group * bn * K_STEP
    else:
        body = slots * group * (bm + bn) * K_STEP
    return max(body, bm * (bn * 4 + 32)) + 1024


def blocks_per_sm(bm: int, bn: int, smem: int) -> int:
    """Blocks an SM holds at once, by shared memory, threads and registers."""
    by_smem = SMEM_PER_SM // (smem + RESERVED_SMEM + 2048)
    by_threads = 2048 // (2 * bm)
    by_regs = 65536 // (2 * bm * max(bn // 2 + 64, 72))  # accumulators + the rest
    return max(1, min(by_smem, by_threads, by_regs))


def fast_divisor(d: int) -> tuple[int, int]:
    """(mul, shr) with n // d == (umulhi(n, mul) + n) >> shr for 0 <= n < 2^31, in
    32-bit unsigned arithmetic (the round-up method of Granlund and Montgomery);
    the kernel's ``fast_div``."""
    if not 1 <= d < 2**31:
        raise ValueError(f"divisor {d} out of range")
    shr = (d - 1).bit_length()  # ceil(log2(d))
    return ((1 << 32) * ((1 << shr) - d)) // d + 1, shr


@dataclass(frozen=True)
class AxisPlan:
    """One spatial axis: outputs ``o = period * a + phase`` of a phase read input
    ``a * stride + off`` for each of its taps ``(r, off)``."""

    out: int
    period: int
    stride: int
    phases: tuple[tuple[int, int, tuple[tuple[int, int], ...]], ...]  # (phase, count, taps)


def axis_plan(size: int, k: int, stride: int, lo: int, hi: int, dilation: int) -> AxisPlan:
    """The sub-pixel classes of one axis of a conv with window ``stride``, pads
    ``(lo, hi)`` and lhs dilation ``dilation`` over ``size`` input pixels."""
    out = conv_out_size(size, k, stride, lo, hi, dilation)
    g = math.gcd(stride, dilation)
    period, cstride = dilation // g, stride // g
    phases = []
    for p in range(period):
        # Tap r of output period*a + p sits at padded-dilated position
        # (period*a + p)*stride + r, input position q = that - lo
        # = d*(a*cstride) + (p*stride + r - lo): a real pixel iff d | (p*stride + r - lo).
        taps = tuple((r, (p * stride + r - lo) // dilation) for r in range(k)
                     if (p * stride + r - lo) % dilation == 0)
        count = max(0, -(-(out - p) // period))
        phases.append((p, count, taps))
    return AxisPlan(out, period, cstride, tuple(phases))


@dataclass(frozen=True)
class ConvClass:
    """One sub-pixel class: outputs ``(period*a + ph, period*b + pw)``, ``a < nh``,
    ``b < nw``; ``taps`` are (weight tap ``r * kw + s``, input offset h, offset w)."""

    ph: int
    pw: int
    nh: int
    nw: int
    taps: tuple[tuple[int, int, int], ...]
    steps: int  # K steps: gather ceil(len(taps) * C_in / K_STEP), halo slices * len(taps)
    tile0: int  # the class's first M tile in the launch
    m_tiles: int

    def halo(self, cstride: int) -> tuple[int, int, int, int]:
        """(rows, columns, min offset h, min offset w) of a warpgroup's halo: the input
        pixels the taps of an 8x8 patch of outputs read."""
        if not self.taps:
            return 1, 1, 0, 0
        dh = [t[1] for t in self.taps]
        dw = [t[2] for t in self.taps]
        return ((PATCH - 1) * cstride + max(dh) - min(dh) + 1,
                (PATCH - 1) * cstride + max(dw) - min(dw) + 1, min(dh), min(dw))


@dataclass(frozen=True)
class QconvPlan:
    n: int
    h: int
    w: int
    cin: int
    cout: int
    kh: int
    kw: int
    stride: int
    lo: int
    hi: int
    dilation: int
    reflect: bool
    ho: int
    wo: int
    period: int
    cstride: int
    classes: tuple[ConvClass, ...]
    mode: str
    bm: int
    bn: int
    splits: int
    slots: int
    group: int

    @property
    def m_tiles(self) -> int:
        return sum(c.m_tiles for c in self.classes)

    @property
    def n_tiles(self) -> int:
        return -(-self.cout // self.bn)

    @property
    def grid(self) -> tuple[int, int, int]:
        """The launch grid: (M tiles of every class x N tiles, 1, splits)."""
        return (self.m_tiles * self.n_tiles, 1, self.splits)

    @property
    def halo_pixels(self) -> int:
        """Pixels of the largest class's halo (halo mode), else 0."""
        if self.mode != "halo":
            return 0
        return max(hh * hw for hh, hw, _, _ in (c.halo(self.cstride) for c in self.classes))

    @property
    def smem(self) -> int:
        return smem_bytes(self.bm, self.bn, self.slots, self.halo_pixels, self.cin, self.group)

    @property
    def workspace_ints(self) -> int:
        """int32 partial sums of split-K: one BM x BN tile an output tile, zero between launches."""
        return self.m_tiles * self.n_tiles * self.bm * self.bn if self.splits > 1 else 0

    @property
    def counters(self) -> int:
        """Arrival counters of split-K, one an output tile, zero between launches."""
        return self.m_tiles * self.n_tiles if self.splits > 1 else 0

    @property
    def macs(self) -> int:
        """Products the kernel forms that are not on an inserted zero (tail zero-fill
        not counted): every class's outputs times its taps times C_in x C_out."""
        return sum(self.n * c.nh * c.nw * len(c.taps) for c in self.classes) * self.cin * self.cout

    def describe(self) -> dict:
        """What a log line records of the plan."""
        return {"mode": self.mode, "tile": [self.bm, self.bn], "group": self.group,
                "slots": self.slots, "splits": self.splits, "classes": len(self.classes),
                "taps": [len(c.taps) for c in self.classes],
                "k_steps": [c.steps for c in self.classes], "grid": list(self.grid),
                "smem": self.smem}

    def args(self) -> list[int]:
        """The host ints ``ast_qconv`` reads (layout above it in ``csrc/qconv.cu``)."""
        tiles_mul, tiles_shr = fast_divisor(self.n_tiles)
        return [self.n, self.h, self.w, self.cin, self.cout, self.kh * self.kw * self.cin,
                self.ho, self.wo, self.period, self.cstride, int(self.reflect), self.splits,
                len(self.classes), self.m_tiles, self.n_tiles, self.bm, self.bn,
                sum(len(c.taps) for c in self.classes), self.slots,
                _as_int32(tiles_mul), tiles_shr, int(self.mode == "halo"),
                halo_bytes(self.bm, self.cin, self.halo_pixels) if self.mode == "halo" else 0,
                self.halo_pixels, self.group, 0]

    def table(self) -> list[int]:
        """The class and tap table the kernel reads from device memory: MAX_CLASSES
        classes of CLASS_INTS (the ``ClassField`` order of ``csrc/qconv.cu``), then
        MAX_TAPS taps of [weight tap, input offset h, input offset w]; int32, a
        divisor's multiplier as its bits."""
        classes = [0] * (CLASS_INTS * MAX_CLASSES)
        taps = [0] * (3 * MAX_TAPS)
        t0 = 0
        for i, c in enumerate(self.classes):
            hh, hw, min_dh, min_dw = c.halo(self.cstride)
            pch, pcw = -(-c.nh // PATCH), -(-c.nw // PATCH)
            divisors = [fast_divisor(d) for d in (c.nh * c.nw, c.nw, pch * pcw, pcw, hw)]
            classes[CLASS_INTS * i:CLASS_INTS * (i + 1)] = [
                c.tile0, c.nh, c.nw, c.ph, c.pw, t0, len(c.taps), c.steps,
                *(v for mul, shr in divisors[:2] for v in (_as_int32(mul), shr)),
                hh, hw, (hw + 1) // 2 if self.cstride == 2 else 0, min_dh, min_dw, pcw,
                *(v for mul, shr in divisors[2:] for v in (_as_int32(mul), shr))]
            for j, tap in enumerate(c.taps):
                taps[3 * (t0 + j):3 * (t0 + j + 1)] = tap
            t0 += len(c.taps)
        return classes + taps


def _as_int32(u: int) -> int:
    """An unsigned 32-bit value as the int32 with its bits."""
    return u - (1 << 32) if u >= 1 << 31 else u


def split_range(steps: int, splits: int, split: int) -> tuple[int, int]:
    """The K steps ``[begin, end)`` of split ``split`` of a class with ``steps`` steps."""
    return split * steps // splits, (split + 1) * steps // splits


def class_steps(mode: str, taps: int, cin: int) -> int:
    """K steps of a class: gather, K_STEP bytes of (tap, C_in) each; halo, one tap of
    one slice each."""
    if mode == "halo":
        return -(-cin // K_STEP) * taps
    return -(-(taps * cin) // K_STEP)


def halo_allowed(raw, cstride: int, cin: int, slots: int, group: int) -> bool:
    """Halo mode needs stride 1 or 2, whole slices (C_in 32, 64 or a multiple of 128),
    and, where C_in has several slices (two halo buffers), a slice's taps at least
    group * (slots + 1) units long, so that a buffer is refilled only after every
    warpgroup's MMA of the slice before it is done (the load of a stage runs
    slots - 2 stages ahead of its MMA, and a slice may start inside a stage)."""
    if cstride > 2 or (cin not in (32, 64) and cin % K_STEP):
        return False
    taps = [len(c.taps) for c in raw if c.taps]
    return cin <= K_STEP or min(taps, default=0) >= group * (slots + 1)


# Cost model of one launch on the H100, in ns. Each SM is held by the largest of
# its tensor-core work, its gathers from L2 into shared memory, and the latency
# chains of its blocks (resident blocks overlap theirs): a stage's chain is its MMA
# or its share of a gather's latency, whichever is longer, plus the barrier and
# fences every stage pays. Rates fitted to bench_qconv.py --sweep on the card
# (PERF.md).
_MMA_PER_NS = 7500.0  # int8 MACs an SM: 1979 TOPS / 2 / 132 SMs
_L2_PER_NS = 64.0  # bytes an SM gathers a ns
_STORE_PER_NS = 4.0  # output bytes an SM writes a ns
_LOAD_NS = 600.0  # latency of a stage's gather
_SYNC_NS = 1000.0  # a stage's barrier, proxy fence, cp.async and wgmma waits
_BLOCK_NS = 2000.0  # a block's fixed chain: set-up, first gather, epilogue, stores
_HALO_NS = 2000.0  # halo mode: a slice's halo copy, which no earlier stage hides


def _cost(raw, cin: int, cout: int, n: int, cstride: int, mode: str, bm: int, bn: int,
          splits: int, slots: int, group: int, out_bytes: int) -> float:
    hp = max(hh * hw for hh, hw, _, _ in (c.halo(cstride) for c in raw)) if mode == "halo" else 0
    res = blocks_per_sm(bm, bn, smem_bytes(bm, bn, slots, hp, cin, group))
    n_tiles = -(-cout // bn)
    depth = bm * bn * (slice_bytes(cin) if mode == "halo" else K_STEP)
    mma_ns = depth / _MMA_PER_NS  # one K unit
    blocks, throughput, chains = 0, 0.0, 0.0
    for c in raw:
        if mode == "halo":
            patches = n * -(-c.nh // PATCH) * -(-c.nw // PATCH)
            tiles = -(-patches // (bm // 64)) * n_tiles
            hh, hw, _, _ = c.halo(cstride)
            slices = -(-cin // K_STEP)
            a_bytes = (bm // 64) * hh * hw * slice_bytes(cin) * slices / splits
            b_unit = bn * slice_bytes(cin)
            fill = -(-slices // splits) * _HALO_NS
        else:
            tiles = -(-(n * c.nh * c.nw) // bm) * n_tiles
            a_bytes = 0.0
            b_unit = (bm + bn) * K_STEP
            fill = 0.0
        units = -(-class_steps(mode, len(c.taps), cin) // splits)
        stages = -(-units // group)
        l2_ns = (units * b_unit + a_bytes) / _L2_PER_NS
        out = bm * bn * (out_bytes + (8 if splits > 1 else 0)) / _STORE_PER_NS
        stage_chain = max(group * mma_ns, _LOAD_NS / max(1, slots - 2)) + _SYNC_NS
        blocks += tiles * splits
        throughput += tiles * splits * (max(units * mma_ns, l2_ns) + out)
        chains += tiles * splits * (_BLOCK_NS + fill + stages * stage_chain + out)
    per_sm = max(throughput, chains / res) / SMS
    waves = -(-blocks // (SMS * res))
    return max(per_sm, waves * chains / blocks)


def modelled_ns(plan: QconvPlan, out_bytes: int = 2) -> float:
    """The cost model's time of ``plan``, in ns (what :func:`choose_tile` ranks by)."""
    return _cost(plan.classes, plan.cin, plan.cout, plan.n, plan.cstride, plan.mode, plan.bm,
                 plan.bn, plan.splits, plan.slots, plan.group, out_bytes)


def candidates(raw, cin: int, cout: int, cstride: int):
    """Every (mode, BM, BN, splits, slots, group) the kernel takes for these classes:
    BN at most the next of the kernel's widths that holds C_out; split-K only where
    every split keeps at least 2 K units; a ring no deeper than a split has stages
    for; the shared memory within a block's."""
    for mode in MODES:
        steps = [class_steps(mode, len(c.taps), cin) for c in raw]
        hp = max(hh * hw for hh, hw, _, _ in (c.halo(cstride) for c in raw)) \
            if mode == "halo" else 0
        for bm, bn in TILES:
            if bn > max(32, 1 << (cout - 1).bit_length()):
                continue
            for splits in SPLITS:
                if splits > 1 and min((s for s in steps if s), default=0) < 2 * splits:
                    break
                per_split = -(-max(steps, default=0) // splits)
                for group in GROUPS:
                    if group > 1 and group > per_split:
                        break
                    for slots in SLOTS:
                        if slots > 3 and slots - 2 > -(-per_split // group):
                            break
                        if mode == "halo" and not halo_allowed(raw, cstride, cin, slots, group):
                            break
                        if smem_bytes(bm, bn, slots, hp, cin, group) > MAX_SMEM:
                            break
                        yield mode, bm, bn, splits, slots, group


def choose_tile(raw, cin: int, cout: int, n: int, cstride: int,
                out_bytes: int = 2) -> tuple[str, int, int, int, int, int]:
    """(mode, BM, BN, splits, slots, group) of least modelled time."""
    best = None
    for cand in candidates(raw, cin, cout, cstride):
        c = _cost(raw, cin, cout, n, cstride, *cand, out_bytes)
        if best is None or c < best[0] - 1e-9:
            best = (c, cand)
    return best[1]


def plan_qconv(x_shape, w_shape, stride: int, lo: int, hi: int, dilation: int, reflect: bool,
               tile: tuple[str, int, int, int, int, int] | None = None) -> QconvPlan:
    """The plan of K2 for NCHW ``x_shape`` and OIHW ``w_shape``; ``tile`` (mode, BM,
    BN, splits, slots, group) overrides the cost model's choice. Raises ``ValueError`` for
    what the kernel does not take (the shape checks of every call, made once a
    shape)."""
    n, cin, h, w = x_shape
    cout, wcin, kh, kw = w_shape
    if wcin != cin:
        raise ValueError(f"K2: x has C_in {cin}, w {wcin}")
    if cin % CIN_MULTIPLE:
        raise ValueError(f"K2 takes C_in a multiple of {CIN_MULTIPLE}, got {cin}")
    if cout % 2:
        raise ValueError(f"K2 stores output channels in pairs: C_out must be even, got {cout}")
    if reflect and dilation != 1:
        raise ValueError("K2 reflects only an undilated input")
    if reflect and max(lo, hi) >= min(h, w):
        raise ValueError(f"reflect pads {(lo, hi)} must be under the size {(h, w)}")
    ah = axis_plan(h, kh, stride, lo, hi, dilation)
    aw = axis_plan(w, kw, stride, lo, hi, dilation)
    ho, wo = ah.out, aw.out
    if ho < 1 or wo < 1:
        raise ValueError(f"K2: kernel {(kh, kw)} over an empty window")
    if n * ho * wo * max(cout, cin) >= 2**31 or n * h * w * cin >= 2**31:
        raise ValueError(f"K2 indexes pixels with 32-bit ints; {tuple(x_shape)} is too large")
    raw = []
    for ph, nh, taps_h in ah.phases:
        for pw, nw, taps_w in aw.phases:
            if nh and nw:
                taps = tuple((r * kw + s, oh, ow) for r, oh in taps_h for s, ow in taps_w)
                raw.append(ConvClass(ph, pw, nh, nw, taps, 0, 0, 0))
    if len(raw) > MAX_CLASSES or sum(len(c.taps) for c in raw) > MAX_TAPS:
        raise ValueError(f"K2 takes at most {MAX_CLASSES} classes and {MAX_TAPS} taps, got "
                         f"{len(raw)} and {sum(len(c.taps) for c in raw)}")
    tile = tile or choose_tile(raw, cin, cout, n, ah.stride)
    if tile not in set(candidates(raw, cin, cout, ah.stride)):
        raise ValueError(f"K2 has no tile {tile} for this conv")
    mode, bm, bn, splits, slots, group = tile
    classes, tile0 = [], 0
    for c in raw:
        if mode == "halo":
            m_tiles = -(-(n * -(-c.nh // PATCH) * -(-c.nw // PATCH)) // (bm // 64))
        else:
            m_tiles = -(-(n * c.nh * c.nw) // bm)
        classes.append(ConvClass(c.ph, c.pw, c.nh, c.nw, c.taps,
                                 class_steps(mode, len(c.taps), cin), tile0, m_tiles))
        tile0 += m_tiles
    return QconvPlan(n, h, w, cin, cout, kh, kw, stride, lo, hi, dilation, reflect, ho, wo,
                     ah.period, ah.stride, tuple(classes), mode, bm, bn, splits, slots, group)
