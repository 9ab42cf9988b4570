"""One image's rows spread over a mesh's ranks: the halo exchanges and the statistics
that ``stylize_spatial`` and ``stylize_spatial_int8`` need (the port of what GSPMD
inserts for JAX's ``P(None, "data")`` sharding, ``infer/stylize.py:122-197``), and
their backward, for training and evaluation over a ('data', 'space') mesh (JAX's
``P("data", "space")``, ``parallel/mesh.py:41-48``), where the mesh here is the
'space' line of that mesh.

:class:`RowBands` says which rows of a tensor of global height ``height`` each
rank holds: rank r holds rows ``[starts[r], starts[r+1])``, the rows split as
evenly as they go (the first ``height % n`` ranks one more). Every layer's output
is split anew the same way, so the bands at half and quarter resolution may be
uneven, and a rank may hold fewer rows than a conv's halo, or none.

A conv over a band (:func:`conv_rows`, :func:`conv_transpose_rows`) first fetches
the rows of the other ranks that its receptive field reads, by one ``all_gather``
of every rank's boundary strips (its first and last ``halo`` rows; a collective
that NCCL and gloo both take on CUDA tensors, where gloo's ``send``/``recv`` take
none), then runs the caller's conv on the gathered rows:

- a reflect-padded conv gathers exactly the rows each output row reads, with the
  reflection applied at the image's top and bottom only, and the caller pads W
  alone;
- a zero-padded conv (the VGG16's) gathers the same rows, with rows of zeros
  for the pad at the image's top and bottom;
- a zero-padded transpose conv (lhs-dilated) runs on its band plus the input rows
  its output rows reach, with the single-device pads, and the output rows that
  belong to this rank are cropped out;
- a 2x2 max pool (:func:`pool_rows`) gathers the row pairs of its output band, and
  the ResNet-50 stem's 3x3 stride-2 pool (:func:`max_pool_rows`) the rows of its
  windows, with rows of the dtype's lowest value for the pad at the image's top and
  bottom (pad mode "lowest": a max pool pads with -inf, not zeros).

:func:`row_mean` and :func:`instance_norm_rows` all-reduce per-image, per-channel
sums over every rank's own rows (halo rows never count), and :func:`row_max` takes
the per-image, per-channel max the same way; :func:`row_sum` sums a loss's terms over
the bands, :func:`int_sum_over_ranks` an int32 partial product;
:func:`group_norm_rows` is the UNet's GroupNorm with the whole image's statistics.
:func:`center_crop_rows` keeps each band's share of a crop's rows (its output bands
need not be an even split: a conv reads its rows from any split and writes the even
one); :func:`all_rows_grad` gives every rank the whole image (the UNet's attention
reads every position). Every collective is the mesh's;
the same code runs over NCCL and gloo.

Each of them is differentiable, and the backward of a collective depends on who
consumes its result: a fetched halo row's cotangent goes back to its owner (one
``all_gather`` of every rank's strip cotangents) and is added there; a statistic each
rank consumes for its own band (the instance norm's sums) has its cotangent summed
over the ranks; a value every rank consumes whole (a loss, the classifier head's
pooled vector) passes its cotangent through unchanged, since each rank's backward
already carries the whole loss's. So each rank's parameter gradient is the part from
its own rows, and their sum over the ranks is the whole image's. A rank whose band is
empty still runs every node the others run (:func:`zeros_from`, or the node itself
where it joins a collective of its own), so the ranks' collectives pair up, forward
and backward.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from artist_style_transfer_tpu_torch.parallel.mesh import Mesh

_WIRE_DTYPES = (torch.float32, torch.float64)  # others cross as f32, exactly


@dataclasses.dataclass(frozen=True)
class RowBands:
    """Rank r holds rows ``[starts[r], starts[r + 1])`` of a tensor of height ``height``."""

    mesh: Mesh
    height: int
    starts: tuple[int, ...]

    @classmethod
    def split(cls, mesh: Mesh, height: int) -> RowBands:
        n = mesh.size
        base, extra = divmod(height, n)
        starts = [0]
        for r in range(n):
            starts.append(starts[-1] + base + (1 if r < extra else 0))
        return cls(mesh, height, tuple(starts))

    @classmethod
    def even(cls, line: Mesh, height: int) -> RowBands:
        """:meth:`split` of a batch's rows over the one-axis mesh ``line``: a height the
        line does not divide raises ``ValueError``, as JAX's ``device_put`` of a
        row-sharded batch does."""
        if height % line.size:
            raise ValueError(f"image height {height} does not divide over the {line.size}-rank "
                             f"'{line.axis_names[0]}' line")
        return cls.split(line, height)

    def bounds(self, rank: int | None = None) -> tuple[int, int]:
        r = self.mesh.rank if rank is None else rank
        return self.starts[r], self.starts[r + 1]

    def owner(self, row: int) -> int:
        return bisect.bisect_right(self.starts, row) - 1


def _reflect(j: int, n: int) -> int:
    """Index ``j`` of a reflect-padded axis of length ``n`` (no edge repeat)."""
    if j < 0:
        return -j
    if j >= n:
        return 2 * (n - 1) - j
    return j


class _GatherRows(torch.autograd.Function):
    """:func:`gather_rows`: the forward's one ``all_gather`` of boundary strips; the
    backward sends each fetched row's cotangent back to the rank that owns it, by one
    ``all_gather`` of every rank's strip cotangents, and adds it there."""

    @staticmethod
    def forward(ctx, x, bands: RowBands, need: list[list[int]], fill: float):
        mesh, me = bands.mesh, bands.mesh.rank
        a, b = bands.bounds()
        halo = 0
        for r, rows in enumerate(need):
            if rows:
                ar, br = bands.bounds(r)
                halo = max(halo, ar - min((j for j in rows if j >= 0), default=ar),
                           max(rows) - (br - 1))
        n, c, h, w = x.shape
        m = min(halo, h)
        parts = [x]
        if halo > 0:
            strip = x.new_zeros((n, c, 2 * halo, w))
            strip[:, :, :m] = x[:, :, :m]
            strip[:, :, 2 * halo - m:] = x[:, :, h - m:]
            wire = strip if strip.dtype in _WIRE_DTYPES else strip.float()
            parts += [s.to(x.dtype) for s in mesh.all_gather(wire)]
        zero_row = h + (mesh.size * 2 * halo if halo > 0 else 0)
        if any(j < 0 for j in need[me]):
            parts.append(x.new_full((n, c, 1, w), fill))
        idx = []
        for j in need[me]:
            if j < 0:
                idx.append(zero_row)
            elif a <= j < b:
                idx.append(j - a)
            else:
                q = bands.owner(j)
                aq, bq = bands.bounds(q)
                base = h + q * 2 * halo
                idx.append(base + (j - aq if j - aq < halo else 2 * halo - (bq - j)))
        src = torch.cat(parts, dim=2) if len(parts) > 1 else x
        index = torch.as_tensor(idx, dtype=torch.long, device=x.device)
        ctx.save_for_backward(index)
        ctx.meta = (bands, halo, m, tuple(x.shape), x.dtype, src.shape[2])
        return src.index_select(2, index).contiguous(memory_format=torch.channels_last)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (index,) = ctx.saved_tensors
        bands, halo, m, (n, c, h, w), dtype, rows = ctx.meta
        mesh, me = bands.mesh, bands.mesh.rank
        acc = torch.promote_types(dy.dtype, torch.float32)  # bf16 sums in f32, crosses as f32
        dsrc = dy.new_zeros((n, c, rows, w), dtype=acc).index_add_(2, index, dy.to(acc))
        dx = dsrc[:, :, :h].clone()
        if halo > 0:
            strips = dsrc[:, :, h: h + mesh.size * 2 * halo].contiguous()
            mine = sum(t[:, :, me * 2 * halo: (me + 1) * 2 * halo]
                       for t in mesh.all_gather(strips))
            dx[:, :, :m] += mine[:, :, :m]
            dx[:, :, h - m:] += mine[:, :, 2 * halo - m:]
        return dx.to(dtype).contiguous(memory_format=torch.channels_last), None, None, None


def gather_rows(x: torch.Tensor, bands: RowBands, need: list[list[int]],
                fill: float = 0.0) -> torch.Tensor:
    """Rows ``need[me]`` (global indices, in order; -1 a row of ``fill``, a pad) of the
    NCHW tensor whose rows ``bands`` spreads, from this rank's ``x`` and its neighbours'
    boundary strips. Differentiable: each row's gradient returns to its owner.

    ``need`` lists every rank's rows (each rank computes all of them the same way),
    so every rank agrees on the strip height without a collective; a layer whose
    ranks need no row of another skips the exchange, forward and backward.
    """
    return _GatherRows.apply(x, bands, need, fill)


class _ZerosFrom(torch.autograd.Function):
    """A tensor of zeros that autograd reaches through ``src``, whose gradient is 0."""

    @staticmethod
    def forward(ctx, src, shape, dtype):
        ctx.meta = (src.shape, src.dtype)
        return src.new_zeros(shape, dtype=dtype).contiguous(
            memory_format=torch.channels_last if len(shape) == 4 else torch.contiguous_format)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        shape, dtype = ctx.meta
        return g.new_zeros(shape, dtype=dtype), None, None


def zeros_from(src: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype | None = None):
    """Zeros of ``shape`` standing for what an empty band computes from ``src``: autograd
    runs through it, so a rank's backward reaches every collective the others reach,
    in the same order, band empty or not."""
    return _ZerosFrom.apply(src, tuple(shape), dtype or src.dtype)


def _lowest(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).min


def conv_rows(x: torch.Tensor, bands: RowBands, k: int, stride: int, pad: int, conv,
              cout: int, out_dtype: torch.dtype | None = None, pad_mode: str = "reflect",
              collective: bool = False):
    """A conv of kernel ``k``, ``stride`` and pad ``pad`` (both axes; ``pad_mode``
    "reflect", the TransformerNet's, "zeros", the VGG16's and the ResNet-50's, or
    "lowest", a max pool's) over the image whose rows ``bands`` spreads. ``conv(rows)``
    runs it on the gathered rows (the H pad already in them; it pads W by ``pad``
    itself and no H). ``collective``: ``conv`` joins collectives of its own (an int8
    conv's dynamic scales), so it runs on an empty band too and returns its empty
    output. Returns this rank's output band and the output's :class:`RowBands`."""
    if pad_mode not in ("reflect", "zeros", "lowest"):
        raise ValueError(f"pad_mode must be 'reflect', 'zeros' or 'lowest', got {pad_mode!r}")
    h_in = bands.height
    h_out = (h_in + 2 * pad - k) // stride + 1
    out = RowBands.split(bands.mesh, h_out)

    def row(q: int) -> int:
        if pad_mode == "reflect":
            return _reflect(q, h_in)
        return q if 0 <= q < h_in else -1

    need = []
    for r in range(bands.mesh.size):
        oa, ob = out.bounds(r)
        need.append([row(q - pad) for q in range(oa * stride, (ob - 1) * stride + k)]
                    if ob > oa else [])
    rows = gather_rows(x, bands, need, _lowest(x.dtype) if pad_mode == "lowest" else 0.0)
    oa, ob = out.bounds()
    if ob == oa and not collective:
        w_out = (x.shape[3] + 2 * pad - k) // stride + 1
        return zeros_from(rows, (x.shape[0], cout, 0, w_out), out_dtype or x.dtype), out
    return conv(rows), out


def conv_transpose_rows(x: torch.Tensor, bands: RowBands, k: int, dilation: int,
                        lo: int, hi: int, conv, cout: int, out_dtype: torch.dtype | None = None,
                        collective: bool = False):
    """A stride-1 conv of kernel ``k`` over the input lhs-dilated by ``dilation`` and
    zero-padded by ``(lo, hi)`` (a transpose conv's form) over the image whose rows
    ``bands`` spreads. ``conv(rows)`` runs the single-device op on a contiguous run of
    input rows; the output rows of this rank are cropped from its result.
    ``collective`` as for :func:`conv_rows`. Returns this rank's output band and the
    output's :class:`RowBands`."""
    d, h_in = dilation, bands.height
    if hi < d - 1:
        raise ValueError(f"a banded transpose conv needs hi >= dilation - 1, got {hi}, {d}")
    h_out = (h_in - 1) * d + 1 + lo + hi - k + 1
    out = RowBands.split(bands.mesh, h_out)
    spans, need = [], []
    for r in range(bands.mesh.size):
        oa, ob = out.bounds(r)
        ia = max(0, min(-(-(oa - lo) // d), oa // d))
        ib = min(h_in, (ob - 1 - lo + k - 1) // d + 1)
        spans.append(ia)
        need.append(list(range(ia, ib)) if ob > oa and ib > ia else [])
    rows = gather_rows(x, bands, need)
    oa, ob = out.bounds()
    w_out = (x.shape[3] - 1) * d + 1 + lo + hi - k + 1
    if ob == oa and not collective:
        return zeros_from(rows, (x.shape[0], cout, 0, w_out), out_dtype or x.dtype), out
    y = conv(rows)
    first = spans[bands.mesh.rank] * d
    return y[:, :, oa - first: ob - first], out


def pool_rows(x: torch.Tensor, bands: RowBands) -> tuple[torch.Tensor, RowBands]:
    """The 2x2 stride-2 max pool (floor mode) of the NCHW image whose rows ``bands``
    spreads: the output is split anew, so a pair of rows may straddle two bands (at
    H = 40 over 2 ranks, relu3_3's bands [0, 5) and [5, 10) pool into [0, 3) and
    [3, 5), and rank 0 fetches row 5). Returns this rank's output band and its
    :class:`RowBands`."""
    out = RowBands.split(bands.mesh, bands.height // 2)
    need = []
    for r in range(bands.mesh.size):
        oa, ob = out.bounds(r)
        need.append(list(range(2 * oa, 2 * ob)))
    rows = gather_rows(x, bands, need)
    oa, ob = out.bounds()
    if ob == oa:
        return zeros_from(rows, (x.shape[0], x.shape[1], 0, x.shape[3] // 2)), out
    return F.max_pool2d(rows, 2, 2), out


def max_pool_rows(x: torch.Tensor, bands: RowBands) -> tuple[torch.Tensor, RowBands]:
    """``F.max_pool2d(x, 3, 2, 1)`` (the ResNet-50 stem's pool) of the NCHW image whose
    rows ``bands`` spreads: the rows of each output band's windows are gathered as a
    conv's, with rows of the dtype's lowest value for the pad at the image's top and
    bottom, and W is padded by the pool itself (with -inf). Returns this rank's output
    band and its :class:`RowBands`."""
    def pool(t):
        return F.max_pool2d(t, 3, 2, (0, 1))

    return conv_rows(x, bands, 3, 2, 1, pool, x.shape[1], pad_mode="lowest")


def on_band(x: torch.Tensor, fn, cout: int) -> torch.Tensor:
    """``fn(x)`` of a band-local op that keeps H and W (a 1x1 conv), or zeros standing for
    it where this rank's band is empty (a conv refuses an empty input)."""
    if x.shape[2] == 0:
        return zeros_from(x, (x.shape[0], cout, 0, x.shape[3]))
    return fn(x)


class _SumOverRanks(torch.autograd.Function):
    """``t`` summed over the mesh's ranks. ``replicated``: what consumes the sum is the
    same on every rank (a loss every rank holds whole), so each rank's cotangent is the
    whole one and the backward is the identity; else each rank consumes it for its own
    band, and the backward sums the cotangents over the ranks too."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh, replicated: bool):
        ctx.mesh, ctx.replicated = mesh, replicated
        return mesh.all_reduce_(t.clone())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.replicated:
            return g, None, None
        return ctx.mesh.all_reduce_(g.clone()), None, None


def sum_over_ranks(t: torch.Tensor, mesh: Mesh, replicated: bool = False) -> torch.Tensor:
    """``t`` summed over ``mesh``'s ranks, differentiable (:class:`_SumOverRanks`)."""
    return _SumOverRanks.apply(t, mesh, replicated)


def row_sum(t: torch.Tensor, bands: RowBands) -> torch.Tensor:
    """The sum of every element of the tensor whose rows ``bands`` spreads, in f32 (f64
    for f64): this rank's band's sum, summed over the ranks, for a loss every rank then
    holds whole (the backward is the identity on each rank's band)."""
    return sum_over_ranks(t.to(torch.promote_types(t.dtype, torch.float32)).sum(),
                          bands.mesh, replicated=True)


def row_mean(t: torch.Tensor, bands: RowBands, replicated: bool = False) -> torch.Tensor:
    """Per-image, per-channel mean over H and W of the NCHW image whose rows ``bands``
    spreads: this rank's sums over its own rows, all-reduced, over the global count.
    Shape (N, C, 1, 1), in ``t``'s dtype; differentiable. Its backward all-reduces the
    cotangent over the ranks where each rank's band consumes the mean (an instance
    norm); ``replicated``: every rank consumes it whole (the classifier head's pool,
    whose loss every rank holds), and the cotangent passes through. The sums run in f32
    (f64 for f64)."""
    acc = torch.promote_types(t.dtype, torch.float32)
    s = sum_over_ranks(t.to(acc).sum(dim=(2, 3)), bands.mesh, replicated)
    return (s / float(bands.height * t.shape[3])).to(t.dtype)[:, :, None, None]


class _RowMax(torch.autograd.Function):
    """:func:`row_max`: the forward's all-reduce MAX of each rank's per-image, per-channel
    max over its rows; the backward splits the cotangent evenly among the positions that
    tie for the max over every rank (an all-reduce SUM of each rank's tie counts), as
    ``amax`` and ``jnp.max`` split it. The cotangent is the whole one on every rank (the
    pooled vector's consumer is replicated), so it is not summed."""

    @staticmethod
    def forward(ctx, x, bands: RowBands):
        n, c, h, _ = x.shape
        wire = torch.promote_types(x.dtype, torch.float32)  # exact for bf16
        local = (x.amax(dim=(2, 3)).to(wire) if h else
                 x.new_full((n, c), _lowest(x.dtype), dtype=wire))
        m = bands.mesh.all_reduce_(local, "max").to(x.dtype)
        ctx.save_for_backward(x, m)
        ctx.mesh = bands.mesh
        return m

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        tied = x == m[:, :, None, None]
        wire = torch.promote_types(x.dtype, torch.float32)
        count = ctx.mesh.all_reduce_(tied.sum(dim=(2, 3)).to(wire))
        dx = (g.to(wire) / count).to(g.dtype)[:, :, None, None] * tied
        return dx.to(x.dtype).contiguous(memory_format=torch.channels_last), None


def row_max(t: torch.Tensor, bands: RowBands) -> torch.Tensor:
    """Per-image, per-channel max over H and W (``amax(dim=(2, 3))``, (N, C)) of the NCHW
    image whose rows ``bands`` spreads, the same on every rank, for a consumer every
    rank runs whole (:class:`_RowMax`). An empty band adds the dtype's lowest value and
    no tie, and joins both collectives."""
    return _RowMax.apply(t, bands)


def int_sum_over_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """An int32 ``t`` summed over ``mesh``'s ranks, exactly (gloo and NCCL both reduce
    int32): the int8 Gram's partial products. Not differentiable; the caller's autograd
    function owns the backward."""
    if t.dtype != torch.int32:
        raise ValueError(f"int_sum_over_ranks sums int32, got {t.dtype}")
    return mesh.all_reduce_(t.clone())


def all_rows(y: torch.Tensor, bands: RowBands, dim: int) -> torch.Tensor:
    """The whole image on every rank: each rank's band of ``y`` along ``dim`` (rows),
    all-gathered in rank order."""
    most = max(bands.starts[r + 1] - bands.starts[r] for r in range(bands.mesh.size))
    a, b = bands.bounds()
    pad = list(y.shape)
    pad[dim] = most - (b - a)
    padded = torch.cat([y, y.new_zeros(pad)], dim=dim) if pad[dim] else y
    wire = padded if padded.dtype in _WIRE_DTYPES else padded.float()
    parts = bands.mesh.all_gather(wire.contiguous())
    return torch.cat([p.narrow(dim, 0, bands.starts[r + 1] - bands.starts[r]).to(y.dtype)
                      for r, p in enumerate(parts)], dim=dim)


class _InstanceNormRows(torch.autograd.Function):
    """:func:`ops.norm.instance_norm_act` over a band, with the whole image's statistics:
    the forward all-reduces the per-image, per-channel sums (the mean, then the centred
    squares under ``"highest"``; the sums of x and x^2 otherwise), the backward the two
    channel sums of its input gradient (of g and of g * x-hat). gamma and beta get this
    rank's part of their gradient, which the trainer's gradient sum completes."""

    @staticmethod
    def forward(ctx, x, bands: RowBands, scale, bias, relu: bool, eps: float):
        from artist_style_transfer_tpu_torch.ops.norm import _stats_dtype
        from artist_style_transfer_tpu_torch.ops.precision import get_precision

        mesh, c = bands.mesh, x.shape[1]
        count = float(bands.height * x.shape[3])
        x32 = x.to(_stats_dtype(x))
        def mean_of(t):  # the whole image's per-image, per-channel mean
            return (mesh.all_reduce_(t.sum(dim=(2, 3))) / count)[:, :, None, None]

        if get_precision() == "highest":
            mean = mean_of(x32)
            var = mean_of((x32 - mean).square())
        else:
            both = mean_of(torch.cat([x32, x32.square()], dim=1))
            mean, m2 = both[:, :c], both[:, c:]
            var = (m2 - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        y = ((x32 - mean) * inv).to(x.dtype) * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
        ctx.save_for_backward(x, mean, inv, scale, bias)
        ctx.bands, ctx.relu, ctx.count = bands, relu, count
        return torch.relu(y) if relu else y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, mean, inv, scale, bias = ctx.saved_tensors
        acc, c = mean.dtype, x.shape[1]
        xhat = (x.to(acc) - mean) * inv
        dya = dy.to(acc)
        if ctx.relu:
            pre = xhat * scale.to(acc).view(1, -1, 1, 1) + bias.to(acc).view(1, -1, 1, 1)
            dya = torch.where(pre > 0, dya, 0.0)
        dgamma = (dya * xhat).sum(dim=(0, 2, 3)).to(scale.dtype)
        dbeta = dya.sum(dim=(0, 2, 3)).to(bias.dtype)
        g = dya * scale.to(acc).view(1, -1, 1, 1)
        sums = torch.cat([g.sum(dim=(2, 3)), (g * xhat).sum(dim=(2, 3))], dim=1)
        m = ctx.bands.mesh.all_reduce_(sums) / ctx.count
        dx = (inv * (g - m[:, :c, None, None] - xhat * m[:, c:, None, None])).to(x.dtype)
        return (dx.contiguous(memory_format=torch.channels_last), None, dgamma, dbeta,
                None, None)


def instance_norm_rows(x: torch.Tensor, bands: RowBands, scale: torch.Tensor,
                       bias: torch.Tensor, relu: bool, eps: float) -> torch.Tensor:
    """:func:`ops.norm.instance_norm_act` over the image whose rows ``bands`` spreads,
    with the statistics of the whole image: its arithmetic (f32 statistics; the
    two-pass variance under ``"highest"``, the one-pass one otherwise), each sum
    all-reduced over every rank's own rows, forward and backward
    (:class:`_InstanceNormRows`)."""
    return _InstanceNormRows.apply(x, bands, scale, bias, relu, eps)


def center_crop_rows(x: torch.Tensor, bands: RowBands, size: int) -> tuple[torch.Tensor,
                                                                           RowBands]:
    """:func:`ops.image.center_crop` of the NHWC image whose rows (axis 1) ``bands``
    spreads: each rank keeps the crop's rows that lie in its band, so the output's
    :class:`RowBands` start where the crop cuts the input's bands, and a band wholly
    outside the crop is empty. W is cropped on every band; the rows of zeros that pad
    an image lower than ``size`` go to the first rank (above) and the last (below).
    Returns this rank's output band and the output's bands. No exchange."""
    h, n = bands.height, bands.mesh.size
    pad_h = max(size - h, 0)
    top = -(pad_h - pad_h // 2) if pad_h else (h - size) // 2
    starts = [0] + [min(max(bands.starts[r] - top, 0), size) for r in range(1, n)] + [size]
    out = RowBands(bands.mesh, size, tuple(starts))
    a, b = bands.bounds()
    oa, ob = out.bounds()
    idx = [j - a if a <= j < b else x.shape[1] for j in range(oa + top, ob + top)]
    rows = torch.cat([x, x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:]))], dim=1)
    y = rows.index_select(1, torch.as_tensor(idx, dtype=torch.long, device=x.device))
    w = y.shape[2]
    pad_w = max(size - w, 0)
    if pad_w:
        y = F.pad(y, (0, 0, pad_w - pad_w // 2, pad_w // 2))
    return y.narrow(2, (y.shape[2] - size) // 2, size), out


class _AllRowsGrad(torch.autograd.Function):
    """:func:`all_rows_grad`: the forward's :func:`all_rows`; the backward sums the
    whole cotangent over the ranks (each rank's consumer read every row) and keeps this
    rank's band of it, so each row's cotangent returns to its owner."""

    @staticmethod
    def forward(ctx, y, bands: RowBands, dim: int):
        ctx.bands, ctx.dim, ctx.dtype = bands, dim, y.dtype
        return all_rows(y, bands, dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        acc = torch.promote_types(g.dtype, torch.float32)
        a, b = ctx.bands.bounds()
        whole = ctx.bands.mesh.all_reduce_(g.to(acc, copy=True).contiguous())
        return whole.narrow(ctx.dim, a, b - a).to(ctx.dtype), None, None


def all_rows_grad(y: torch.Tensor, bands: RowBands, dim: int) -> torch.Tensor:
    """:func:`all_rows`, differentiable: the whole image on every rank, for a consumer
    on each rank that reads every row (the UNet's attention reads every position's key
    and value), whose cotangents each row's owner sums (:class:`_AllRowsGrad`)."""
    return _AllRowsGrad.apply(y, bands, dim)


class _GroupNormRows(torch.autograd.Function):
    """:func:`group_norm_rows`: the forward all-reduces each (image, group)'s sum over
    every rank's own rows, then its centred squares (JAX's two-pass variance); the
    backward the two group sums of its input gradient (of g and of g * x-hat), in one
    call. gamma and beta get this rank's part of their gradient, which the trainer's
    gradient sum completes."""

    @staticmethod
    def forward(ctx, x, bands: RowBands, gamma, beta, groups: int, eps: float):
        from artist_style_transfer_tpu_torch.ops.norm import _stats_dtype

        n, c, h, w = x.shape
        g = min(groups, c)
        count = float(c // g * bands.height * w)
        xg = x.to(_stats_dtype(x)).reshape(n, g, c // g, h, w)
        mesh = bands.mesh
        mean = (mesh.all_reduce_(xg.sum(dim=(2, 3, 4))) / count)[:, :, None, None, None]
        xc = xg - mean
        var = mesh.all_reduce_(xc.square().sum(dim=(2, 3, 4))) / count
        inv = torch.rsqrt(var + eps)[:, :, None, None, None]
        xhat = (xc * inv).reshape(n, c, h, w)
        y = (xhat * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)).to(x.dtype)
        ctx.save_for_backward(xhat, inv, gamma)
        ctx.bands, ctx.g, ctx.count, ctx.dtypes = bands, g, count, (x.dtype, gamma.dtype,
                                                                    beta.dtype)
        return y.contiguous(memory_format=torch.channels_last)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xhat, inv, gamma = ctx.saved_tensors
        x_dtype, g_dtype, b_dtype = ctx.dtypes
        n, c, h, w = xhat.shape
        g = ctx.g
        dya = dy.to(xhat.dtype)
        dgamma = (dya * xhat).sum(dim=(0, 2, 3)).to(g_dtype)
        dbeta = dya.sum(dim=(0, 2, 3)).to(b_dtype)
        gg = (dya * gamma.to(xhat.dtype).view(1, -1, 1, 1)).reshape(n, g, c // g, h, w)
        xg = xhat.reshape(n, g, c // g, h, w)
        sums = torch.cat([gg.sum(dim=(2, 3, 4)), (gg * xg).sum(dim=(2, 3, 4))], dim=1)
        m = ctx.bands.mesh.all_reduce_(sums) / ctx.count
        dx = inv * (gg - m[:, :g, None, None, None] - xg * m[:, g:, None, None, None])
        return (dx.reshape(n, c, h, w).to(x_dtype).contiguous(memory_format=torch.channels_last),
                None, dgamma, dbeta, None, None)


def group_norm_rows(x: torch.Tensor, bands: RowBands, gamma: torch.Tensor,
                    beta: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over ``min(groups, C)`` groups of consecutive channels of the NCHW image
    whose rows ``bands`` spreads, with the whole image's statistics (f32, the two-pass
    biased variance), each sum all-reduced over every rank's own rows, forward and
    backward (:class:`_GroupNormRows`)."""
    return _GroupNormRows.apply(x, bands, gamma, beta, groups, eps)
