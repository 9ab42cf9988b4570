"""One image's rows spread over a mesh's ranks: the halo exchanges and the statistics
that ``stylize_spatial`` and ``stylize_spatial_int8`` need (the port of what GSPMD
inserts for JAX's ``P(None, "data")`` sharding, ``infer/stylize.py:122-197``).

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
- a zero-padded transpose conv (lhs-dilated) runs on its band plus the input rows
  its output rows reach, with the single-device pads, and the output rows that
  belong to this rank are cropped out.

:func:`row_mean` all-reduces per-image, per-channel sums over every rank's own
rows (halo rows never count), for the instance norms. Every collective is the
mesh's; the same code runs over NCCL and gloo.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

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


def gather_rows(x: torch.Tensor, bands: RowBands, need: list[list[int]]) -> torch.Tensor:
    """Rows ``need[me]`` (global indices, in order) of the NCHW tensor whose rows ``bands``
    spreads, from this rank's ``x`` and its neighbours' boundary strips.

    ``need`` lists every rank's rows (each rank computes all of them the same way),
    so every rank agrees on the strip height without a collective; a layer whose
    ranks need no row of another skips the exchange.
    """
    mesh, me = bands.mesh, bands.mesh.rank
    a, b = bands.bounds()
    halo = 0
    for r, rows in enumerate(need):
        if rows:
            ar, br = bands.bounds(r)
            halo = max(halo, ar - min(rows), max(rows) - (br - 1))
    idx = []
    parts = [x]
    if halo > 0:
        n, c, h, w = x.shape
        m = min(halo, h)
        strip = x.new_zeros((n, c, 2 * halo, w))
        strip[:, :, :m] = x[:, :, :m]
        strip[:, :, 2 * halo - m:] = x[:, :, h - m:]
        wire = strip if strip.dtype in _WIRE_DTYPES else strip.float()
        parts += [s.to(x.dtype) for s in mesh.all_gather(wire)]
    for j in need[me]:
        if a <= j < b:
            idx.append(j - a)
            continue
        q = bands.owner(j)
        aq, bq = bands.bounds(q)
        base = (b - a) + q * 2 * halo
        idx.append(base + (j - aq if j - aq < halo else 2 * halo - (bq - j)))
    src = torch.cat(parts, dim=2) if len(parts) > 1 else x
    out = src.index_select(2, torch.as_tensor(idx, dtype=torch.long, device=x.device))
    return out.contiguous(memory_format=torch.channels_last)


def _empty(x: torch.Tensor, cout: int, w_out: int, dtype: torch.dtype | None = None):
    return x.new_empty((x.shape[0], cout, 0, w_out), dtype=dtype or x.dtype).contiguous(
        memory_format=torch.channels_last)


def conv_rows(x: torch.Tensor, bands: RowBands, k: int, stride: int, pad: int, conv,
              cout: int, out_dtype: torch.dtype | None = None):
    """A conv of kernel ``k``, ``stride`` and reflect pad ``pad`` (both axes) over the
    image whose rows ``bands`` spreads. ``conv(rows)`` runs it on the gathered rows
    (the H reflection already in them; it pads W by ``pad`` itself and no H).
    Returns this rank's output band and the output's :class:`RowBands`."""
    h_in = bands.height
    h_out = (h_in + 2 * pad - k) // stride + 1
    out = RowBands.split(bands.mesh, h_out)
    need = []
    for r in range(bands.mesh.size):
        oa, ob = out.bounds(r)
        need.append([_reflect(q - pad, h_in) for q in range(oa * stride, (ob - 1) * stride + k)]
                    if ob > oa else [])
    rows = gather_rows(x, bands, need)
    oa, ob = out.bounds()
    if ob == oa:
        return _empty(x, cout, (x.shape[3] + 2 * pad - k) // stride + 1, out_dtype), out
    return conv(rows), out


def conv_transpose_rows(x: torch.Tensor, bands: RowBands, k: int, dilation: int,
                        lo: int, hi: int, conv, cout: int, out_dtype: torch.dtype | None = None):
    """A stride-1 conv of kernel ``k`` over the input lhs-dilated by ``dilation`` and
    zero-padded by ``(lo, hi)`` (a transpose conv's form) over the image whose rows
    ``bands`` spreads. ``conv(rows)`` runs the single-device op on a contiguous run of
    input rows; the output rows of this rank are cropped from its result. Returns
    this rank's output band and the output's :class:`RowBands`."""
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
    if ob == oa:
        return _empty(x, cout, w_out, out_dtype), out
    y = conv(rows)
    first = spans[bands.mesh.rank] * d
    return y[:, :, oa - first: ob - first], out


def row_mean(t: torch.Tensor, bands: RowBands) -> torch.Tensor:
    """Per-image, per-channel mean over H and W of the NCHW image whose rows ``bands``
    spreads: this rank's sums over its own rows, all-reduced, over the global count.
    Shape (N, C, 1, 1), in ``t``'s dtype."""
    s = t.sum(dim=(2, 3))
    bands.mesh.all_reduce_(s)
    return (s / float(bands.height * t.shape[3]))[:, :, None, None]


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


def instance_norm_rows(x: torch.Tensor, bands: RowBands, scale: torch.Tensor,
                       bias: torch.Tensor, relu: bool, eps: float) -> torch.Tensor:
    """The forward of :func:`ops.norm.instance_norm_act` over the image whose rows
    ``bands`` spreads, with the statistics of the whole image: its arithmetic (f32
    statistics; the two-pass variance under ``"highest"``, the one-pass one
    otherwise), each mean all-reduced over every rank's own rows."""
    from artist_style_transfer_tpu_torch.ops.norm import _stats_dtype
    from artist_style_transfer_tpu_torch.ops.precision import get_precision

    x32 = x.to(_stats_dtype(x))
    if get_precision() == "highest":
        mean = row_mean(x32, bands)
        var = row_mean((x32 - mean).square(), bands)
    else:
        c = x.shape[1]
        both = row_mean(torch.cat([x32, x32.square()], dim=1), bands)
        mean, m2 = both[:, :c], both[:, c:]
        var = (m2 - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    y = ((x32 - mean) * inv).to(x.dtype) * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return torch.relu(y) if relu else y
