"""Ops of the PyTorch port held against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; the port's ops
take NCHW tensors and torch-native weights, so inputs are transposed from
the JAX package's NHWC/HWIO here. Everything runs in "highest" precision
unless a test says otherwise. Tolerances are relative to the largest
magnitude of the reference: 1e-5 for f32 convolutions and norms (f32
rounding of different summation orders), as the JAX package's own parity
tests use.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.ops import conv as tconv
from artist_style_transfer_tpu_torch.ops import gram as tgram
from artist_style_transfer_tpu_torch.ops import image as timage
from artist_style_transfer_tpu_torch.ops import norm as tnorm
from artist_style_transfer_tpu_torch.ops import pad as tpad
from artist_style_transfer_tpu_torch.ops import precision as tprec
from artist_style_transfer_tpu_torch.ops.cuda import build as tbuild
from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel as tgk
from artist_style_transfer_tpu_torch.utils import jax_params
from artist_style_transfer_tpu_torch.utils.device import resolve_device
from tests.test_torch_data import one_torch_thread  # noqa: F401


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("h,w,k,s,cin,cout", [
    (32, 40, 9, 1, 3, 8), (32, 40, 3, 2, 8, 16), (17, 23, 9, 1, 3, 4),
    (33, 47, 3, 2, 4, 4), (16, 16, 1, 1, 8, 8),
])
def test_conv2d_reflect_matches_jax(h, w, k, s, cin, cout):
    from artist_style_transfer_tpu.ops.conv import conv2d_reflect

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(conv2d_reflect(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=s))
    got = tconv.conv2d_reflect(nchw(x), jax_params._conv_w(wt), torch.from_numpy(b), stride=s)
    assert to_nhwc(got).shape == ref.shape
    assert rel_err(to_nhwc(got), ref) <= 1e-5


@pytest.mark.parametrize("k,s,op,cin,cout", [(3, 2, 1, 8, 4), (1, 1, 0, 8, 8), (3, 2, 1, 16, 8)])
def test_conv_transpose2d_matches_jax(k, s, op, cin, cout):
    """JAX stores transpose-conv weights spatially flipped; the converter
    must un-flip them (a missed flip keeps shapes and breaks values)."""
    from artist_style_transfer_tpu.ops.conv import conv_transpose2d

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 9, cin)).astype(np.float32)
    w_flipped_hwio = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(conv_transpose2d(jnp.asarray(x), jnp.asarray(w_flipped_hwio), jnp.asarray(b),
                                      stride=s, padding=k // 2, output_padding=op))
    got = tconv.conv_transpose2d(nchw(x), jax_params._convT_w(w_flipped_hwio), torch.from_numpy(b),
                                 stride=s, padding=k // 2, output_padding=op)
    assert to_nhwc(got).shape == ref.shape
    assert rel_err(to_nhwc(got), ref) <= 1e-5


@pytest.mark.parametrize("mode", ["highest", "default"])
def test_instance_norm_matches_jax(mode):
    """Two-pass variance in parity mode, one-pass otherwise, as in JAX."""
    from artist_style_transfer_tpu.ops.norm import instance_norm
    from artist_style_transfer_tpu.ops.precision import precision as jprecision

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 9, 5)) * 3 + 1).astype(np.float32)
    gamma = rng.standard_normal(5).astype(np.float32)
    beta = rng.standard_normal(5).astype(np.float32)
    with jprecision(mode):
        ref = np.asarray(instance_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    with tprec.precision(mode):
        got = tnorm.instance_norm(nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    assert rel_err(to_nhwc(got), ref) <= 1e-5


def test_reflect_pad_matches_numpy():
    x = np.arange(1 * 4 * 5 * 2, dtype=np.float32).reshape(1, 4, 5, 2)
    got = to_nhwc(tpad.reflect_pad_hw(nchw(x), 2))
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="reflect"))
    t = nchw(x)
    assert tpad.reflect_pad_hw(t, 0) is t


def test_vgg_caffe_preprocess_matches_jax():
    from artist_style_transfer_tpu.ops.image import bgr_to_rgb, vgg_caffe_preprocess

    x = np.random.default_rng(3).uniform(0, 255, (2, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        timage.vgg_caffe_preprocess(torch.from_numpy(x)).numpy(),
        np.asarray(vgg_caffe_preprocess(jnp.asarray(x))),
    )
    np.testing.assert_array_equal(
        timage.bgr_to_rgb(torch.from_numpy(x)).numpy(), np.asarray(bgr_to_rgb(jnp.asarray(x)))
    )


@pytest.mark.parametrize("shape", [(3, 6, 7, 4), (2, 16, 16, 64), (1, 5, 3, 130)])
def test_gram_plain_matches_xla(shape):
    from artist_style_transfer_tpu.ops.gram import gram_matrix_xla

    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tgram.gram_matrix_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(gram_matrix_xla(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_gram_plain_matches_pallas_interpret():
    """The TPU kernel, run in Pallas interpret mode, against the plain version."""
    from jax.experimental.pallas import tpu as pltpu

    from artist_style_transfer_tpu.ops.pallas.gram_kernel import gram_matrix_pallas

    x = np.random.default_rng(2).standard_normal((2, 16, 16, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(gram_matrix_pallas(jnp.asarray(x)))
    got = tgram.gram_matrix_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_gram_function_backward_matches_jax_vjp():
    from artist_style_transfer_tpu.ops.gram import _gram_xla_diff

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    dg = rng.standard_normal((2, 8, 8)).astype(np.float32)
    g_ref, vjp = jax.vjp(_gram_xla_diff, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(dg))

    xt = torch.from_numpy(x).requires_grad_(True)
    g = tgram.gram_matrix(xt)  # "auto" on a CPU tensor: the plain forward
    g.backward(torch.from_numpy(dg))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)
    assert rel_err(xt.grad.numpy(), np.asarray(dx_ref)) <= 1e-5


def test_use_kernel_dispatch_on_cpu():
    x = torch.zeros(1, 4, 4, 8)
    assert tgram.resolve_use_kernel(x, "auto") is False
    assert tgram.resolve_use_kernel(x, False) is False
    with pytest.raises(ValueError, match="CUDA"):
        tgram.gram_matrix(x, use_kernel=True)
    with pytest.raises(ValueError):
        tgram.resolve_use_kernel(x, "yes")


def test_gram_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: a CPU tensor raises, and nothing counts."""
    before = tgk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tgk.gram_matrix_cuda(torch.zeros(1, 4, 4, 8))
    assert tgk.LAUNCHES == before


GRAM_PLAN_SHAPES = [
    (1, 65536, 64), (1, 16384, 128), (1, 4096, 256), (1, 1024, 512),
    (4, 262144, 64), (4, 4096, 512), (2, 10, 3), (1, 43 * 64, 512),
]


@pytest.mark.parametrize("n,hw,c", GRAM_PLAN_SHAPES)
def test_gram_split_plan_covers_hw(n, hw, c):
    plan = tgk.gram_plan(n, hw, c, sm_count=132)
    assert plan.rows % tgk.ROWS == 0 and plan.rows >= tgk.MIN_ROWS_PER_SPLIT
    assert (plan.splits - 1) * plan.rows < hw <= plan.splits * plan.rows  # no empty split
    assert plan.splits <= tgk.MAX_SPLITS
    assert plan.tile == tgk.tile_edge(n, hw, c, 132) and plan.tile in (64, 128)
    assert plan.tile == 64 or n * len(plan.pairs) * hw >= tgk.WIDE_ROWS * 132
    cost = lambda s: -(-n * len(plan.pairs) * s // (tgk.BLOCKS_PER_SM[plan.tile] * 132)) * (
        -(-hw // s) + tgk.SPLIT_COST_ROWS)
    assert cost(plan.splits) <= 1.25 * min(cost(s) for s in range(1, tgk.MAX_SPLITS + 1))


def _device_tile_of(p: int, t: int) -> tuple[int, int]:
    """How ``gram_tile_kernel`` decodes its grid y index (csrc/gram.cu)."""
    ti, rem = 0, p
    while rem >= t - ti:
        rem -= t - ti
        ti += 1
    return ti, ti + rem


@pytest.mark.parametrize("n,hw,c", GRAM_PLAN_SHAPES + [(3, 63, 130), (1, 256, 200), (2, 9, 64)])
def test_gram_plan_covers_every_entry_once(n, hw, c):
    """Upper-triangle tiles only; each G entry directly or by its mirror, exactly
    once; each HW row in exactly one non-empty split; the launch order is the
    kernel's decode order."""
    plan = tgk.gram_plan(n, hw, c, sm_count=132)
    e = plan.tile
    t = -(-c // e)
    assert len(plan.pairs) == t * (t + 1) // 2
    assert [_device_tile_of(p, t) for p in range(len(plan.pairs))] == list(plan.pairs)
    covered = np.zeros((t * e, t * e), np.int64)
    for ti, tj in plan.pairs:
        assert ti <= tj
        rows, cols = slice(ti * e, (ti + 1) * e), slice(tj * e, (tj + 1) * e)
        covered[rows, cols] += 1
        if ti != tj:
            covered[cols, rows] += 1  # the mirror store
    assert (covered[:c, :c] == 1).all()
    hits = np.zeros(hw, np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.rows, min(hw, (s + 1) * plan.rows)
        assert lo < hi
        hits[lo:hi] += 1
    assert (hits == 1).all()


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the CPU: round the 13 low mantissa bits to nearest, ties away."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _gram_tf32_passes(f: np.ndarray, passes: int) -> np.ndarray:
    """F^T F from TF32 operands, as the kernel forms it: big = tf32(a),
    small = tf32(a - big); 3 passes add small*big + big*small to big*big."""
    big = _tf32(f)
    small = _tf32(f - big)
    b, s = big.astype(np.float64), small.astype(np.float64)
    g = b.T @ b
    return g + b.T @ s + s.T @ b if passes == 3 else g


def _gram_inputs(kind: str, hw: int, c: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "uniform":
        return rng.random((hw, c), dtype=np.float32)
    # A flat feature map (a sky, a wall): one level per channel and little
    # else, so every row's TF32 rounding error has the same sign.
    level = rng.uniform(0.5, 2.0, c)
    return (level + 1e-5 * rng.standard_normal((hw, c))).astype(np.float32)


@pytest.mark.parametrize("hw,c", [(4096, 256), (65536, 64)])
@pytest.mark.parametrize("kind", ["uniform", "flat"])
def test_gram_3xtf32_is_f32_accurate(hw, c, kind):
    f = _gram_inputs(kind, hw, c)
    g64 = f.astype(np.float64).T @ f.astype(np.float64)
    assert np.abs(_gram_tf32_passes(f, 3) - g64).max() / np.abs(g64).max() <= 2e-6


@pytest.mark.parametrize("hw,c", [(4096, 256), (65536, 64)])
def test_gram_single_tf32_pass_is_not_f32_accurate(hw, c):
    """Why the kernel runs three passes: one TF32 pass is 1e-4 off f64 on a flat map."""
    f = _gram_inputs("flat", hw, c)
    g64 = f.astype(np.float64).T @ f.astype(np.float64)
    assert np.abs(_gram_tf32_passes(f, 1) - g64).max() / np.abs(g64).max() > 1e-4


def test_build_needs_nvcc():
    """Without the CUDA toolkit the build raises instead of falling back."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    if shutil.which("nvcc") or CUDA_HOME:
        pytest.skip("nvcc present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc"):
        tbuild.build()
    assert len(tbuild.source_hash()) == 64
    assert [p.name for p in tbuild._sources()] == ["gram.cu", "in_q8.cu", "qconv.cu"]


def test_precision_sets_tf32_flags():
    assert tprec.get_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with tprec.precision("default"):
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        tprec.set_precision("fast")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_build_runs_one_nvcc_a_source_then_links(tmp_path, monkeypatch):
    """A stand-in nvcc records its calls: every source compiles in its own process
    (``-c``), the objects link into one library (``-shared``), the stamp is written,
    and a failing compile raises with its command."""
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'case "$*" in *broken*) echo "error: broken"; exit 2;; esac\n'
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; shift; done\n'
        'echo "ptxas info    : Used 8 registers"\n'
    )
    fake.chmod(0o755)
    monkeypatch.setattr(tbuild, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    lib = tbuild.build()
    assert lib == tmp_path / "build" / tbuild.LIB_NAME and lib.exists()
    assert (tmp_path / "build" / (tbuild.LIB_NAME + ".sha256")).read_text().strip() == \
        tbuild.source_hash()
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in ln]
    assert len(compiles) == len(tbuild._sources()) == 3
    # The compiles run at once, so they may log in any order.
    assert sorted(ln.split()[-1].split("/")[-1] for ln in compiles) == [
        "gram.cu", "in_q8.cu", "qconv.cu"]
    assert lines[-1].count(".o") == 3 and "-shared" in lines[-1]
    assert tbuild.last_build["built"] and "ptxas info" in tbuild.last_build["log"]
    assert tbuild.build() == lib and not tbuild.last_build["built"]  # up to date: no nvcc
    assert len(calls.read_text().splitlines()) == 4
    monkeypatch.setattr(tbuild, "source_hash", lambda: "changed")
    monkeypatch.setattr(tbuild, "NVCC_FLAGS", (*tbuild.NVCC_FLAGS, "-Dbroken"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tbuild.build()
