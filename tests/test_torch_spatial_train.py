"""Training over a ('data', 'space') mesh in the PyTorch port (``parallel/spatial.py``'s
backward, ``VGG16Features.forward_rows``, ``ops.gram.gram_matrix_rows``, the banded
losses and ``train/loop.py``'s banded step) on gloo ranks on the CPU.

JAX refuses this training on the CPU (a diagnosed XLA:CPU GSPMD miscompile of the
halo'd conv weight gradients, JAX ``train/loop.py:133-160``), so its mesh run is no
gradient oracle; GSPMD's sharding does not change the math (JAX's forward loss on a
(4, 2) ('data', 'space') mesh equals its single-device loss at rtol 1e-5,
``tests/test_parallel.py:194-222``), so the port is held against JAX's single-device
step on the same global batch and against its own one process. Tolerances:

- each banded primitive (the gather of halo rows, ``row_mean``, the zero- and
  reflect-padded convs, the decoder's transpose conv, the 2x2 pool, the instance norm
  in both variance modes and the Gram) over 2 and 3 ranks, against one process's autograd on the whole image:
  outputs and input gradients within 1e-5 of the largest magnitude, parameter
  gradients summed over the ranks likewise; at H = 10 the pools' row pairs straddle
  two bands, at H = 2 over 3 ranks a band is empty, and the transpose conv at H = 1
  over 3 leaves one rank no output row;
- the banded VGG16's Gram and content losses and their input gradient, at H = 40
  over 2 ranks (relu3_3's bands [0, 5) and [5, 10) pool into [0, 3) and [3, 5)) and
  H = 24 over 4 (relu4_3's 3 rows leave one rank none), within 1e-5 of one process;
- one banded 'cycle' step on meshes (1, 2), (2, 2) and (1, 4) with every weight
  redrawn (so no near-zero init hides a gradient): the losses within rtol 1e-5 of
  JAX's single-device ``jax.value_and_grad`` of ``make_step_fns(..., mesh=None,
  use_pallas=False).loss_fn`` at the same global batch (JAX's own mesh bar), every
  parameter gradient within 1e-4 of its leaf's largest (the leaves whose exact
  gradient is 0, within 1e-4 of the net's largest), the ranks' gradients bit-identical;
- the same step in f64, on (1, 2) and (1, 4) at data and weights whose f32 step
  flips a ReLU or pool decision (in the one process as in the bands), within 1e-6 of
  the one process's (no mesh);
- ``train()`` over (1, 2) against the port's one-process ``train()``, 2 epochs: the
  per-step losses (``metrics.jsonl``) within rtol 1e-4 in the four Gram modes,
  streamed, in bf16, with ``remat`` and with a ragged tail (banded where the ranks
  divide it, else whole on each rank), the ranks bit-identical.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.parallel import launch, workers
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    conv_rows,
    conv_transpose_rows,
    gather_rows,
    instance_norm_rows,
    pool_rows,
    row_mean,
)
from artist_style_transfer_tpu_torch.utils.jax_params import (
    transformer_state_dict_from_jax,
    transformer_state_dict_to_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_train_loop import zero_grad_leaf

PRIMITIVES = ("gather", "row_mean", "conv_zeros", "conv_reflect_s2", "conv_transpose",
              "pool", "in", "in_one_pass", "gram")
HEIGHTS = {2: (10, 7), 3: (10, 2)}  # H = 10: straddling pools; H = 2 over 3: an empty band
EXTRA_HEIGHTS = {("conv_transpose", 3): (1,)}  # 2 output rows over 3 ranks: one empty


def heights(name: str, ranks: int) -> tuple[int, ...]:
    return HEIGHTS[ranks] + EXTRA_HEIGHTS.get((name, ranks), ())
N, C, W = 2, 3, 6


# --- the primitives ----------------------------------------------------------------------


def case_inputs(name: str, h: int) -> dict:
    """Seeded inputs of a primitive at height ``h``: x (NCHW), the parameters and the
    output cotangent R (for 'gather', a pool of rows each rank's cotangent is cut from)."""
    rng = np.random.default_rng([PRIMITIVES.index(name), h])
    x = rng.normal(size=(N, C, h, W)).astype(np.float32)
    p = {}
    if name.startswith("conv"):
        shape = (C, 4, 3, 3) if name == "conv_transpose" else (4, C, 3, 3)
        p["w"] = rng.normal(size=shape).astype(np.float32) / 3
        p["b"] = rng.normal(size=(4,)).astype(np.float32)
    if name.startswith("in"):
        p["scale"] = rng.uniform(0.5, 1.5, C).astype(np.float32)
        p["bias"] = rng.uniform(-0.5, 0.5, C).astype(np.float32)
    r = rng.normal(size=(N, 4, 4 * h + 8, 2 * W)).astype(np.float32)
    return {"x": x, "params": p, "R": r}


def gather_need(bands: RowBands) -> list[list[int]]:
    """Each rank's rows: a zero row, then its band widened by 2 rows each side."""
    need = []
    for r in range(bands.mesh.size):
        a, b = bands.bounds(r)
        need.append([-1] + list(range(max(0, a - 2), min(bands.height, b + 2))) if b > a else [])
    return need


def apply_primitive(name: str, x: torch.Tensor, p: dict, bands: RowBands | None):
    """The primitive on ``x`` (``bands``: banded, this rank's rows; None: the whole image)
    and the loss whose gradients the test compares: Σ y·R over this rank's output (the
    banded losses add up over the ranks), or, for the Gram, the loss every rank holds."""
    from artist_style_transfer_tpu_torch.ops import gram as gram_ops
    from artist_style_transfer_tpu_torch.ops.norm import instance_norm_act
    from artist_style_transfer_tpu_torch.ops.precision import precision

    r = torch.as_tensor(p["R"])

    def cut(y, rows):  # R's rows for an output band of ``rows``
        a, b = (0, y.shape[2]) if rows is None else rows.bounds()
        return r[:, : y.shape[1], a:b, : y.shape[3]]

    if name == "gather":
        if bands is None:  # every rank's rows from the whole image, their losses summed
            pad = torch.cat([x, x.new_zeros(x.shape[:2] + (1, x.shape[3]))], dim=2)
            h = x.shape[2]
            mesh = p["mesh"]
            whole = RowBands.split(mesh, h)
            ys = [pad[:, :, [h if j < 0 else j for j in rows]] for rows in gather_need(whole)]
            return torch.cat(ys, dim=2), sum((y * cut_rows(r, i, ys)).sum()
                                             for i, y in enumerate(ys))
        y = gather_rows(x, bands, gather_need(bands))
        lens = [len(n) for n in gather_need(bands)]
        off = sum(lens[: bands.mesh.rank])
        return y, (y * r[:, :C, off: off + y.shape[2], : W]).sum()
    if name == "row_mean":
        if bands is None:
            m = x.mean(dim=(2, 3), keepdim=True)
            return m, (x * m).sum()
        m = row_mean(x, bands)
        return m, (x * m).sum()
    if name == "conv_transpose":  # the decoder's: k 3, stride 2, pad 1, output pad 1
        w, b = p["w_t"], p["b_t"]

        def convt(t):
            return torch.nn.functional.conv_transpose2d(t, w, b, stride=2, padding=1,
                                                        output_padding=1)

        if bands is None:
            y = convt(x)
            return y, (y * cut(y, None)).sum()
        y, rows = conv_transpose_rows(x, bands, 3, 2, 1, 2, convt, 4)
        return y, (y * cut(y, rows)).sum()
    if name.startswith("conv"):
        w, b = p["w_t"], p["b_t"]
        stride, mode = (1, "zeros") if name == "conv_zeros" else (2, "reflect")
        if bands is None:
            pad = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="constant" if mode == "zeros"
                                          else "reflect")
            y = torch.nn.functional.conv2d(pad, w, b, stride=stride)
            return y, (y * cut(y, None)).sum()

        def conv(t):
            t = torch.nn.functional.pad(t, (1, 1, 0, 0), mode="constant" if mode == "zeros"
                                        else "reflect")
            return torch.nn.functional.conv2d(t, w, b, stride=stride)

        y, rows = conv_rows(x, bands, 3, stride, 1, conv, 4, pad_mode=mode)
        return y, (y * cut(y, rows)).sum()
    if name == "pool":
        if bands is None:
            y = torch.nn.functional.max_pool2d(x, 2, 2)
            return y, (y * cut(y, None)).sum()
        y, rows = pool_rows(x, bands)
        return y, (y * cut(y, rows)).sum()
    if name.startswith("in"):
        s, b = p["scale_t"], p["bias_t"]
        with precision("default" if name == "in_one_pass" else "highest"):
            if bands is None:
                y = instance_norm_act(x, s, b, True)
                return y, (y * cut(y, None)).sum()
            y = instance_norm_rows(x, bands, s, b, True, 1e-5)
            return y, (y * cut(y, bands)).sum()
    # gram, plain: NHWC features, the loss every rank holds whole
    f = x.permute(0, 2, 3, 1)
    g = (gram_ops.gram_matrix(f, use_kernel=False) if bands is None
         else gram_ops.gram_matrix_rows(f, bands, use_kernel=False))
    return g, (g * r[:, 0, :C, :C]).sum()


def cut_rows(r: torch.Tensor, i: int, ys: list[torch.Tensor]) -> torch.Tensor:
    off = sum(y.shape[2] for y in ys[:i])
    return r[:, :C, off: off + ys[i].shape[2], :W]


def run_primitive(name: str, inputs: dict, bands: RowBands | None, mesh=None) -> dict:
    """Output, input gradient and parameter gradients of one primitive, as numpy."""
    p = dict(inputs["params"], R=inputs["R"], mesh=mesh)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in inputs["params"].items()}
    p.update({f"{k}_t": v for k, v in params.items()})
    x = torch.as_tensor(inputs["x"])
    if bands is not None:
        a, b = bands.bounds()
        x = x[:, :, a:b]
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y, loss = apply_primitive(name, x, p, bands)
    loss.backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dp": {k: np.zeros(v.shape, np.float32) if v.grad is None else v.grad.numpy()
                   for k, v in params.items()}}  # an empty band's rank uses no parameter


def primitives_rank(mesh) -> dict:
    """Every primitive at every height on this rank's band."""
    return {(name, h): run_primitive(name, case_inputs(name, h), RowBands.split(mesh, h))
            for name in PRIMITIVES for h in heights(name, mesh.size)}


def vgg_losses_rank(mesh, vgg, images: np.ndarray, content_r22: np.ndarray, grams: dict):
    """The banded VGG16's style (Gram) and content losses on this rank's band of the
    images' rows, and their gradient on the band."""
    from artist_style_transfer_tpu_torch.ops.losses import content_loss_rows, style_loss_gram_rows

    bands = RowBands.split(mesh, images.shape[1])
    a, b = bands.bounds()
    x = torch.as_tensor(images[:, a:b]).requires_grad_(True)
    feats = vgg.forward_rows(x, bands)
    r22, rows = feats["relu2_2"]
    ra, rb = rows.bounds()
    grams = {k: torch.as_tensor(v) for k, v in grams.items()}
    style = style_loss_gram_rows(feats, grams, use_kernel=False)
    content = content_loss_rows(r22, torch.as_tensor(content_r22[:, ra:rb]), rows)
    (style + content).backward()
    return {"style": style.item(), "content": content.item(), "dx": x.grad.numpy(),
            "bands": {k: v[1].starts for k, v in feats.items()}}


def vgg_losses_whole(vgg, images, content_r22, grams):
    from artist_style_transfer_tpu_torch.ops.losses import content_loss, style_loss_gram

    x = torch.as_tensor(images).requires_grad_(True)
    feats = vgg(x)
    grams = {k: torch.as_tensor(v) for k, v in grams.items()}
    style = style_loss_gram(feats, grams, use_kernel=False)
    content = content_loss(feats["relu2_2"], torch.as_tensor(content_r22))
    (style + content).backward()
    return {"style": style.item(), "content": content.item(), "dx": x.grad.numpy()}


def vgg_case(h: int) -> tuple:
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    rng = np.random.default_rng(h)
    vgg = init_vgg16(torch.Generator().manual_seed(h))
    images = rng.normal(0, 60, (2, h, 16, 3)).astype(np.float32)
    r22 = rng.random((2, h // 2, 8, 128)).astype(np.float32)
    grams = {k: rng.random((c, c)).astype(np.float32) * 1e-2
             for k, c in (("relu1_2", 64), ("relu2_2", 128), ("relu3_3", 256), ("relu4_3", 512))}
    return vgg, images, r22, grams


# --- the step against JAX's single device -------------------------------------------------

STEP_SIZE = {(1, 2): 40, (2, 2): 40, (1, 4): 24}
STEP_B, CW, SW = 4, 17.0, 25.0


def redrawn_transformer(seed: int):
    """A TransformerNet with every weight redrawn from numpy (conv weights and biases at
    their init's bound, instance-norm gammas in [0.5, 1.5], betas in [-0.5, 0.5])."""
    from artist_style_transfer_tpu_torch.models.transformer import TransformerNet

    rng = np.random.default_rng(seed)
    model = TransformerNet()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm_layer.weight" in name:
                v = rng.uniform(0.5, 1.5, p.shape)
            elif "norm_layer.bias" in name:
                v = rng.uniform(-0.5, 0.5, p.shape)
            else:
                w = dict(model.named_parameters())[name.rsplit(".", 1)[0] + ".weight"]
                bound = 1.0 / np.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
                v = rng.uniform(-bound, bound, p.shape)
            p.copy_(torch.as_tensor(v, dtype=torch.float32))
    return model


def jax_vgg():
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params

    return init_vgg16_params(jax.random.key(1))


def step_setup(size: int) -> dict:
    """The port's side of one step at ``size``: the redrawn net, JAX's VGG16 moved across,
    the global batch and the paintings."""
    from artist_style_transfer_tpu_torch.models.vgg import VGG16Features

    rng = np.random.default_rng(size)
    vgg = VGG16Features()
    vgg.load_state_dict(vgg16_state_dict_from_jax(jax.tree.map(np.asarray, jax_vgg())))
    return dict(model=redrawn_transformer(size), vgg=vgg,
                content=rng.uniform(0, 255, (STEP_B, size, size, 3)).astype(np.float32),
                paintings=rng.uniform(0, 255, (3, size, size, 3)).astype(np.float32),
                batch_size=STEP_B, content_weight=CW, style_weight=SW, step=1)


def jax_step(setup: dict):
    """JAX's single-device loss and parameter gradients of the same step."""
    from artist_style_transfer_tpu.train.loop import make_optimizer, make_step_fns
    from artist_style_transfer_tpu.train.loop import precompute_content_relu2_2 as jprecompute
    from artist_style_transfer_tpu.train.styles import build_style_targets as jbuild_targets

    jvgg = jax_vgg()
    params = jax.tree.map(jnp.asarray, transformer_state_dict_to_jax(setup["model"].state_dict()))
    targets = jbuild_targets("cycle", jvgg, "X", paintings=setup["paintings"])
    fns = make_step_fns("cycle", jvgg, None, targets, content_weight=CW,
                        style_weight=SW, batch_size=STEP_B, num_content=STEP_B,
                        tx=make_optimizer(1e-3, 0.0, 1, 1, 1), use_pallas=False)
    data = jnp.asarray(setup["content"])
    r22 = jprecompute(jvgg, data)
    (total, (c, s)), g = jax.jit(jax.value_and_grad(fns.loss_fn, has_aux=True))(
        params, data, r22, targets.grams, None, jnp.int32(setup["step"]))
    grads = {k: v.numpy() for k, v in
             transformer_state_dict_from_jax(jax.tree.map(np.asarray, g)).items()}
    return np.array([c, s, total], np.float64), grads


F64_SEEDS = (1, 3)  # data and weights at 24x24 whose f32 steps flip a ReLU (see below)


def f64_setup(seed: int) -> dict:
    setup = step_setup(24)
    rng = np.random.default_rng(100 + seed)
    return dict(setup, model=redrawn_transformer(seed),
                content=rng.uniform(0, 255, setup["content"].shape).astype(np.float32))


def f64_step_rank(mesh, shape, setup: dict) -> dict:
    """The banded step of :func:`workers.space_step_rank` in f64 over a ('data', 'space')
    mesh of ``shape`` (None: one process, no mesh): every parameter's synced gradient."""
    import copy

    from artist_style_transfer_tpu_torch.ops.image import vgg_caffe_preprocess
    from artist_style_transfer_tpu_torch.train import loop, styles

    mesh = None if shape is None else workers.space_mesh(mesh, shape)
    model, vgg = copy.deepcopy(setup["model"]).double(), copy.deepcopy(setup["vgg"]).double()
    paintings = torch.as_tensor(setup["paintings"], dtype=torch.float64)
    grams = {k: gram_f64(v) for k, v in vgg(vgg_caffe_preprocess(paintings)).items()}
    targets = styles.StyleTargets("cycle", grams=grams, num_cycle=len(paintings))
    opt, sched = loop.make_optimizer(model.parameters(), 0.0, 0.0, 1, 1, 1)
    content = torch.as_tensor(setup["content"], dtype=torch.float64)
    fns = loop.make_step_fns("cycle", model, vgg, targets, opt, sched, content_weight=CW,
                             style_weight=SW, batch_size=STEP_B, num_content=STEP_B, mesh=mesh)
    fns.step_fn(content, loop.precompute_content_relu2_2(vgg, content), setup["step"])
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def gram_f64(f: torch.Tensor) -> torch.Tensor:
    n, h, w, c = f.shape
    f = f.reshape(n, h * w, c)
    return torch.bmm(f.transpose(1, 2), f) / float(c * h * w)


def counted_gathers_rank(mesh, setup: dict) -> dict:
    """:func:`workers.space_step_rank` over (1, 2) with the row gathers it makes counted."""
    from artist_style_transfer_tpu_torch.parallel import spatial

    real, calls = spatial.gather_rows, []

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    spatial.gather_rows = counting
    try:
        out = workers.space_step_rank(mesh, (1, 2), setup)
    finally:
        spatial.gather_rows = real
    return dict(out, gathers=len(calls))


def one_image_setup() -> dict:
    return dict(step_setup(STEP_SIZE[(1, 2)]), batch_size=1,
                content=step_setup(STEP_SIZE[(1, 2)])["content"][:1])


# --- launches: every check of a rank count in one ----------------------------------------


@pytest.fixture(scope="module")
def two_ranks():
    vgg_args = vgg_case(40)
    jobs = [(primitives_rank, (), {}),
            (vgg_losses_rank, vgg_args, {}),
            (workers.space_step_rank, ((1, 2), step_setup(STEP_SIZE[(1, 2)])), {})]
    jobs += [(f64_step_rank, ((1, 2), f64_setup(seed)), {}) for seed in F64_SEEDS]
    jobs += [(counted_gathers_rank, (one_image_setup(),), {})]
    return launch(workers.run_jobs, 2, jobs, backend="gloo", device="cpu")


@pytest.fixture(scope="module")
def three_ranks():
    return launch(primitives_rank, 3, backend="gloo", device="cpu")


@pytest.fixture(scope="module")
def four_ranks():
    jobs = [(vgg_losses_rank, vgg_case(24), {})]
    jobs += [(workers.space_step_rank, (shape, step_setup(STEP_SIZE[shape])), {})
             for shape in ((2, 2), (1, 4))]
    jobs += [(f64_step_rank, ((1, 4), f64_setup(seed)), {}) for seed in F64_SEEDS]
    return launch(workers.run_jobs, 4, jobs, backend="gloo", device="cpu")


def close(got: np.ndarray, want: np.ndarray, rel: float = 1e-5) -> bool:
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0)) <= rel * float(
        np.abs(want).max(initial=0.0))


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_banded_primitive_gradients_match_one_process(two_ranks, three_ranks, name, ranks):
    got_ranks = ([r[0] for r in two_ranks] if ranks == 2 else three_ranks)
    for h in heights(name, ranks):
        inputs = case_inputs(name, h)
        fake = type("FakeMesh", (), {"size": ranks, "rank": 0})()  # only splits rows
        want = run_primitive(name, inputs, None, mesh=fake)
        got = [g[(name, h)] for g in got_ranks]
        bands = RowBands.split(fake, h)
        assert any(b - a == 0 for a, b in zip(bands.starts, bands.starts[1:])) == (h < ranks)
        if h == 1:  # the transpose conv's 2 output rows leave the last rank none
            assert [g["y"].shape[2] for g in got] == [1, 1, 0]
        dx = np.concatenate([g["dx"] for g in got], axis=2)
        assert close(dx, want["dx"]), (name, h, "dx")
        for k, v in want["dp"].items():
            assert close(sum(g["dp"][k] for g in got), v), (name, h, k)
        if name in ("row_mean", "gram"):  # the same whole value on every rank
            for g in got:
                assert close(g["y"], want["y"]), (name, h)
        else:
            assert close(np.concatenate([g["y"] for g in got], axis=2), want["y"]), (name, h)


@pytest.mark.parametrize("h,ranks", [(40, 2), (24, 4)], ids=["H40-over-2", "H24-over-4"])
def test_banded_vgg_losses_and_gradient_match_one_process(two_ranks, four_ranks, h, ranks):
    got = [r[1] for r in two_ranks] if ranks == 2 else [r[0] for r in four_ranks]
    want = vgg_losses_whole(*vgg_case(h))
    for g in got:
        np.testing.assert_allclose([g["style"], g["content"]], [want["style"], want["content"]],
                                   rtol=1e-5)
    assert close(np.concatenate([g["dx"] for g in got], axis=1), want["dx"])
    starts = got[0]["bands"]
    if ranks == 2:  # relu3_3 (10 rows) in bands of 5: relu4_3's pool straddles them
        assert starts["relu3_3"] == (0, 5, 10) and starts["relu4_3"] == (0, 3, 5)
    else:  # relu4_3's 3 rows over 4 ranks: the last holds none
        assert starts["relu4_3"] == (0, 1, 2, 3, 3)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_banded_step_matches_jax_single_device(two_ranks, four_ranks, shape):
    got = ([r[2] for r in two_ranks] if shape == (1, 2)
           else [r[1 + [(2, 2), (1, 4)].index(shape)] for r in four_ranks])
    want_losses, want_grads = jax_step(step_setup(STEP_SIZE[shape]))
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=1e-5)
    top = max(np.abs(v).max() for v in want_grads.values())
    grads = got[0]["grads"]
    assert sorted(grads) == sorted(want_grads)
    for k, g in grads.items():
        scale = top if zero_grad_leaf(k) else np.abs(want_grads[k]).max()
        assert np.abs(g - want_grads[k]).max() <= 1e-4 * scale, k
    for r in got[1:]:  # every rank holds the same synced gradients and losses
        np.testing.assert_array_equal(r["losses"], got[0]["losses"])
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, grads[k], err_msg=k)


@pytest.mark.parametrize("seed", F64_SEEDS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_banded_step_in_f64_matches_one_process(two_ranks, four_ranks, shape, seed):
    """At these seeds an f32 step flips a ReLU or pool decision within f32 rounding of its
    boundary, in the one process as in the bands (the one process's f32 gradients are
    up to 8e-3 of a leaf's max from its f64 ones, measured), so the f32 comparison above
    runs at data whose steps flip none. In f64 the bands equal the one process's step
    (no mesh) within 1e-6 of each leaf's max (measured 1.6e-7: the losses' f32 sums)."""
    i = F64_SEEDS.index(seed)
    got = two_ranks[0][3 + i] if shape == (1, 2) else four_ranks[0][3 + i]
    want = f64_step_rank(None, None, f64_setup(seed))
    top = max(np.abs(v).max() for v in want.values())
    for k, g in got.items():
        scale = top if zero_grad_leaf(k) else np.abs(want[k]).max()
        assert np.abs(g - want[k]).max() <= 1e-6 * scale, k


def test_a_batch_of_one_image_is_banded(two_ranks):
    """A full batch shards over the data slices, not over every rank: one image on
    (1, 2) runs banded (a row gather before each of the TransformerNet's 18 convs and
    the VGG16's 10 convs and 3 pools), with the one process's losses."""
    from artist_style_transfer_tpu_torch.parallel import make_mesh

    want = workers.space_step_rank(make_mesh(device="cpu"), None, one_image_setup())
    for r in (r[5] for r in two_ranks):
        assert r["gathers"] == 18 + 13
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)


# --- train() over (1, 2) against one process ---------------------------------------------

TRAIN_SIZE, TRAIN_N, TRAIN_B = 32, 8, 4
TRAIN_CASES = {"random": {}, "average": {}, "smartaverage": {}, "cycle": {},
               "cycle-stream": {"stream": True}, "cycle-bf16": {"compute_dtype": "bfloat16"},
               "cycle-remat": {"remat": True},
               # ragged tails: 2 images banded over the 2 ranks, 1 whole on each (JAX's
               # tail_mesh)
               "cycle-tail2": {"n": 6}, "cycle-tail1": {"n": 5}}


def train_kwargs(mode: str) -> dict:
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    rng = np.random.default_rng(4)
    s = TRAIN_SIZE
    return dict(style_method=mode, artist="A", num_epochs=2, batch_size=TRAIN_B, seed=3,
                content_images=rng.uniform(0, 255, (TRAIN_N, s, s, 3)).astype(np.float32),
                paintings=rng.uniform(0, 255, (3, s, s, 3)).astype(np.float32),
                avg_image=rng.uniform(0, 255, (s, s, 3)).astype(np.float32),
                vgg=init_vgg16(torch.Generator().manual_seed(1)), save_every=0,
                wordy=False, lr=1e-3, log_every_batches=1)


def step_losses(model_dir: str, mode: str) -> np.ndarray:
    with open(os.path.join(model_dir, "A", mode, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return np.array([[r["content_loss"], r["style_loss"], r["total_loss"]]
                     for r in rows if r["event"] == "batch"])


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Every case over (1, 2) in one launch, and each one-process run."""
    from artist_style_transfer_tpu_torch.data import content_file_stream
    from artist_style_transfer_tpu_torch.train import train
    from tests.test_torch_data import write_workspace

    root = tmp_path_factory.mktemp("space_train")
    ws = write_workspace(root / "ws", n_content=TRAIN_N)
    os.remove(ws["bad"])  # the stream refuses an undecodable file
    stream = dict(content_dir=ws["content"], batch_size=TRAIN_B, rescale_height=TRAIN_SIZE,
                  rescale_width=TRAIN_SIZE, seed=3)
    jobs, singles = [], {}
    for name, extra in TRAIN_CASES.items():
        mode = name.split("-")[0]
        kw = train_kwargs(mode)
        kw.update({k: v for k, v in extra.items() if k not in ("stream", "n")})
        kw["content_images"] = kw["content_images"][: extra.get("n", TRAIN_N)]
        if extra.get("stream"):
            del kw["content_images"]
            kw.update(content_data_size=TRAIN_N, train_size=TRAIN_SIZE)
        one_dir, two_dir = str(root / name / "one"), str(root / name / "two")
        _, losses = train(device="cpu", model_dir=one_dir, **kw,
                          **({"content_stream": content_file_stream(**stream)}
                             if extra.get("stream") else {}))
        singles[name] = (losses, step_losses(one_dir, mode))
        jobs.append((workers.train_rank, (dict(kw, model_dir=two_dir),),
                     {"shape": (1, 2), "stream": stream if extra.get("stream") else None}))
    ranks = launch(workers.run_jobs, 2, jobs, backend="gloo", device="cpu", threads=2)
    return {name: (singles[name], [r[i] for r in ranks],
                   step_losses(str(root / name / "two"), name.split("-")[0]))
            for i, name in enumerate(TRAIN_CASES)}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_over_data_space_mesh_matches_one_process(train_runs, case):
    (single_epochs, single_steps), ranks, steps = train_runs[case]
    n = TRAIN_CASES[case].get("n", TRAIN_N)
    assert steps.shape == single_steps.shape == (2 * -(-n // TRAIN_B), 3)
    assert np.isfinite(steps).all()
    np.testing.assert_allclose(steps, single_steps, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["losses"], single_epochs, rtol=1e-4)
    for r in ranks[1:]:  # one model on every rank
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=k)
    assert ranks[0]["launches"]["k1"] == 0  # the CPU runs the plain Gram
