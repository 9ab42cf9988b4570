"""Diffusion training over a ('data', 'space') mesh in the PyTorch port: the banded UNet
(``DiffModel.forward_rows``), one banded ``diffusion_step`` and ``train_diffusion`` over
the mesh, on gloo ranks on the CPU.

JAX runs no training over 'space' on the CPU (``tests/test_torch_spatial_train.py``
says why), so the port is held against JAX's single-device functions and its own one
process. Tolerances:

- ``DiffModel.forward_rows`` at base 32, 16x16 and 24x24 (at 24 over 4 ranks the
  bottleneck's 6 rows split 2, 2, 1, 1 and upsample to 4, 4, 2, 2 rows, which the
  upsample conv re-bands to its skip's 3, 3, 3, 3), over (1, 2) and (1, 4): within 1e-5
  of the largest magnitude of the port's whole-image forward and of JAX's
  ``diff_model_apply``;
- one ``diffusion_step`` over (1, 2) at 16x16 and (1, 4) at 24x24: the loss within rtol
  1e-6 of the one process's, every gradient within 1e-4 of its leaf's largest (of the
  net's largest for the leaves whose exact gradient is 0: a conv bias feeding a
  GroupNorm, and the last block's biases, which ``norm_out``'s one-channel groups
  remove), the ranks bit-identical;
- ``train_diffusion`` over (1, 2) and (2, 2), 2 epochs on JAX's permutations and draws
  (``tests/test_torch_diffusion.py``'s config): per-epoch losses within rtol 1e-4 of
  JAX's, as that file holds the one process, the ranks' weights bit-identical.

Every launch has a time limit of its own, so a collective that one rank misses fails
the test instead of hanging the suite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.diffusion import unet as junet
from artist_style_transfer_tpu.diffusion.train import train_diffusion as jtrain_diffusion
from artist_style_transfer_tpu_torch.diffusion import diff_model_apply
from artist_style_transfer_tpu_torch.parallel import launch, workers
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands, all_rows
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_diffusion import (
    BASE,
    CLASSES,
    HW,
    T,
    jax_train_draws,
    numpy_diff_params,
    port_model,
)

LAUNCH_S = 240  # each launch's own limit: a missed collective fails, never hangs
SIZES = (16, 24)
FORWARD_SHAPES = {2: (1, 2), 4: (1, 4)}
STEP_CASES = {2: ((1, 2), 16), 4: ((1, 4), 24)}  # ranks: (mesh shape, image size)
TRAIN_SHAPES = {2: (1, 2), 4: (2, 2)}
TRAIN_KW = dict(num_classes=CLASSES, num_timesteps=T, num_epochs=2, batch_size=4, lr=1e-4,
                seed=5, base_channels=BASE, wordy=False)


def forward_inputs(h: int) -> dict:
    rng = np.random.default_rng([h, 3])
    return {"x": rng.uniform(-1, 1, (2, h, h, 3)).astype(np.float32),
            "t": np.array([3, 11]), "y": np.array([0, 2])}


def step_setup(h: int) -> dict:
    rng = np.random.default_rng([h, 4])
    return {"model": port_model(numpy_diff_params(CLASSES, 30 + h)), "num_timesteps": T,
            "x0": rng.uniform(-1, 1, (4, h, h, 3)).astype(np.float32),
            "y": np.array([0, 1, 2, 0]), "t": np.array([3, 7, 1, 12]),
            "noise": rng.standard_normal((4, h, h, 3)).astype(np.float32)}


def train_data():
    rng = np.random.default_rng(8)
    return (rng.random((8, HW, HW, 3)) * 255).astype(np.float32), np.arange(8) % CLASSES


def unet_rows_rank(mesh, shape, model, x, t, y) -> np.ndarray:
    """``forward_rows`` of the whole batch (one data slice) on this rank's band of rows,
    the output gathered: NHWC."""
    mesh = workers.space_mesh(mesh, shape)
    bands = RowBands.split(mesh.axis_mesh("space"), x.shape[1])
    a, b = bands.bounds()
    xc = torch.as_tensor(x[:, a:b]).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        eps, out = model.forward_rows(xc, torch.as_tensor(t), torch.as_tensor(y), bands)
    return all_rows(eps, out, dim=2).permute(0, 2, 3, 1).numpy()


def jobs(ranks: int) -> list:
    model = port_model(numpy_diff_params(CLASSES, 21))
    shape = FORWARD_SHAPES[ranks]
    out = [(unet_rows_rank, (shape, model, *forward_inputs(h).values()), {}) for h in SIZES]
    step_shape, h = STEP_CASES[ranks]
    out.append((workers.diffusion_step_rank, (step_shape, step_setup(h)), {}))
    perms, draws = jax_train_draws(5, 2, 8, 4)
    imgs, labels = train_data()
    kw = dict(TRAIN_KW, params=port_model(numpy_diff_params(CLASSES, 21)), perms=perms,
              draws=draws)
    out.append((workers.diffusion_rank, (imgs, labels, kw), {"shape": TRAIN_SHAPES[ranks]}))
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return launch(workers.run_jobs, 2, jobs(2), backend="gloo", device="cpu",
                  timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def four_ranks():
    return launch(workers.run_jobs, 4, jobs(4), backend="gloo", device="cpu",
                  timeout_s=LAUNCH_S)


def close(got: np.ndarray, want: np.ndarray, rel: float) -> bool:
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


def test_uneven_bands_at_24_over_4():
    """The bottleneck's rows at 24x24 over 4 ranks split unevenly, so the upsampled bands
    are not the skips' (the case the forward below covers)."""
    line = type("Line", (), {"size": 4, "rank": 0})()
    assert RowBands.split(line, 6).starts == (0, 2, 4, 5, 6)
    doubled = tuple(2 * a for a in RowBands.split(line, 6).starts)
    assert doubled == (0, 4, 8, 10, 12) != RowBands.split(line, 12).starts == (0, 3, 6, 9, 12)


@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("ranks", [2, 4])
def test_forward_rows_matches_whole_image_and_jax(two_ranks, four_ranks, ranks, h):
    got_ranks = two_ranks if ranks == 2 else four_ranks
    inp = forward_inputs(h)
    tree = numpy_diff_params(CLASSES, 21)
    with torch.no_grad():
        whole = diff_model_apply(port_model(tree), torch.from_numpy(inp["x"]),
                                 torch.from_numpy(inp["t"]), torch.from_numpy(inp["y"])).numpy()
    ref = np.asarray(jax.jit(junet.diff_model_apply)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(inp["x"]), jnp.asarray(inp["t"]),
        jnp.asarray(inp["y"])))
    for r in got_ranks:
        got = r[SIZES.index(h)]
        assert close(got, whole, 1e-5), np.abs(got - whole).max() / np.abs(whole).max()
        assert close(got, ref, 1e-5), np.abs(got - ref).max() / np.abs(ref).max()


def zero_grad_leaf(name: str) -> bool:
    """A conv bias feeding a GroupNorm (each ResBlock's conv1), and the last up block's
    biases, whose per-channel constants ``norm_out``'s one-channel groups remove."""
    return name.endswith("conv1.bias") or (name.startswith("up.2.blocks.2.")
                                           and name.endswith(("conv2.bias", "skip.bias")))


@pytest.mark.parametrize("ranks", [2, 4])
def test_diffusion_step_gradients_match_one_process(two_ranks, four_ranks, ranks):
    got_ranks = two_ranks if ranks == 2 else four_ranks
    _, h = STEP_CASES[ranks]
    want = workers.diffusion_step_rank(None, None, step_setup(h))
    got = got_ranks[0][len(SIZES)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    net = max(float(np.abs(g).max()) for g in want["grads"].values())
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        scale = net if zero_grad_leaf(k) else float(np.abs(w).max())
        err = float(np.abs(got["grads"][k] - w).max())
        assert err <= 1e-4 * scale, (k, err / scale)
    for r in got_ranks[1:]:
        other = r[len(SIZES)]
        assert other["loss"] == got["loss"]
        for k, v in got["grads"].items():
            np.testing.assert_array_equal(other["grads"][k], v, err_msg=k)


def test_train_diffusion_over_space_matches_jax(two_ranks, four_ranks):
    imgs, labels = train_data()
    _, _, j_losses = jtrain_diffusion(imgs, labels, params=numpy_diff_params(CLASSES, 21),
                                      **TRAIN_KW)
    for got_ranks in (two_ranks, four_ranks):
        runs = [r[len(SIZES) + 1] for r in got_ranks]
        np.testing.assert_allclose(runs[0]["losses"], j_losses, rtol=1e-4)
        for other in runs[1:]:
            np.testing.assert_array_equal(other["losses"], runs[0]["losses"])
            for k, v in runs[0]["params"].items():
                np.testing.assert_array_equal(other["params"][k], v, err_msg=k)
