"""Data-parallel 'cycle' training in the PyTorch port (``parallel/``, ``train/loop.py``,
``train/api.py``, ``data/stream.py``, ``data/prefetch.py``) against the JAX package's
mesh runs on its 8 fake CPU devices; the classifier's and the evaluation's are in
``tests/test_torch_parallel_classifier.py``.

The port's ranks are gloo processes on the CPU (``parallel.launch``), several checks
to a launch; the same numpy-seeded inputs and JAX's parameters (moved across by
``utils/jax_params.py``) feed both sides, and JAX's permutations feed the port's
epochs. Tolerances, JAX's own (``tests/test_parallel.py:74-89``,
``tests/test_classifier_train.py:193-217``) where the comparison is within one
framework, the port's cross-framework ones otherwise:

- 'cycle' over 2 ranks (32x32, N=16, B=8, lr 1e-3, 2 epochs; N=19, whose tail of 3
  runs whole on each rank; JAX's folded step): per-step losses within rtol 1e-4
  of the port's single process; against JAX's 2-device mesh and single-device
  runs within rtol 1e-4 over the first epoch and 1e-3 over both (the port's own
  single-device trajectory is 3.0e-4 from JAX's at the ragged case's last step:
  the cross-framework drift ``tests/test_torch_train_loop.py`` bounds at 1e-3);
  every param leaf's RMS drift under 1e-3 from the port's single process, and
  from JAX's no more than the port's single process drifts from JAX's plus 1e-3
  (Adam's sign-like steps flip on near-zero gradients that the frameworks round
  apart: 1.6 lr after the ragged case's 6 steps, with or without the mesh); the
  ranks' params and Adam state bit-identical. JAX's folded step over a mesh (``shard_map``) raises in this
  JAX version (a custom VJP's varying manual axes), and its own test of it,
  ``tests/test_fold.py::test_folded_dp_step_matches_single_device``, is marked
  slow; the fold case is held against JAX's single-device folded run, which that
  test holds equal to the mesh one;
- ``train(mesh=)``: a world of one equals the mesh-less run exactly (one
  all-reduce of one rank is the identity); 2 ranks within rtol 1e-4 of it, with
  the int8 options too, whose dynamic scales are the whole batch's (the JAX mesh
  run is not compared: the frameworks' int8 trajectories are 1e-2 apart,
  ``tests/test_torch_int8_train.py``, too far to tell a rank's scale from the
  batch's);
- the streamed corpus over 2 ranks: each rank's batches bit-equal to JAX's
  ``_procs=(2, r)``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.models.transformer import init_transformer_params
from artist_style_transfer_tpu.models.vgg import init_vgg16_params
from artist_style_transfer_tpu.parallel import make_mesh as jmake_mesh
from artist_style_transfer_tpu.train.loop import epoch_permutation as jepoch_permutation
from artist_style_transfer_tpu.train.loop import make_optimizer as jmake_optimizer
from artist_style_transfer_tpu.train.loop import make_step_fns as jmake_step_fns
from artist_style_transfer_tpu.train.loop import precompute_content_relu2_2 as jprecompute
from artist_style_transfer_tpu.train.styles import build_style_targets as jbuild_targets
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.models.vgg import VGG16Features
from artist_style_transfer_tpu_torch.parallel import launch, workers
from artist_style_transfer_tpu_torch.utils.jax_params import (
    transformer_state_dict_from_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_data import one_torch_thread  # noqa: F401

H = W = 32
B, LR, WD, EPOCHS = 8, 1e-3, 1e-4, 2
CW, SW = 17.0, 25.0
CASES = {"even": (16, False), "ragged": (19, False), "fold": (16, True)}  # N, JAX fold_batch


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cycle_setup():
    rng = np.random.default_rng(0)
    content = (rng.random((19, H, W, 3)) * 255).astype(np.float32)
    paintings = (rng.random((2, H, W, 3)) * 255).astype(np.float32)
    params = init_transformer_params(jax.random.key(0))
    vgg = init_vgg16_params(jax.random.key(1))
    model = TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(numpy_tree(params)))
    tvgg = VGG16Features()
    tvgg.load_state_dict(vgg16_state_dict_from_jax(numpy_tree(vgg)))
    return dict(content=content, paintings=paintings, params=params, vgg=vgg, model=model,
                tvgg=tvgg)


def jax_cycle(setup, n: int, mesh, fold: bool):
    """JAX's 'cycle' epochs over ``mesh`` (None: one device), as ``tests/test_parallel.py``
    runs them; returns the per-step losses and the final params."""
    from artist_style_transfer_tpu.parallel import batch_sharding, replicated_sharding

    content = jnp.asarray(setup["content"][:n])
    params = jax.tree.map(jnp.copy, setup["params"])
    targets = jbuild_targets("cycle", setup["vgg"], "X", paintings=setup["paintings"],
                             batch_size=B)
    spe = -(-n // B)
    tx = jmake_optimizer(LR, WD, 4, 2, spe)
    fns = jmake_step_fns("cycle", setup["vgg"], None, targets, content_weight=CW,
                         style_weight=SW, batch_size=B, num_content=n, tx=tx, mesh=mesh,
                         use_pallas=False, fold_batch=fold)
    if mesh is not None:
        content = jax.device_put(content, batch_sharding(mesh) if n % 2 == 0
                                 else replicated_sharding(mesh))
        params = jax.device_put(params, replicated_sharding(mesh))
    opt_state = tx.init(params)
    r22 = jprecompute(setup["vgg"], content)
    losses = []
    for e in range(EPOCHS):
        params, opt_state, el = fns.epoch_fn(params, opt_state, content, r22, targets.grams,
                                             None, jepoch_permutation(0, e, n),
                                             jnp.int32(e * spe))
        losses.append(np.asarray(el, np.float64))
    return np.concatenate(losses), transformer_state_dict_from_jax(numpy_tree(params))


def port_setup(setup, n: int) -> dict:
    return dict(model=setup["model"], vgg=setup["tvgg"], paintings=setup["paintings"],
                content=setup["content"][:n], lr=LR, weight_decay=WD, num_epochs=4,
                num_steps=2, batch_size=B, content_weight=CW, style_weight=SW,
                perms=[np.asarray(jepoch_permutation(0, e, n)) for e in range(EPOCHS)])


@pytest.fixture(scope="module")
def dp_runs(cycle_setup):
    """Every case over 2 ranks in one launch, and the port's single process."""
    setups = [port_setup(cycle_setup, n) for n, _ in CASES.values()]
    ranks = launch(workers.step_trajectories_rank, 2, setups, backend="gloo", device="cpu")
    single = launch(workers.step_trajectories_rank, 1, setups[:2], backend="gloo", device="cpu")
    return {name: ([r[i] for r in ranks], single[0][0 if CASES[name][0] == 16 else 1])
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_dp_cycle_matches_jax_mesh_and_single_device(cycle_setup, dp_runs, case):
    n, fold = CASES[case]
    ranks, single = dp_runs[case]
    got = ranks[0]
    # the ranks are one model: params and Adam's state bit-identical
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["losses"], got["losses"])
        np.testing.assert_array_equal(other["adam"], got["adam"])
        for k, v in got["params"].items():
            np.testing.assert_array_equal(other["params"][k], v, err_msg=k)
    spe = -(-n // B)
    assert got["losses"].shape == (EPOCHS * spe, 3)
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-4)
    assert rms_drift(got["params"], single["params"]) < 1e-3
    for mesh in (None,) if fold else (jmake_mesh(shape=(2,)), None):
        ref_losses, ref_params = jax_cycle(cycle_setup, n, mesh, fold)
        np.testing.assert_allclose(got["losses"][:spe], ref_losses[:spe], rtol=1e-4)
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-3)
        ref_params = {k: v.numpy() for k, v in ref_params.items()}
        assert rms_drift(got["params"], ref_params) < rms_drift(single["params"], ref_params) + 1e-3


def rms_drift(a: dict, b: dict) -> float:
    """The largest per-leaf RMS difference of two state dicts."""
    return max(float(np.sqrt(np.mean((v.astype(np.float64) - b[k].astype(np.float64)) ** 2)))
               for k, v in a.items())


# --- train(mesh=), the streamed corpus, the CLI ----------------------------------------


def train_kwargs(tmp_path) -> dict:
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    rng = np.random.default_rng(4)
    return dict(style_method="cycle", artist="A", num_epochs=2, batch_size=4, seed=3,
                content_images=rng.uniform(0, 255, (8, H, W, 3)).astype(np.float32),
                paintings=rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32),
                vgg=init_vgg16(torch.Generator().manual_seed(1)), save_every=1,
                model_dir=str(tmp_path), wordy=False, lr=1e-3)


def test_train_over_two_ranks_matches_one_process(tmp_path):
    """``train(mesh=)`` over 2 ranks: rank 0's files are the single run's, the losses
    within rtol 1e-4 and the params within 1e-3 RMS of it, the ranks bit-identical."""
    from artist_style_transfer_tpu_torch.train import train

    kw = train_kwargs(tmp_path / "one")
    model, losses = train(device="cpu", **kw)
    ranks = launch(workers.train_rank, 2, dict(kw, model_dir=str(tmp_path / "two")),
                   backend="gloo", device="cpu")
    for r in ranks:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=k)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
    assert rms_drift(ranks[0]["params"], workers.params_numpy(model)) < 1e-3
    want = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "one")
                  for d, _, fs in os.walk(tmp_path / "one") for f in fs)
    assert ranks[0]["files"] == ranks[1]["files"] == want and "A/cycle/metrics.jsonl" in want
    with open(tmp_path / "two" / "A" / "cycle" / "metrics.jsonl") as f:  # one writer
        assert sum('"event": "epoch"' in line for line in f) == 2


def test_int8_train_over_two_ranks_takes_the_whole_batch_scales(tmp_path):
    """``train(mesh=)`` with the int8 options (``quantize_loss``, whose int8 Gram "auto"
    turns on, and QAT "trunk") over 2 ranks: every dynamic int8 scale, forward and STE
    backward, is the whole batch's. The ranks take bit-identical scales; over the
    first quarter of the run (the targets and the first step) each equals the single
    process's exactly, a backward one times the world (each rank's loss is the mean
    over its half, so its cotangents are twice the single process's; the codes are
    the same). Losses within rtol 1e-4 of the single process, params within 2e-3
    RMS (measured 4.2e-6 and 1.4e-3; with each rank's own scales instead, 6.0e-5,
    2.8e-3, the ranks' scales equal at 3% of the calls and the first quarter's 10%
    apart), the ranks bit-identical."""
    from artist_style_transfer_tpu_torch.train import train

    kw = dict(train_kwargs(tmp_path), model_dir=None, quantize_loss=True, qat="trunk")
    with workers.recorded_scales() as scales:
        model, losses = train(device="cpu", **kw)
    single = np.asarray(scales)
    ranks = launch(workers.train_rank, 2, kw, None, False, True, backend="gloo", device="cpu")
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        np.testing.assert_array_equal(r["scales"], ranks[0]["scales"])
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=k)
    got = ranks[0]["scales"]
    assert got.shape == single.shape and len(single) > 100
    ratio = (got / single)[: len(single) // 4]
    np.testing.assert_array_equal(np.isin(ratio, (1.0, 2.0)), True)
    assert (ratio == 2.0).sum() > 10  # the backward's scales are among them
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
    assert rms_drift(ranks[0]["params"], workers.params_numpy(model)) < 2e-3


def test_streamed_train_over_two_ranks(tmp_path):
    """A streamed corpus over 2 ranks: each rank decodes its half of every global batch
    (``_procs`` from the process group) and the trajectory is the single process's."""
    from artist_style_transfer_tpu_torch.data import content_file_stream
    from artist_style_transfer_tpu_torch.train import train
    from tests.test_torch_data import write_workspace

    ws = write_workspace(tmp_path / "ws", n_content=8)
    os.remove(ws["bad"])  # the stream refuses an undecodable file
    kw = train_kwargs(tmp_path)
    del kw["content_images"]
    kw.update(model_dir=None, content_data_size=8, train_size=H)
    stream = dict(content_dir=ws["content"], batch_size=4, rescale_height=H, rescale_width=W,
                  seed=3)
    _, losses = train(content_stream=content_file_stream(**stream), device="cpu", **kw)
    ranks = launch(workers.train_rank, 2, kw, stream, backend="gloo", device="cpu")
    np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)


def test_content_file_stream_takes_the_ranks_from_the_group(tmp_path, monkeypatch):
    """Each rank's batches equal JAX's ``_procs=(2, rank)`` bit for bit (the cv2 route on
    both sides, the ragged tail of 2 kept)."""
    from artist_style_transfer_tpu.data import native_loader as jnative
    from artist_style_transfer_tpu.data.stream import content_file_stream as jax_stream
    from artist_style_transfer_tpu_torch.data import native_loader as tnative
    from tests.test_torch_data import jax_native_loader, write_workspace

    ws = write_workspace(tmp_path, n_content=10)
    os.remove(ws["bad"])  # the stream refuses an undecodable file
    # The route the ranks take (the native pool where it builds), on JAX's side too.
    if tnative.available():
        assert jax_native_loader()
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
    got = launch(workers.stream_rank, 2, ws["content"], 4, 16, 20, dict(seed=3),
                 backend="gloo", device="cpu")
    for rank, epochs in enumerate(got):
        want = jax_stream(ws["content"], 4, 16, 20, seed=3, _procs=(2, rank))
        for e, batches in enumerate(epochs):
            ref = list(want(e))
            assert [b.shape for b in batches] == [b.shape for b in ref] == [(2, 16, 20, 3)] * 2 + [(1, 16, 20, 3)]
            for a, b in zip(batches, ref):
                np.testing.assert_array_equal(a, b)
