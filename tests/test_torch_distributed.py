"""The port's process-group set-up (``parallel/distributed.py``, ``parallel/mesh.py``,
``parallel/launch.py``) on the CPU: JAX's ``tests/test_distributed.py`` cases for
``initialize_multihost``, ``_cluster_detected`` and ``per_host_batch_slice``, the
mesh's shapes and collectives, ``make_global``, the launcher's failure reports, and
the global-batch ``batch_norm_train`` against JAX's BN over the whole batch.

Multi-rank checks run as gloo ranks on the CPU through ``parallel.launch``; a
world of one is a gloo group of this process alone (:func:`world_of_one`).
Tolerances: the global-batch BN's output, statistics and gradients within 1e-5 of
the single-process BN (JAX's and the port's) over the whole batch (f32 sums in
another order); the mesh's collectives and the broadcast state exact.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from artist_style_transfer_tpu.ops.norm import batch_norm_train as jbatch_norm_train
from artist_style_transfer_tpu_torch.parallel import (
    initialize_multihost,
    launch,
    make_global,
    make_mesh,
    per_host_batch_slice,
    shard_batch,
    spatial_size,
)
from artist_style_transfer_tpu_torch.parallel.distributed import _cluster_detected
from artist_style_transfer_tpu_torch.parallel.launch import free_port
from artist_style_transfer_tpu_torch.parallel.mesh import data_parallel
from tests.test_torch_data import one_torch_thread  # noqa: F401

CLUSTER_VARS = ("TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
                "PROCESS_ID", "MASTER_ADDR", "RANK")


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of this process alone, torn down on exit."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def no_cluster(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)


# --- JAX's tests/test_distributed.py -------------------------------------------------


def test_initialize_multihost_noop_single_process(no_cluster, monkeypatch):
    # a single-host TPU VM exports one hostname; that is no cluster
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host0")
    assert initialize_multihost() is False
    assert not dist.is_initialized()


def test_cluster_detection_requires_multiple_workers(no_cluster, monkeypatch):
    assert _cluster_detected() is False
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host0")
    assert _cluster_detected() is False
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host0,host1")
    assert _cluster_detected() is True
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert _cluster_detected() is False
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert _cluster_detected() is True
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun
    assert _cluster_detected() is True


def test_initialize_multihost_needs_a_coordinator_for_a_cluster(no_cluster, monkeypatch):
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(RuntimeError, match="coordinator address"):
        initialize_multihost(backend="gloo")
    assert not dist.is_initialized()


def test_initialize_multihost_from_torchrun_env(no_cluster, monkeypatch):
    """torchrun's variables join a world of one over gloo (no GPU is bound for gloo)."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert initialize_multihost(backend="gloo") is False  # one process: no multi-host
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert initialize_multihost(backend="gloo") is False  # joined already: a no-op
        assert per_host_batch_slice(32) == (32, 0)
    finally:
        dist.destroy_process_group()


def test_per_host_batch_slice_single_process():
    host, offset = per_host_batch_slice(32)
    assert host == 32 and offset == 0


def _slices(mesh, batches):
    return [per_host_batch_slice(b) for b in batches]


def test_per_host_batch_slice_divisibility():
    """Over two ranks each takes its half; an odd batch raises on every rank."""
    assert (launch(_slices, 2, [8, 2], backend="gloo", device="cpu")
            == [[(4, 0), (1, 0)], [(4, 4), (1, 1)]])
    with pytest.raises(RuntimeError, match="not divisible by 2 hosts"):
        launch(_slices, 2, [7], backend="gloo", device="cpu")


# --- the mesh -------------------------------------------------------------------------


def test_mesh_shapes_without_a_group():
    m = make_mesh(device="cpu")
    assert (m.shape, m.size, m.rank, m.group, m.backend) == ((1,), 1, 0, None, None)
    assert make_mesh((1, 1), ("data", "space"), device="cpu").axis_size("space") == 1
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        make_mesh(shape=(2,), device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        make_mesh(shape=(1, 1), device="cpu")
    assert spatial_size(None) == 1 and spatial_size(m) == 1
    t = torch.arange(4.0)
    assert m.all_reduce_(t) is t and m.all_gather(t)[0] is t and m.broadcast_object(3) == 3
    assert make_global(m, t) is t and make_global(None, t) is t
    assert shard_batch(t, None) is t and torch.equal(shard_batch(t, m), t)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()  # None means CUDA


def _mesh_rank(mesh, shapes):
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device)}
    t = torch.tensor([float(mesh.rank + 1)])
    out["sum"] = float(mesh.all_reduce_(t.clone()))
    out["max"] = float(mesh.all_reduce_(t.clone(), "max"))
    out["gather"] = [float(g) for g in mesh.all_gather(t)]
    out["bcast"] = float(mesh.broadcast_(t.clone()))
    out["obj"] = mesh.broadcast_object({"from": mesh.rank})
    x = torch.arange(8.0).view(4, 2)
    out["shard"] = shard_batch(x, mesh).tolist()
    out["np_shard"] = shard_batch(np.arange(4), mesh).tolist()
    # replicated state: every rank ends with rank 0's, whatever it started with
    net = torch.nn.Linear(2, 2)
    with torch.no_grad():
        net.weight.fill_(mesh.rank)
    tree = make_global(mesh, {"net": net, "a": np.full(3, mesh.rank), "t": [torch.ones(2) * mesh.rank],
                              "n": 5})
    out["global"] = (float(net.weight.sum()), tree["a"].tolist(), tree["t"][0].tolist(), tree["n"])
    out["shapes"] = []
    for shape, names in shapes:
        try:
            m = make_mesh(shape, names, device="cpu")
            out["shapes"].append((m.shape, m.rank, m.size))
        except ValueError as e:
            out["shapes"].append(str(e))
    mesh.barrier()
    return out


def test_mesh_collectives_and_make_global_over_four_ranks():
    shapes = [((4,), ("data",)), ((2, 2), ("data", "model")), ((8,), ("data",)), ((2,), ("data",))]
    got = launch(_mesh_rank, 4, shapes, backend="gloo", device="cpu")
    for r, o in enumerate(got):
        assert (o["rank"], o["size"], o["backend"], o["device"]) == (r, 4, "gloo", "cpu")
        assert (o["sum"], o["max"], o["gather"], o["bcast"]) == (10.0, 4.0, [1.0, 2.0, 3.0, 4.0], 1.0)
        assert o["obj"] == {"from": 0}
        assert o["shard"] == [[2 * r, 2 * r + 1]] and o["np_shard"] == [r]
        assert o["global"] == (0.0, [0, 0, 0], [0.0, 0.0], 5)
        assert o["shapes"][0] == ((4,), r, 4) and o["shapes"][1] == ((2, 2), r, 4)
        assert o["shapes"][2] == "mesh shape (8,) needs 8 devices, have 4"
        # a smaller mesh takes the first ranks, as JAX takes the first devices
        assert o["shapes"][3] == (((2,), r, 2) if r < 2 else f"rank {r} is not one of the "
                                  "mesh's ranks [0, 1]")


def test_data_parallel_refuses_a_space_axis():
    import dataclasses

    mesh = make_mesh((1,), device="cpu")
    assert data_parallel(mesh) is mesh and data_parallel(None) is None
    wide = dataclasses.replace(mesh, axis_names=("data", "space"), shape=(1, 2))
    with pytest.raises(NotImplementedError, match="item 12b"):
        data_parallel(wide)


def _fails(mesh, which):
    if mesh.rank == which:
        raise KeyError("rank failure on purpose")
    mesh.barrier()  # the others wait here until the launcher stops them
    return mesh.rank


def _dies(mesh):
    if mesh.rank == 1:
        os._exit(3)
    return mesh.rank


def test_launch_fails_when_any_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank failure on purpose"):
        launch(_fails, 2, 1, timeout_s=120, backend="gloo", device="cpu")
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        launch(_dies, 2, timeout_s=120, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="nprocs"):
        launch(_dies, 0, backend="gloo", device="cpu")


def test_launch_runs_on_the_card_over_nccl_unless_asked(monkeypatch):
    # The card by default: without CUDA the launch raises before it starts a rank.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch(_dies, 2)
    # NCCL unless gloo is named: NCCL on the CPU is refused, not swapped for gloo.
    with pytest.raises(ValueError, match="name backend='gloo'"):
        launch(_dies, 2, device="cpu")


# --- global-batch batch norm -----------------------------------------------------------


def _bn_rank(mesh, x, scale, bias, dy):
    from artist_style_transfer_tpu_torch.ops.norm import batch_norm_train

    xs = shard_batch(torch.as_tensor(x), mesh).clone().requires_grad_(True)
    s = torch.as_tensor(scale).clone().requires_grad_(True)
    b = torch.as_tensor(bias).clone().requires_grad_(True)
    y, mean, var = batch_norm_train(xs, s, b, mesh=mesh)
    (y * shard_batch(torch.as_tensor(dy), mesh)).sum().backward()
    ds, db = mesh.all_reduce_(s.grad.clone()), mesh.all_reduce_(b.grad.clone())
    return {"y": y.detach().numpy(), "mean": mean.numpy(), "var": var.numpy(),
            "dx": xs.grad.numpy(), "ds": ds.numpy(), "db": db.numpy()}


@pytest.mark.parametrize("shape", [(8, 6, 5, 4), (8, 6)], ids=["nchw", "nc"])
def test_global_batch_norm_matches_the_whole_batch(shape):
    """Two ranks of 4 images: the output, the statistics and the gradients of the whole
    batch of 8 (the port's single-process BN and JAX's BN over it)."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    bias = rng.normal(size=shape[1]).astype(np.float32)
    got = launch(_bn_rank, 2, x, scale, bias, dy, backend="gloo", device="cpu")
    from artist_style_transfer_tpu_torch.ops.norm import batch_norm_train

    xt = torch.as_tensor(x).requires_grad_(True)
    st = torch.as_tensor(scale).clone().requires_grad_(True)
    bt = torch.as_tensor(bias).clone().requires_grad_(True)
    y, mean, var = batch_norm_train(xt, st, bt)
    (y * torch.as_tensor(dy)).sum().backward()
    nhwc = (0, 2, 3, 1) if len(shape) == 4 else (0, 1)
    jy, jmean, jvar = jbatch_norm_train(jnp.asarray(x.transpose(nhwc)), jnp.asarray(scale),
                                        jnp.asarray(bias))
    back = (0, 3, 1, 2) if len(shape) == 4 else (0, 1)
    for r, o in enumerate(got):
        np.testing.assert_allclose(o["y"], y.detach().numpy()[4 * r: 4 * r + 4], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["y"], np.asarray(jy).transpose(back)[4 * r: 4 * r + 4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["dx"], xt.grad.numpy()[4 * r: 4 * r + 4], rtol=1e-5, atol=1e-5)
        for k, want in (("mean", mean), ("var", var), ("ds", st.grad), ("db", bt.grad)):
            np.testing.assert_allclose(o[k], want.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["mean"], np.asarray(jmean), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["var"], np.asarray(jvar), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var", "ds", "db"):  # the same on every rank, bit for bit
        assert all(np.array_equal(o[k], got[0][k]) for o in got), k


def space_mesh():
    """A mesh with a 'space' axis of 2 (built without ranks: the paths that refuse it do
    so before any collective)."""
    import dataclasses

    return dataclasses.replace(make_mesh(device="cpu"), axis_names=("data", "space"),
                               shape=(1, 2))
