"""Artist-classifier training over a ('data', 'space') mesh in the PyTorch port: the
train-mode banded ResNet-50 (``models.resnet.classifier_apply_train_rows``), one step's
synced loss, gradients and BN statistics (``train.classifier.classifier_grads``), and
``train_classifier`` over the mesh, on gloo ranks on the CPU.

JAX runs no training over 'space' on the CPU (``tests/test_torch_spatial_train.py``
says why), so the port is held against JAX's mesh-less ``train_classifier`` and its own
one process, on ``tests/test_torch_train_artist_classifier.py``'s separable data
(24 images, 32x32, 3 classes, B=8, lr 1e-5). Tolerances:

- ``train_classifier`` over (1, 2) and (2, 2), ``freeze_body`` True and False, 2 epochs
  on JAX's permutations: per-epoch losses within rtol 1e-3 of JAX's, the accuracies
  equal (the DP test's bar, ``tests/test_torch_parallel_classifier.py``); the ranks'
  parameters and BN running statistics bit-identical; the frozen convs bit-unchanged.
  The unfrozen run steps at lr 1e-7 (``LR`` says why), where AdamW's steps hardly depend
  on the body's gradients: it is a smoke check of the loop over the mesh, and the body's
  gradients are held against JAX by the next item;
- the unfrozen f64 step's banded gradients over (1, 2) and (2, 2) against
  ``jax.value_and_grad`` of JAX's single-device classifier loss on the same batch (f32:
  JAX's BN computes in f32): each leaf within 0.1 of its L2 norm (this net's f32
  gradients part from its f64 ones by up to 4.4% of a leaf's norm: measured), the BN
  statistics within 1e-3 of each leaf's largest;
- ``augment=True`` over (1, 2) against the one process: the banded augmentation is the
  one process's, cut to the rank's slice and rows, bit for bit, and the per-epoch losses
  within rtol 1e-3;
- one step over (1, 2) and (2, 2) against the one process: in f32 the loss within rtol
  1e-4 (a ReLU or pool decision of this ResNet-50 at 32x32 sits within f32 rounding of
  its boundary, so single f32 gradient entries part by up to half their leaf's largest,
  in the one process's own arithmetic as much as the bands': measured); in f64 the loss
  within rtol 1e-6 and every gradient and BN statistic within 1e-6 of its leaf's
  largest;
- the head's rules over (2, 2), in f64: its BN1d statistics reduce over the 'data'
  line alone, and its gradients, whole on each 'space' rank, are summed over the 'data'
  line alone. Each rule, broken in the ranks (over the whole mesh), moves the head's
  unbiased variance or its gradients off the one process's by far more than the bar.

Every launch has a time limit of its own, so a collective that one rank misses fails
the test instead of hanging the suite.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.models import resnet as jresnet
from artist_style_transfer_tpu.train import classifier as jclassifier
from artist_style_transfer_tpu.train.loop import epoch_permutation as jepoch_permutation
from artist_style_transfer_tpu_torch.parallel import launch, workers
from artist_style_transfer_tpu_torch.parallel.mesh import Mesh
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands
from artist_style_transfer_tpu_torch.train import classifier as tclassifier
from artist_style_transfer_tpu_torch.utils.jax_params import classifier_state_dict_from_jax
from tests.test_torch_classifier import numpy_params
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_train_artist_classifier import port_classifier, port_name, separable_data

LAUNCH_S = 240  # each launch's own limit: a missed collective fails, never hangs
# The unfrozen body's f32 trajectory at lr 1e-5 parts from its own f64 one by 3.5% of the
# loss at its second step (measured, in the one process as in the bands): Adam moves each
# noise-dominated gradient entry by +-lr whatever its size, and this net amplifies the
# difference. At lr 1e-7 the same runs stay within the bar.
LR = {True: 1e-5, False: 1e-7}
KW = dict(num_classes=3, num_epochs=2, batch_size=8, lr=1e-5, schedule="constant", val_fraction=0.25,
          seed=2, wordy=False)
FREEZE = (True, False)
TRAIN_SHAPES = {2: (1, 2), 4: (2, 2)}
STEP_SHAPE = {2: (1, 2), 4: (2, 2)}
LOCKSTEP = dict(steps=2, lr=1e-5)  # f64 steps of the whole body on one batch
FROZEN_CONVS = ("0.0.weight", "0.5.0.conv2.weight", "0.7.0.downsample.0.weight")


def params() -> dict:
    return numpy_params(functools.partial(jresnet.init_classifier_params, num_classes=3), 0)


def perms() -> list[np.ndarray]:
    return [np.array(jepoch_permutation(2, e, 18)) for e in range(KW["num_epochs"])]


def step_setup(dtype, freeze_body: bool, model=None, **kw) -> dict:
    images, labels = separable_data()
    pick = np.random.default_rng(4).permutation(len(images))[:8]
    return {"model": port_classifier(params()) if model is None else model,
            "x": images[pick].astype(dtype), "y": labels[pick], "freeze_body": freeze_body,
            **kw}


def train_rank(mesh, shape, kw, order):
    """``train_classifier`` over a mesh of ``shape`` on JAX's permutations ``order``."""
    tclassifier.epoch_permutation = lambda seed, epoch, n: torch.from_numpy(order[epoch])
    images, labels = separable_data()
    return workers.train_classifier_rank(mesh, images, labels, kw, shape=shape)


def broken_step_rank(mesh, shape, setup, rule: str):
    """:func:`workers.classifier_step_rank` with one of the head's rules broken: "bn",
    the head's BN1d statistics over the whole mesh; "grad", the head's gradients summed
    over the whole mesh."""
    from artist_style_transfer_tpu_torch.models import resnet

    made = []
    real_mesh, real_bn, real_sync = (workers.space_mesh, resnet.batch_norm_train,
                                     tclassifier.sync_gradients)

    def whole(m):  # a 'data' line swapped for the whole mesh
        return made[0] if m is not None and m.axis_names == ("data",) else m

    workers.space_mesh = lambda m, s: made.append(real_mesh(m, s)) or made[-1]
    if rule == "bn":
        resnet.batch_norm_train = lambda h, w, b, eps, mesh=None: real_bn(h, w, b, eps,
                                                                          mesh=whole(mesh))
    else:
        tclassifier.sync_gradients = lambda p, losses, m, sharded: real_sync(p, losses, whole(m),
                                                                             sharded)
    try:
        return workers.classifier_step_rank(mesh, shape, setup)
    finally:
        workers.space_mesh, resnet.batch_norm_train, tclassifier.sync_gradients = (
            real_mesh, real_bn, real_sync)


BN_SHAPE = (4, 3, 1, 5)  # N, C, H, W: one row over 2 'space' ranks leaves a band empty


def bn_inputs() -> list[np.ndarray]:
    """x, the output's cotangent, gamma and beta, f64."""
    rng = np.random.default_rng(6)
    return [rng.standard_normal(BN_SHAPE) * 2 + 1, rng.standard_normal(BN_SHAPE),
            rng.uniform(0.5, 1.5, BN_SHAPE[1]), rng.uniform(-0.5, 0.5, BN_SHAPE[1])]


def batch_norm_rank(mesh, shape) -> dict:
    """Train-mode BN (``batch_norm_train(mesh=)``) on this rank's data slice's band of
    rows of :func:`bn_inputs`, and its backward of sum(y * cotangent)."""
    from artist_style_transfer_tpu_torch.ops.norm import batch_norm_train
    from artist_style_transfer_tpu_torch.parallel.mesh import shard_batch

    mesh = workers.space_mesh(mesh, shape)
    x, r, g, b = (torch.from_numpy(a) for a in bn_inputs())
    rows = slice(*RowBands.split(mesh.axis_mesh("space"), BN_SHAPE[2]).bounds())
    x = shard_batch(x, mesh)[:, :, rows].clone().requires_grad_()
    g, b = g.requires_grad_(), b.requires_grad_()
    y, mean, var = batch_norm_train(x, g, b, mesh=mesh)
    (y * shard_batch(r, mesh)[:, :, rows]).sum().backward()
    return {"rows": x.shape[2], "y": y.detach().numpy(), "mean": mean.numpy(),
            "var": var.numpy(), "dx": x.grad.numpy(), "dgamma": g.grad.numpy(),
            "dbeta": b.grad.numpy()}


def digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def slim(mesh, fn, args: tuple, kw: dict, whole: bool = False) -> dict:
    """``fn(mesh, *args, **kw)``'s result with each array of its "params" and "grads"
    replaced by a digest (the ranks' bit-identity needs no more), the arrays themselves
    kept on rank 0 under "whole" where ``whole``: a launch then returns a few MB, not the
    ResNet-50's weights a job and a rank."""
    out = fn(mesh, *args, **kw)
    big = {k: out.pop(k) for k in ("params", "grads") if k in out}
    if whole and mesh.rank == 0:
        out["whole"] = big
    return dict(out, **{k: {n: digest(a) for n, a in v.items()} for k, v in big.items()})


def jobs(ranks: int) -> list:
    """Every job of a launch; they share one model, which the launch pickles once."""
    shape, step = TRAIN_SHAPES[ranks], STEP_SHAPE[ranks]
    model = port_classifier(params())

    def job(fn, *args, whole=False):
        return (slim, (fn, args, {}, whole), {})

    out = [job(train_rank, shape, dict(KW, freeze_body=f, lr=LR[f], model=model), perms())
           for f in FREEZE]
    out += [job(workers.classifier_step_rank, step, step_setup(dt, f, model),
                whole=dt is np.float64) for dt in (np.float32, np.float64) for f in FREEZE]
    out.append(job(workers.classifier_step_rank, step,
                   step_setup(np.float64, False, model, **LOCKSTEP)))
    if ranks == 2:
        out.append(job(train_rank, shape, dict(KW, freeze_body=True, augment=True, model=model),
                       perms()))
    else:
        out += [job(broken_step_rank, step, step_setup(np.float64, False, model), rule,
                    whole=True) for rule in ("bn", "grad")]
    return out + [(batch_norm_rank, (step,), {})]


@pytest.fixture(scope="module")
def launches():
    """The 2- and 4-rank launches, at once (their ranks wait on gloo and on their
    start-up more than they compute)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(launch, workers.run_jobs, n, jobs(n), backend="gloo",
                               device="cpu", timeout_s=LAUNCH_S) for n in (2, 4)}
        return {n: run.result() for n, run in runs.items()}


@pytest.fixture(scope="module")
def two_ranks(launches):
    return launches[2]


@pytest.fixture(scope="module")
def four_ranks(launches):
    return launches[4]


@functools.lru_cache(maxsize=None)
def one_process(dtype, freeze_body: bool, steps: int = 1) -> dict:
    """:func:`workers.classifier_step_rank` in this process, no mesh (each case once)."""
    kw = LOCKSTEP if steps > 1 else {}
    return workers.classifier_step_rank(None, None, step_setup(dtype, freeze_body, **kw))


def ranks_of(two_ranks, four_ranks, ranks: int):
    return two_ranks if ranks == 2 else four_ranks


def assert_ranks_identical(runs: list[dict]) -> None:
    for other in runs[1:]:
        assert other["history"] == runs[0]["history"]
        assert other["params"] == runs[0]["params"]  # running statistics included


@pytest.mark.parametrize("freeze_body", FREEZE)
def test_train_classifier_over_space_matches_jax(two_ranks, four_ranks, freeze_body,
                                                 monkeypatch):
    images, labels = separable_data()
    _, jhist = jclassifier.train_classifier(images, labels, freeze_body=freeze_body,
                                            params=jax.tree.map(jnp.asarray, params()),
                                            **dict(KW, lr=LR[freeze_body]))
    start = port_classifier(params()).state_dict()
    for ranks in (2, 4):
        runs = [r[FREEZE.index(freeze_body)] for r in ranks_of(two_ranks, four_ranks, ranks)]
        hist = runs[0]["history"]
        np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"], rtol=1e-3,
                                   err_msg=str(ranks))
        assert hist["train_acc"] == jhist["train_acc"] and hist["val_acc"] == jhist["val_acc"]
        assert_ranks_identical(runs)
        for k in FROZEN_CONVS:
            assert (runs[0]["params"][k] == digest(start[k].numpy())) == freeze_body, k


def test_augment_over_space_is_the_one_process_augmentation(two_ranks, monkeypatch):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 12, 10, 3)).astype(
        np.float32))
    want = tclassifier.augment_batch(torch.Generator().manual_seed(7), x)
    cpu = torch.device("cpu")
    for d in range(2):
        for r in range(3):  # the ranks of a (2, 3) mesh, built without a process group
            mesh = Mesh(None, ("data", "space"), (2, 3), 3 * d + r, cpu, None)
            a, b = RowBands.split(Mesh(None, ("space",), (3,), r, cpu, None), 12).bounds()
            got = tclassifier.augment_batch(torch.Generator().manual_seed(7), x, mesh=mesh,
                                            rows=(a, b))
            assert torch.equal(got, want[2 * d: 2 * d + 2, a:b])
    # train_classifier(augment=True) over (1, 2) against the one process, same draws.
    monkeypatch.setattr(tclassifier, "epoch_permutation",
                        lambda seed, epoch, n: torch.from_numpy(perms()[epoch]))
    images, labels = separable_data()
    _, hist = tclassifier.train_classifier(images, labels, freeze_body=True, augment=True,
                                           model=port_classifier(params()), device="cpu", **KW)
    runs = [r[7] for r in two_ranks]
    np.testing.assert_allclose(runs[0]["history"]["train_loss"], hist["train_loss"], rtol=1e-3)
    assert runs[0]["history"]["train_acc"] == hist["train_acc"]
    assert_ranks_identical(runs)


def leaf_close(got: dict, want: dict, rel: float) -> list[str]:
    """The leaves of ``got`` off ``want`` by more than ``rel`` of the leaf's largest."""
    return [k for k, w in want.items()
            if np.abs(got[k] - w).max() > rel * max(np.abs(w).max(), 1e-30)]


@pytest.mark.parametrize("freeze_body", FREEZE)
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("ranks", [2, 4])
def test_step_over_space_matches_one_process(two_ranks, four_ranks, ranks, dtype, freeze_body):
    got_ranks = ranks_of(two_ranks, four_ranks, ranks)
    job = 2 + 2 * (dtype is np.float64) + FREEZE.index(freeze_body)
    want = one_process(dtype, freeze_body)
    got = got_ranks[0][job]
    if dtype is np.float32:
        np.testing.assert_allclose(got["metrics"][0, 0], want["metrics"][0, 0], rtol=1e-4)
    else:
        np.testing.assert_allclose(got["metrics"][0, 0], want["metrics"][0, 0], rtol=1e-6)
        grads = got["whole"]["grads"]
        assert grads.keys() == want["grads"].keys()
        assert leaf_close(grads, want["grads"], 1e-6) == []
        for i in range(2):
            assert leaf_close({k: v[i] for k, v in got["stats"].items()},
                              {k: v[i] for k, v in want["stats"].items()}, 1e-6) == []
    for r in got_ranks[1:]:
        np.testing.assert_array_equal(r[job]["metrics"], got["metrics"])
        assert r[job]["grads"] == got["grads"]


@functools.lru_cache(maxsize=None)
def jax_unfrozen_step() -> tuple[dict, dict]:
    """JAX's single-device gradients (port names and layouts) and BN statistics (port
    module names) of the unfrozen step's batch, as f64 numpy. JAX computes them in f32:
    its train-mode BN and that BN's backward cast to f32 whatever the input's dtype
    (``artist_style_transfer_tpu/ops/norm.py``)."""
    import optax

    setup = step_setup(np.float32, False)
    p = jax.tree.map(jnp.asarray, params())
    x, y = jnp.asarray(setup["x"]), jnp.asarray(setup["y"])

    def loss_fn(p, x, y):
        logits, stats = jresnet.classifier_apply_train(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), stats

    (_, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p, x, y)
    grads = {k: v.numpy().astype(np.float64) for k, v in
             classifier_state_dict_from_jax(jax.tree.map(np.asarray, grads)).items()}
    stats = {port_name(k): (np.asarray(m, np.float64), np.asarray(v, np.float64))
             for k, (m, v) in stats.items()}
    return grads, stats


def leaf_l2(got: dict, want: dict, rel: float) -> list[str]:
    """The leaves of ``got`` whose L2 distance from ``want`` exceeds ``rel`` of the
    leaf's L2 norm."""
    return [k for k, w in want.items()
            if np.linalg.norm(got[k] - w) > rel * max(np.linalg.norm(w), 1e-30)]


@pytest.mark.parametrize("ranks", [2, 4])
def test_unfrozen_step_over_space_matches_jax(two_ranks, four_ranks, ranks):
    """The body's banded backward against JAX: the unfrozen f64 step's synced gradients
    over (1, 2) and (2, 2) against JAX's single-device ``jax.value_and_grad`` of its
    classifier loss (``classifier_apply_train`` and the mean cross-entropy, as JAX
    ``train_classifier`` steps) on the same batch, each leaf within 0.1 of its L2 norm,
    and the BN statistics within 1e-3 of each leaf's largest. JAX's gradients are f32
    (its BN computes in f32), and this net's f32 gradients part from its f64 ones by up
    to 4.4% of a leaf's norm, evenly over the body (measured: JAX's, and the port's own
    one process's; the head's by 5.5e-4), so the bar is about twice that: it catches a
    body gradient that is wrong by a tenth of a leaf, which the lr 1e-7 trajectory
    above cannot."""
    want_grads, want_stats = jax_unfrozen_step()
    got = ranks_of(two_ranks, four_ranks, ranks)[0][5]
    grads = got["whole"]["grads"]
    assert set(grads) == {n for n, _ in port_classifier(params()).named_parameters()}
    assert leaf_l2(grads, {k: want_grads[k] for k in grads}, 0.1) == []
    assert got["stats"].keys() == want_stats.keys()
    for i in range(2):
        assert leaf_close({k: v[i] for k, v in got["stats"].items()},
                          {k: v[i] for k, v in want_stats.items()}, 1e-3) == []


@pytest.mark.parametrize("ranks", [2, 4])
def test_f64_steps_of_the_whole_body_match_one_process(two_ranks, four_ranks, ranks):
    """Two AdamW steps of the unfrozen net on one batch in f64: each step's loss within
    rtol 1e-6 of the one process's. (This net amplifies any rounding a hundredfold and
    more a step: in f32 it parts from its own f64 steps by 3.5% of the loss at the second
    step, in the one process as in the bands, and in f64 over (2, 2) the bands part from
    the one process by 9e-4 at the fourth: measured.)"""
    want = one_process(np.float64, False, LOCKSTEP["steps"])
    runs = [r[6] for r in ranks_of(two_ranks, four_ranks, ranks)]
    np.testing.assert_allclose(runs[0]["metrics"][:, 0], want["metrics"][:, 0], rtol=1e-6)
    for other in runs[1:]:
        np.testing.assert_array_equal(other["metrics"], runs[0]["metrics"])


def test_head_rules_over_two_by_two(four_ranks):
    """Over (2, 2) the head's BN1d statistics and gradients must not count a 'space' rank
    as more data: the right rules match the one process in f64 (the test above); each
    broken one moves what it governs."""
    want = one_process(np.float64, False)
    right, bn, grad = (four_ranks[0][j] for j in (5, 7, 8))
    head_grads = {k: v for k, v in want["grads"].items() if k.startswith("1.")}
    head_vars = {k: v[1] for k, v in want["stats"].items() if k.startswith("1.")}
    assert leaf_close(right["whole"]["grads"], head_grads, 1e-6) == []
    assert leaf_close({k: right["stats"][k][1] for k in head_vars}, head_vars, 1e-6) == []
    # the head's BN1d over the whole mesh: each feature counts twice, so the unbiased
    # variance is sq / (2n - 1), not sq / (n - 1)
    assert sorted(leaf_close({k: bn["stats"][k][1] for k in head_vars}, head_vars, 1e-2)) == \
        sorted(head_vars)
    # the head's gradients summed over the whole mesh: twice the one process's
    broken = grad["whole"]["grads"]
    assert sorted(leaf_close(broken, head_grads, 0.5)) == sorted(head_grads)
    assert leaf_close(broken, {k: 2 * v for k, v in head_grads.items()}, 1e-6) == []


@pytest.mark.parametrize("ranks", [2, 4])
def test_batch_norm_over_bands_with_an_empty_one(two_ranks, four_ranks, ranks):
    """The body's train-mode BN over (1, 2) and (2, 2) with one row an image, so one
    band of each 'space' line is empty: it joins both all-reduces with a count of 0; the
    statistics (the unbiased variance over the global count, 4 x 5 - 1) are the one
    process's and bit-identical on every rank, as the running statistics they update;
    the outputs and input gradients are the one process's, and gamma's and beta's parts
    add up to its gradients."""
    from artist_style_transfer_tpu_torch.ops.norm import batch_norm_train

    got = [r[-1] for r in ranks_of(two_ranks, four_ranks, ranks)]
    d = ranks // 2
    assert [g["rows"] for g in got] == [1, 0] * d
    x, r, gamma, beta = (torch.from_numpy(a) for a in bn_inputs())
    x, gamma, beta = (t.requires_grad_() for t in (x, gamma, beta))
    y, mean, var = batch_norm_train(x, gamma, beta)
    (y * r).sum().backward()
    want_var = x.detach().permute(1, 0, 2, 3).reshape(BN_SHAPE[1], -1).var(dim=1, unbiased=True)
    np.testing.assert_allclose(var.numpy(), want_var.numpy(), rtol=1e-12)
    for g in got:
        np.testing.assert_array_equal(g["mean"], got[0]["mean"])
        np.testing.assert_array_equal(g["var"], got[0]["var"])
    np.testing.assert_allclose(got[0]["mean"], mean.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[0]["var"], var.numpy(), rtol=1e-12)
    per = BN_SHAPE[0] // d
    for i in range(d):  # the data slices' rows (a band of one row; the other empty)
        np.testing.assert_allclose(got[2 * i]["y"], y.detach().numpy()[i * per: (i + 1) * per],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got[2 * i]["dx"], x.grad.numpy()[i * per: (i + 1) * per],
                                   rtol=1e-10, atol=1e-12)
    for key, want in (("dgamma", gamma.grad), ("dbeta", beta.grad)):
        np.testing.assert_allclose(sum(g[key] for g in got), want.numpy(), rtol=1e-10)
