"""The streamed corpus of the PyTorch port on the CPU: ``content_file_stream`` against
the JAX package's on the same directory, ``device_prefetch``, and ``train()`` over a
stream against ``train()`` over the resident corpus.

Tolerances: the batches equal JAX's exactly (same files, same decoder). A stream
that replays the resident permutation gives per-epoch losses within rtol 1e-3 of
the resident run, JAX's ``tests/test_stream.py`` tolerance: the streamed step
computes each batch's content features in the step, the resident path in chunks
of 16, so the convolutions may sum in another order, and Adam amplifies that.
"""

import json
import warnings

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from artist_style_transfer_tpu.data import native_loader as jnative
from artist_style_transfer_tpu.data.stream import content_file_stream as jax_stream
from artist_style_transfer_tpu_torch.data import content_file_stream, device_prefetch
from artist_style_transfer_tpu_torch.data import native_loader as tnative
from artist_style_transfer_tpu_torch.data import stream as tstream
from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
from artist_style_transfer_tpu_torch.train import train
from artist_style_transfer_tpu_torch.train.loop import epoch_permutation
from tests.test_torch_data import jax_native_loader, one_torch_thread  # noqa: F401
from tests.test_torch_distributed import world_of_one

SIZE = 32


@pytest.fixture(scope="module")
def content_dir(tmp_path_factory):
    """7 JPEGs: a ragged tail under batch 2, 4 and 3."""
    d = tmp_path_factory.mktemp("content")
    rng = np.random.default_rng(5)
    for i in range(7):
        cv2.imwrite(str(d / f"c{i}.jpg"), rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def hooks():
    rng = np.random.default_rng(11)
    return dict(paintings=rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32),
                vgg=init_vgg16(torch.Generator().manual_seed(1)), device="cpu", wordy=False)


# --- content_file_stream against JAX ---------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "cv2"])
@pytest.mark.parametrize("procs,batch,cap", [
    ((1, 0), 4, None), ((1, 0), 3, 5), ((2, 0), 4, None), ((2, 1), 4, None),
    ((2, 1), 2, 5), ((3, 2), 3, None)])
def test_content_file_stream_matches_jax(content_dir, monkeypatch, native, procs, batch, cap):
    if native and not tnative.available():
        pytest.skip(f"native loader unavailable: {tnative.load_error}")
    if native:  # JAX's loader loads the same library, whatever another worker builds
        assert jax_native_loader()
    monkeypatch.setattr(jnative, "available", lambda: native)
    monkeypatch.setattr(tnative, "available", lambda: native)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        want = jax_stream(content_dir, batch, 16, 20, content_data_size=cap, seed=3, _procs=procs)
        got = content_file_stream(content_dir, batch, 16, 20, content_data_size=cap, seed=3,
                                  _procs=procs)
    assert len(warned) in (0, 2) and got.decoder == ("native" if native else "cv2")
    for epoch in range(2):
        a, b = list(got(epoch)), list(want(epoch))
        assert [x.shape for x in a] == [x.shape for x in b] and len(a) > 0
        for x, y in zip(a, b):
            assert x.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_content_file_stream_default_procs_and_ragged_tail(content_dir):
    one = content_file_stream(content_dir, 4, 16, 16, seed=3)
    assert [b.shape[0] for b in one(0)] == [4, 3]  # the ragged 3 kept for one process
    with pytest.warns(UserWarning, match="ragged"):
        two = content_file_stream(content_dir, 4, 16, 16, seed=3, _procs=(2, 0))
    assert [b.shape[0] for b in two(0)] == [2]
    with pytest.raises(ValueError, match="not divisible"):
        content_file_stream(content_dir, 3, 16, 16, _procs=(2, 0))


def test_content_file_stream_refuses_undecodable_files(tmp_path):
    content, empty = tmp_path / "content", tmp_path / "empty"
    content.mkdir()
    empty.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        cv2.imwrite(str(content / f"c{i}.jpg"), rng.integers(0, 256, (20, 20, 3), dtype=np.uint8))
    (content / "junk.jpg").write_bytes(b"nope")
    stream = content_file_stream(str(content), 2, 16, 16, seed=3)
    with pytest.raises(RuntimeError, match="undecodable content file .*junk.jpg"):
        list(stream(0))
    with pytest.raises(ValueError, match="no files"):
        content_file_stream(str(empty), 2, 16, 16)


def test_content_file_stream_decodes_ahead_boundedly(content_dir, monkeypatch):
    """Batches are decoded ahead of the one taken, at most DECODE_AHEAD of them, and
    yielded in order; closing the generator early stops the pool."""
    monkeypatch.setattr(tstream, "DECODE_AHEAD", 2)
    stream = content_file_stream(content_dir, 1, 8, 8, seed=3)
    decoded = []
    real = stream.decode
    stream.decode = lambda paths: (decoded.append(paths[0]), real(paths))[1]
    it = stream(0)
    first = next(it)
    assert 1 <= len(decoded) <= 2
    want = stream.batch_paths(0)
    np.testing.assert_array_equal(first, real(want[0]))
    rest = list(it)
    assert len(rest) == 6 and decoded == [p[0] for p in want]
    it = stream(1)
    next(it)
    it.close()  # the finally shuts the pool down


# --- device_prefetch -------------------------------------------------------------------


def test_device_prefetch_order_and_bounded_buffer():
    pulled = []

    def gen():
        for i in range(8):
            pulled.append(i)
            yield np.full((2, 4, 4, 3), i, np.float32)

    it = device_prefetch(gen(), buffer_size=2, device="cpu")
    first = next(it)
    assert len(pulled) == 3  # 2 primed + 1 refill: never the whole corpus
    assert isinstance(first, torch.Tensor) and first.dtype == torch.float32
    assert float(first[0, 0, 0, 0]) == 0.0 and not first.is_pinned()
    next(it)
    assert len(pulled) == 4
    rest = list(it)
    assert [float(r[0, 0, 0, 0]) for r in rest] == [2, 3, 4, 5, 6, 7] and len(pulled) == 8
    assert [float(b[0, 0, 0, 0]) for b in device_prefetch(gen(), 5, "cpu")] == list(range(8))


def test_device_prefetch_refusals_at_call_time():
    with pytest.raises(ValueError, match="buffer_size"):
        device_prefetch(iter([np.zeros((1,), np.float32)]), buffer_size=0, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        device_prefetch(iter([]), sharding=object(), device="cpu")
    # a world of one: this rank's slices, on its device, as without a mesh
    from artist_style_transfer_tpu_torch.parallel import make_mesh

    with world_of_one():
        batches = [np.full((2, 1), i, np.float32) for i in range(3)]
        got = list(device_prefetch(iter(batches), sharding=make_mesh(device="cpu"), device="cpu"))
        assert [torch.equal(g, torch.from_numpy(b)) for g, b in zip(got, batches)] == [True] * 3
        with pytest.raises(ValueError, match="device"):
            device_prefetch(iter([]), sharding=make_mesh(device="cpu"), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device_prefetch(iter([]))  # None means CUDA
    assert list(device_prefetch(iter([]), device="cpu")) == []


# --- train() over a stream -------------------------------------------------------------


def test_streamed_train_matches_resident(hooks):
    """The resident permutation replayed as a stream, the ragged final batch included."""
    corpus = np.random.default_rng(12).uniform(0, 255, (5, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(hooks, num_epochs=2, batch_size=2, content_data_size=5, seed=2, model_dir=None)
    resident_model, resident = train("cycle", "A", content_images=corpus, **kw)

    def replay(epoch):
        perm = epoch_permutation(2, epoch, 5).numpy()
        for s in range(0, 5, 2):
            yield corpus[perm[s : s + 2]]

    streamed_model, streamed = train("cycle", "A", content_stream=replay, **kw)
    np.testing.assert_allclose(streamed, resident, rtol=1e-3)
    lr = 0.0024
    for a, b in zip(resident_model.parameters(), streamed_model.parameters()):
        d = (a - b).double()
        assert torch.sqrt((d * d).mean()) < 1.5 * lr, "RMS parameter drift above the update scale"


def test_streamed_epoch_counts_actual_batches_and_logs(hooks, content_dir, tmp_path):
    """A stream shorter than the nominal steps of content_data_size: per-batch records and
    throughput count the batches that ran; the epoch records the wait on the stream and
    the data record names the decoder."""
    stream = content_file_stream(content_dir, 2, SIZE, SIZE, content_data_size=4, seed=2)
    _, losses = train("random", "A", num_epochs=2, batch_size=2, content_data_size=64,
                      content_stream=stream, model_dir=str(tmp_path), log_every_batches=1,
                      save_every=0, **hooks)
    assert np.isfinite(losses).all() and losses[-1, 2] < losses[0, 2]
    events = [json.loads(line) for line in open(tmp_path / "A" / "random" / "metrics.jsonl")]
    assert sum(e["event"] == "batch" for e in events) == 4  # 2 batches x 2 epochs, not 32
    epochs = [e for e in events if e["event"] == "epoch"]
    assert len(epochs) == 2 and all(e["stream_wait_secs"] >= 0 for e in epochs)
    data = next(e for e in events if e["event"] == "data")
    assert data["content"] == {"source": "stream", "decoder": stream.decoder}


def test_streamed_train_refuses_an_empty_epoch(hooks):
    with pytest.raises(ValueError, match="no batches"):
        train("cycle", "A", num_epochs=1, batch_size=2, content_data_size=4,
              content_stream=lambda epoch: iter(()), model_dir=None, **hooks)


def test_stream_step_fn_matches_the_resident_step(hooks):
    """One streamed step equals one resident step from the same state: the content
    relu2_2 from the f32 VGG, the step counter, the labels of a short batch."""
    from artist_style_transfer_tpu_torch.models.transformer import init_transformer
    from artist_style_transfer_tpu_torch.train.loop import (
        make_optimizer,
        make_step_fns,
        precompute_content_relu2_2,
    )
    from artist_style_transfer_tpu_torch.train.styles import build_style_targets

    batch = torch.as_tensor(np.random.default_rng(3).uniform(0, 255, (2, SIZE, SIZE, 3)),
                            dtype=torch.float32)
    out = []
    for streamed in (True, False):
        model = init_transformer(torch.Generator().manual_seed(0))
        targets = build_style_targets("cycle", hooks["vgg"], "A", paintings=hooks["paintings"])
        opt, sched = make_optimizer(model.parameters(), 0.01, 1e-4, 2, 2, 1)
        fns = make_step_fns("cycle", model, hooks["vgg"], targets, opt, sched,
                            content_weight=17.0, style_weight=25.0, batch_size=2, num_content=2)
        if streamed:
            out.append(torch.stack([fns.stream_step_fn(batch, s) for s in (0, 1)]))
        else:
            r22 = precompute_content_relu2_2(hooks["vgg"], batch)
            out.append(torch.stack([fns.step_fn(batch, r22, s) for s in (0, 1)]))
    torch.testing.assert_close(out[0], out[1], rtol=1e-6, atol=0)
