"""The port's spans (``utils.trace.span``) on the CPU: the ``ast:`` ranges that
``evaluate_with_classifier``, the training step and the mesh's collectives record under
a running profiler, how many a call makes, how they nest, and that with no profiler
running no span enters ``record_function``.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier
from artist_style_transfer_tpu_torch.models.resnet import init_classifier
from artist_style_transfer_tpu_torch.models.transformer import init_transformer
from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
from artist_style_transfer_tpu_torch.parallel.mesh import make_mesh
from artist_style_transfer_tpu_torch.train.loop import (
    make_optimizer,
    make_step_fns,
    precompute_content_relu2_2,
)
from artist_style_transfer_tpu_torch.train.styles import build_style_targets
from artist_style_transfer_tpu_torch.utils import trace
from tests.test_torch_distributed import world_of_one

SIZE = 32
IMAGES, BATCH = 5, 2  # 3 batches, the last one padded
STEPS = 2


def traced(fn):
    """[(span name, name of its innermost ``ast:`` ancestor or None)] of what ``fn()``
    records under the profiler, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for ev in prof.events():
        if ev.device_type.name != "CPU" or not ev.name.startswith(trace.PREFIX):
            continue
        up = ev.cpu_parent
        while up is not None and not up.name.startswith(trace.PREFIX):
            up = up.cpu_parent
        out.append((ev.name[len(trace.PREFIX):], up and up.name[len(trace.PREFIX):]))
    return out


def run_eval(quantize: bool, mesh=None):
    model = init_transformer(torch.Generator().manual_seed(0))
    clf = init_classifier(torch.Generator().manual_seed(1))
    images = (np.random.default_rng(2).random((IMAGES, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    return lambda: evaluate_with_classifier(
        model, clf, list(images), 7, batch_size=BATCH, wordy=False, quantize=quantize,
        crop_size=16, mesh=mesh, device="cpu")


def run_epoch():
    rng = np.random.default_rng(3)
    vgg = init_vgg16(torch.Generator().manual_seed(1))
    model = init_transformer(torch.Generator().manual_seed(0))
    paintings = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    targets = build_style_targets("cycle", vgg, "A", paintings=paintings)
    opt, sched = make_optimizer(model.parameters(), 0.01, 1e-4, 2, 2, STEPS)
    fns = make_step_fns("cycle", model, vgg, targets, opt, sched, content_weight=17.0,
                        style_weight=25.0, batch_size=BATCH, num_content=BATCH * STEPS)
    content = torch.as_tensor(rng.uniform(0, 255, (BATCH * STEPS, SIZE, SIZE, 3)),
                              dtype=torch.float32)
    r22 = precompute_content_relu2_2(vgg, content)
    return lambda: fns.epoch_fn(content, r22, np.arange(BATCH * STEPS), 0)


@pytest.mark.parametrize("variant", ["f32", "int8", "int8_world_of_one"])
def test_eval_spans_a_call(variant):
    batches = -(-IMAGES // BATCH)
    if variant == "int8_world_of_one":
        with world_of_one():
            spans = traced(run_eval(True, make_mesh(device="cpu")))
    else:
        spans = traced(run_eval(variant == "int8"))
    want = {"eval.stage": batches, "eval.h2d": batches, "eval.logits": batches,
            "eval.fetch": batches}
    if variant != "f32":
        want["eval.quantize"] = 1
    if variant == "int8_world_of_one":
        # the int8 classifier's dynamic scales (a max over the ranks, a quantized conv
        # at a time), and each batch's all-gather of its predictions
        collectives = collections.Counter(p for n, p in spans if n == "mesh.collective")
        assert set(collectives) == {"eval.logits", "eval.fetch"}
        assert collectives["eval.fetch"] == batches and collectives["eval.logits"] > batches
        spans = [s for s in spans if s[0] != "mesh.collective"]
    assert dict(collections.Counter(name for name, _ in spans)) == want
    assert {parent for _, parent in spans} == {None}
    # each batch's spans in order: stage, copy, logits, fetch
    order = [name for name, _ in spans if name != "eval.quantize"]
    assert order == ["eval.stage", "eval.h2d", "eval.logits", "eval.fetch"] * batches


def test_epoch_spans_a_step():
    spans = traced(run_epoch())
    counts = collections.Counter(name for name, _ in spans)
    assert dict(counts) == {"train.batch": STEPS, "train.step": STEPS, "train.loss": STEPS,
                            "train.backward": STEPS, "train.update": STEPS}
    assert set(spans) == {("train.batch", None), ("train.step", None),
                          ("train.loss", "train.step"), ("train.backward", "train.step"),
                          ("train.update", "train.step")}
    assert [name for name, _ in spans] == ["train.batch", "train.step", "train.loss",
                                           "train.backward", "train.update"] * STEPS


def test_no_profiler_enters_no_span(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    eval_call, epoch = run_eval(True), run_epoch()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    eval_call()
    epoch()
    with world_of_one():
        make_mesh(device="cpu").all_reduce_(torch.ones(3))
