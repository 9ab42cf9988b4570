"""Whole runs of each cell at small sizes on the CPU: the reference against the port, the
result line, and each fault that a cell can have, planted under the timed path, coming
out as not correct. The int8 control (int4) is caught here; the f32 control (TF32) needs
the card."""

from __future__ import annotations

import time

import pytest
import torch

from benchlib import faults, generators, manifest, runner
from reference import nets

# At 32x32 and 16 images the CPU's f32 rounding, grown through Adam's normalized steps,
# moves the median leaf's change after three steps by up to 5e-4 (in f64 the port and the
# reference agree to 2e-9): the small training run checks the first step's change.
SMALL = {
    "train_cycle": {"size": 32, "batch": 4, "content": 16, "paintings": 4, "check_steps": 1},
    "evaluate": {"images": 5, "size": 64, "batch": 4, "crop": 32, "warmup_images": 4},
    "stylize": {"images": 8, "size": 64, "batch": 4},
}
M = manifest.manifest()
CELLS = [w["name"] for w in M["workloads"]]
SEED = 2**31 + 17


def _traffic(cell: str) -> dict:
    traffic = manifest.traffic(manifest.cell(cell, M)["traffic"])
    traffic["job"].update(SMALL[traffic["generator"]])
    return traffic


def _run(cell: str, seed: int = SEED) -> dict:
    return runner.run_cell(cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter(), 4,
                           traffic=_traffic(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checked"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    e2e = {m["name"] for m in manifest.metrics_for(cell, "end_to_end", M)}
    assert set(r["metrics"]) == e2e and all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checked"


FAULTS = [(cell, f) for cell in CELLS
          for f in faults.BY_GENERATOR[_traffic(cell)["generator"]]]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_caught(cell, fault):
    with faults.BY_GENERATOR[_traffic(cell)["generator"]][fault]():
        r = _run(cell)
    assert not r["correct"], r["checked"]


def _control_fails(cell: str, device: torch.device):
    r = runner.run_cell(cell, SEED, 0.0, False, device, time.perf_counter(), 4,
                        traffic=_traffic(cell), readings=True)
    limits = manifest.limits(cell)
    assert r["correct"], r["checked"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "int8" in c])
def test_int8_control_is_caught(cell):
    _control_fails(cell, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught_on_the_card(cell, cuda_device):
    _control_fails(cell, cuda_device)


def test_training_check_reads_the_windows_call():
    """The compared training numbers come from ``epoch_fn`` itself: an epoch that takes
    the wrong rows of its permutation fails the check."""
    import dataclasses
    from unittest import mock

    from artist_style_transfer_tpu_torch.train import loop

    make = loop.make_step_fns

    def wrong_rows(*args, **kwargs):
        fns = make(*args, **kwargs)
        epoch = fns.epoch_fn
        return dataclasses.replace(
            fns, epoch_fn=lambda data, r22, perm, step: epoch(data, r22, perm.flip(0), step))

    cell = next(c for c in CELLS if _traffic(c)["generator"] == "train_cycle")
    with mock.patch.object(loop, "make_step_fns", wrong_rows):
        r = _run(cell)
    assert not r["correct"], r["checked"]


def test_reference_nets_against_the_port():
    from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier
    from artist_style_transfer_tpu_torch.models.resnet_q import quantize_classifier
    from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
    from artist_style_transfer_tpu_torch.models.transformer_q import quantize_transformer
    from artist_style_transfer_tpu_torch.models.vgg import VGG16Features
    from benchlib import inputs

    cpu = torch.device("cpu")
    init = manifest.config("transformernet-f32", M)["assumed"]["init"]
    t, v, c = (inputs.transformer_weights(3, cpu, init), inputs.vgg_weights(3, cpu),
               inputs.classifier_weights(3, cpu))
    x = inputs.images(3, "x", 2, 32, cpu)
    model = generators.load_net(TransformerNet, t, cpu)
    with torch.no_grad():
        y = nets.transformer(t, x)
        assert torch.allclose(model(x.float()), y, rtol=1e-4, atol=1e-3)
        feats = generators.load_net(VGG16Features, v, cpu)(y - torch.tensor(nets.CAFFE_BGR_MEAN))
        for k, f in nets.vgg16(v, y).items():
            assert torch.allclose(feats[k], f, rtol=1e-4, atol=1e-3 * float(f.abs().max()))
        clf = generators.load_net(ResNet50Classifier, c, cpu)
        z = nets.eval_input(y, 16)
        assert torch.allclose(clf(z), nets.classifier(c, z), rtol=1e-4, atol=1e-4)
        scales = nets.calibrate(t, x.float(), 127)
        q = quantize_transformer(model, x.float().numpy())
        got = q(x, accum=torch.bfloat16).float()
        assert (got - nets.transformer_int8(t, scales, x).float()).abs().max() <= 1.0
        qc = quantize_classifier(clf)
        assert torch.allclose(qc(z).float(), nets.classifier_int8(nets.quantize_classifier(c), z).float(),
                              atol=2e-2 * float(clf(z).abs().max()))
