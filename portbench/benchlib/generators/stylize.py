"""Batch stylization through ``infer.stylize.stylize_int8``, as the served worker's
``_apply_params`` calls it: a host batch of uint8 images in, ``.cpu().numpy()`` of the
uint8 output. The TransformerNet is quantized once in set-up, calibrated on the corpus's
first images. A unit is one batch; the window cycles through the corpus's batches.

Outputs kept for the check: every batch of the window's first pass over the corpus, then
one batch of each later pass, picked from the seed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import inputs, work
from benchlib.generators import Cell, load_net, sync
from reference import nets


class Stylize(Cell):
    span = "portbench:stylize_int8"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from artist_style_transfer_tpu_torch.infer import stylize
        from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
        from artist_style_transfer_tpu_torch.models.transformer_q import quantize_transformer

        if cfg["precision"] != "int8":
            raise ValueError(f"the stylize generator runs int8 configurations, not {cfg['precision']}")
        self.job = job = dict(traffic["job"])
        self.device = device
        b = job["batch"]
        self.images_per_unit = b
        self.trace_units = traffic["trace_units"]
        self.t_sd = inputs.transformer_weights(seed, device, cfg["assumed"]["init"])
        corpus = inputs.images(seed, "corpus", job["images"], job["size"], device).cpu().numpy()
        self.batches = [np.ascontiguousarray(corpus[i:i + b]) for i in range(0, len(corpus), b)]
        self.calib = corpus[: job["calib_images"]].astype(np.float32)
        model = load_net(TransformerNet, self.t_sd, device)
        self.qmodel = quantize_transformer(model, self.calib)
        del model
        self.stylize = stylize
        self.rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
        self.kept: list[tuple[int, np.ndarray]] = []
        self._keep_at = set(range(len(self.batches)))
        self.unit(-1)  # warm-up: the window's shape
        self.kept.clear()

    def unit(self, i: int) -> None:
        with record_function(self.span):
            x = self.batches[i % len(self.batches)]
            y = self.stylize.stylize_int8(self.qmodel, x, device=self.device)
            with record_function("portbench:to_host"):
                out = y.cpu().numpy()
        if i in self._keep_at:
            self.kept.append((i % len(self.batches), out))

    def prepare_window(self, max_units: int) -> None:
        nb = len(self.batches)
        later = [p * nb + int(self.rng.integers(nb)) for p in range(1, max_units // nb + 1)]
        self._keep_at = set(range(nb)) | set(later)

    def work(self, peaks: dict) -> dict:
        job = self.job
        convs = work.transformer_convs(job["batch"], job["size"], True)
        k2_s, k2_n = work.k2_bound(convs, 2, peaks)  # bf16 accumulators
        return {"least_s": work.least_seconds(work.add_convs({}, convs), peaks),
                "k2_bound_s": k2_s, "k2_launches": k2_n}

    def free(self) -> None:
        del self.qmodel

    def reference_outputs(self, variant: str) -> list[np.ndarray]:
        qmax = 7 if variant == "control" else 127
        with torch.no_grad():
            calib = torch.as_tensor(self.calib, device=self.device)
            scales = nets.calibrate(self.t_sd, calib, qmax)
            return [nets.transformer_int8(self.t_sd, scales, torch.as_tensor(x, device=self.device),
                                          qmax).float().clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
                    for x in self.batches]

    def check(self, variant: str = "reference") -> dict:
        ref = self.reference_outputs("reference")
        got = (list(enumerate(self.reference_outputs("control"))) if variant == "control"
               else self.kept)
        return compare(got, ref)


def compare(got: list[tuple[int, np.ndarray]], ref: list[np.ndarray]) -> dict:
    """image_gap: the worst output image's mean absolute gap from the reference's, in
    uint8 levels."""
    if not got:
        return {"image_gap": float("inf")}
    worst = 0.0
    for b, out in got:
        d = np.abs(out.astype(np.int16) - ref[b].astype(np.int16))
        worst = max(worst, float(d.reshape(d.shape[0], -1).mean(axis=1).max()))
    return {"image_gap": worst}


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Stylize:
    cell = Stylize(cfg, traffic, seed, device)
    sync(device)
    return cell
