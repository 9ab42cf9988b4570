"""Classifier evaluation through ``infer.evaluate.evaluate_with_classifier``, as
``inference.py --no-display`` calls it: the whole corpus, a list of uint8 HWC BGR images,
in one call, ``wordy=False``; ``quantize`` from the configuration's precision (int8: both
nets quantized inside every call, the stylizer calibrated on the corpus's first two
images). A unit is one call.

The logits are the program's outputs that are judged: the module's ``eval_logits``, which
the call runs once a batch, is wrapped by a recorder that keeps each batch's logits on
the device, untouched, until the check.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import inputs, work
from benchlib.generators import Cell, load_net, restore_tf32, set_tf32, sync
from reference import nets


class Evaluate(Cell):
    span = "portbench:evaluate_with_classifier"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from artist_style_transfer_tpu_torch.infer import evaluate
        from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier
        from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
        from artist_style_transfer_tpu_torch.ops.precision import set_precision

        set_precision("highest")
        self.int8 = cfg["precision"] == "int8"
        self.job = job = dict(traffic["job"])
        self.device = device
        self.images_per_unit = job["images"]
        self.steps_per_unit = -(-job["images"] // job["batch"])
        self.trace_units = traffic["trace_units"]
        self.t_sd = inputs.transformer_weights(seed, device, cfg["assumed"]["init"])
        self.c_sd = inputs.classifier_weights(seed, device)
        corpus = inputs.images(seed, "corpus", job["images"], job["size"], device).cpu().numpy()
        self.corpus = list(corpus)  # what a decoder hands over: one HWC array an image
        self.model = load_net(TransformerNet, self.t_sd, device)
        self.clf = load_net(ResNet50Classifier, self.c_sd, device)
        self.evaluate = evaluate
        self.logits: list[torch.Tensor] = []
        program_eval_logits = evaluate.eval_logits

        def recorder(*args, **kwargs):
            out = program_eval_logits(*args, **kwargs)
            self.logits.append(out)
            return out

        evaluate.eval_logits = recorder
        self._restore = lambda: setattr(evaluate, "eval_logits", program_eval_logits)
        self._call(self.corpus[: job["warmup_images"]])  # warm-up: the window's shapes
        self.logits.clear()

    def _call(self, images) -> float:
        job = self.job
        return self.evaluate.evaluate_with_classifier(
            self.model, self.clf, images, job["artist_index"], batch_size=job["batch"],
            wordy=False, quantize=self.int8, crop_size=job["crop"], device=self.device)

    def unit(self, i: int) -> None:
        with record_function(self.span):
            self._call(self.corpus)

    def work(self, peaks: dict) -> dict:
        job = self.job
        n, size, crop = job["images"], job["size"], job["crop"]
        acc = work.add_convs({}, work.transformer_convs(n, size, self.int8))
        work.add_convs(acc, work.classifier_convs(n, crop, self.int8))
        head = "bf16" if self.int8 else "f32"
        acc[head] = acc.get(head, 0.0) + work.head_flops(n)
        out = {}
        if self.int8:  # the calibration forward of every call, in f32
            work.add_convs(acc, work.transformer_convs(job["calib_images"], size, False))
            # K2 runs every batch at the full batch size, the padded last one too
            b = job["batch"]
            convs = work.transformer_convs(b, size, True)
            t_s, t_n = work.k2_bound(convs, 2, peaks)  # bf16 accumulators
            c_s, c_n = work.k2_bound(work.classifier_convs(b, crop, True), 2, peaks)  # bf16 dequant
            out = {"k2_bound_s": self.steps_per_unit * (t_s + c_s),
                   "k2_launches": self.steps_per_unit * (t_n + c_n)}
        return {"least_s": work.least_seconds(acc, peaks), **out}

    def free(self) -> None:
        self._restore()
        del self.model, self.clf

    def reference_logits(self, variant: str) -> torch.Tensor:
        """The reference's logits of the corpus, batched and padded as the call batches it
        (the dynamic int8 scales are a batch's); the control in the precision below."""
        job, dev = self.job, self.device
        qmax = 7 if variant == "control" and self.int8 else 127
        prev = set_tf32(variant == "control" and not self.int8)
        out = []
        try:
            with torch.no_grad():
                if self.int8:
                    calib = torch.as_tensor(np.stack(self.corpus[: job["calib_images"]]),
                                            dtype=torch.float32, device=dev)
                    scales = nets.calibrate(self.t_sd, calib, qmax)
                    qc = nets.quantize_classifier(self.c_sd, qmax)
                n, b = len(self.corpus), job["batch"]
                for j in range(0, n, b):
                    take = list(range(j, min(j + b, n)))
                    take += [take[-1]] * (b - len(take))
                    x = torch.as_tensor(np.stack([self.corpus[i] for i in take]), device=dev).float()
                    if self.int8:
                        y = nets.transformer_int8(self.t_sd, scales, x, qmax)
                        logits = nets.classifier_int8(qc, nets.eval_input(y, job["crop"]), qmax)
                    else:
                        y = nets.transformer(self.t_sd, x)
                        logits = nets.classifier(self.c_sd, nets.eval_input(y, job["crop"]))
                    out.append(logits[: min(b, n - j)].float())
        finally:
            restore_tf32(prev)
        return torch.cat(out)

    def program_logits(self) -> list[torch.Tensor]:
        """Each call's logits of the corpus, (images, classes)."""
        per_call = self.steps_per_unit
        if len(self.logits) % per_call:
            raise RuntimeError(f"{len(self.logits)} recorded batches is not a whole number of calls")
        n = self.images_per_unit
        return [torch.cat(self.logits[i:i + per_call]).float()[:n]
                for i in range(0, len(self.logits), per_call)]

    def check(self, variant: str = "reference") -> dict:
        ref = self.reference_logits("reference")
        got = [self.reference_logits("control")] if variant == "control" else self.program_logits()
        return compare(got, ref)


def compare(got: list[torch.Tensor], ref: torch.Tensor) -> dict:
    """logit_gap: the widest gap of any logit of any call from the reference's, over the
    largest |logit| of the reference's corpus."""
    if not got:
        return {"logit_gap": float("inf")}
    scale = float(ref.abs().max())
    return {"logit_gap": max(float((g - ref).abs().max()) for g in got) / scale}


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Evaluate:
    cell = Evaluate(cfg, traffic, seed, device)
    sync(device)
    return cell
