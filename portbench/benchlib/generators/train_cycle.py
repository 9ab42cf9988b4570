"""'cycle' training through the port's step functions, as ``train()`` builds them.

Set-up builds one set of step functions (TransformerNet, VGG16, the cycle targets through
K1, Adam with the per-step StepLR, the content corpus and its relu2_2 on the device) and
runs the first unit untimed: one ``epoch_fn`` over the first epoch's permutation from
step 0, the call that the window makes. Its returned losses are the program's losses of
the first steps; a hook on the program's optimizer reads the first gradient (from Adam's
first moment after step 1) and the parameters after step ``check_steps`` as the epoch
passes them. The same objects then serve the window. A unit is one ``epoch_fn`` over the
corpus and the host copy of its losses, the epoch's one sync, as ``train()`` runs it.
Every epoch's permutation is drawn here from the seed.
"""

from __future__ import annotations

import functools
import statistics

import torch
from torch.profiler import record_function

from benchlib import inputs, work
from benchlib.generators import Cell, load_net, restore_tf32, set_tf32, sync


def _perm(seed: int, epoch: int, n: int) -> torch.Tensor:
    gen = inputs.generator(seed, f"perm{epoch}", "cpu")
    return torch.randperm(n, generator=gen)


class TrainCycle(Cell):
    span = "portbench:epoch_fn"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
        from artist_style_transfer_tpu_torch.models.vgg import VGG16Features
        from artist_style_transfer_tpu_torch.ops.precision import set_precision
        from artist_style_transfer_tpu_torch.train import loop, styles

        if cfg["precision"] != "float32":
            raise ValueError(f"the 'cycle' generator runs float32 configurations, "
                             f"not {cfg['precision']}")
        set_precision("highest")  # f32 with TF32 off in cuBLAS and cuDNN
        self.job = job = dict(traffic["job"])
        self.device, self.seed = device, seed
        n, size, bsz = job["content"], job["size"], job["batch"]
        self.images_per_unit = n
        self.steps_per_unit = -(-n // bsz)
        self.trace_units = traffic["trace_units"]
        self.t_sd = inputs.transformer_weights(seed, device, cfg["assumed"]["init"])
        self.vgg_sd = inputs.vgg_weights(seed, device)
        self.content = inputs.images(seed, "content", n, size, device).float()
        self.paintings = inputs.images(seed, "paintings", job["paintings"], size, device).float()
        model = load_net(TransformerNet, self.t_sd, device)
        vgg = load_net(VGG16Features, self.vgg_sd, device)
        targets = styles.build_style_targets(
            "cycle", vgg, "portbench", paintings=self.paintings.cpu().numpy(), batch_size=bsz)
        opt, sched = loop.make_optimizer(model.parameters(), job["lr"], job["weight_decay"],
                                         job["num_epochs"], job["num_steps"], self.steps_per_unit)
        self.fns = loop.make_step_fns(
            "cycle", model, vgg, targets, opt, sched, content_weight=job["content_weight"],
            style_weight=job["style_weight"], batch_size=bsz, num_content=n)
        self.r22 = loop.precompute_content_relu2_2(vgg, self.content)
        self.model, self.vgg, self.opt = model, vgg, opt
        self.perm0 = _perm(seed, 0, n)
        self.base_step = 0
        self._checked_epoch(job["check_steps"])

    def _checked_epoch(self, steps: int) -> None:
        """The first unit, untimed: it warms up every shape of the window, and what it
        produces is what the check judges."""
        params = dict(self.model.named_parameters())
        b1, wd = self.job["betas"][0], self.job["weight_decay"]
        self.grad = self.delta = None
        seen = []

        def read_state(opt, args, kwargs):
            seen.append(None)
            if len(seen) == 1:
                # The gradient the optimizer got: its first moment is (1 - b1) (g + wd p0);
                # an optimizer that kept no moment got none.
                self.grad = {k: (opt.state[p]["exp_avg"] / (1 - b1) - wd * self.t_sd[k]).clone()
                             if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                             for k, p in params.items()}
            if len(seen) == steps:
                self.delta = {k: (p.detach() - self.t_sd[k]).clone() for k, p in params.items()}

        hook = self.opt.register_step_post_hook(read_state)
        try:
            out = self._epoch(self.perm0)
        finally:
            hook.remove()
        self.losses = [row.double() for row in out[:steps]]

    def _epoch(self, perm: torch.Tensor) -> torch.Tensor:
        with record_function(self.span):
            out = self.fns.epoch_fn(self.content, self.r22, perm, self.base_step)
            with record_function("portbench:to_host"):
                out = out.cpu()
        self.base_step += self.steps_per_unit
        return out

    def unit(self, i: int) -> None:
        self._epoch(self.perms[i % len(self.perms)])

    def prepare_window(self, max_units: int) -> None:
        self.perms = [_perm(self.seed, e, self.images_per_unit) for e in range(1, 1 + max_units)]

    def work(self, peaks: dict) -> dict:
        job = self.job
        flops = work.train_step_flops(job["batch"], job["size"])
        k1_s, k1_n = work.k1_step_bound(job["batch"], job["size"], peaks)
        steps = self.steps_per_unit
        return {"least_s": steps * work.least_seconds(flops, peaks),
                "k1_bound_s": steps * k1_s, "k1_launches": steps * k1_n}

    def free(self) -> None:
        del self.fns, self.model, self.vgg, self.opt, self.r22

    def reference_steps(self, variant: str) -> dict:
        from reference.train import three_steps

        prev = set_tf32(variant == "control")
        try:
            job = dict(self.job)
            return three_steps(self.t_sd, self.vgg_sd, self.content, self.paintings, self.perm0,
                               job, steps=job["check_steps"])
        finally:
            restore_tf32(prev)

    @functools.cached_property
    def reference(self) -> dict:
        return self.reference_steps("reference")

    def _program(self) -> dict:
        return {"losses": self.losses, "grad": self.grad, "delta": self.delta}

    def check(self, variant: str = "reference") -> dict:
        got = self.reference_steps("control") if variant == "control" else self._program()
        return compare(got, self.reference)

    def diagnostics(self) -> dict:
        return diagnostics(self._program(), self.reference)


def _leaf_gaps(got: dict, ref: dict, keep: list[str]) -> list[float]:
    """Each kept leaf's gap of norms over the larger of its and the median leaf's
    reference norm."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    median = statistics.median(norms.values())
    return [abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], median) for k in keep]


def _kept(ref: dict) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the median leaf's: the
    others (the conv biases before an instance norm) move by round-off alone."""
    gnorm = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    median = statistics.median(gnorm.values())
    return [k for k, v in gnorm.items() if v >= 1e-3 * median]


def _loss_gap(got, ref) -> float:
    return max(float(((g - r).abs() / r.abs()).max()) for g, r in zip(got, ref))


def compare(got: dict, ref: dict) -> dict:
    """loss_gap: the largest relative gap of the first step's content, style and total
    loss; grad_gap: the worst kept leaf's gap of the norms of the first gradient;
    step_gap: the median kept leaf's gap of the norms of the change after the last step.
    A state that the optimizer's hook never saw reads inf. The later steps' losses and the
    worst leaf's change are not compared: f32 rounding, grown through Adam's normalized
    steps, moves them by up to about 1e-2 in sound runs (:func:`diagnostics` reads them)."""
    keep = _kept(ref)
    grad, delta = got["grad"], got["delta"]
    return {"loss_gap": _loss_gap(got["losses"][:1], ref["losses"][:1]),
            "grad_gap": float("inf") if grad is None else max(_leaf_gaps(grad, ref["grad"], keep)),
            "step_gap": (float("inf") if delta is None
                         else statistics.median(_leaf_gaps(delta, ref["delta"], keep)))}


def diagnostics(got: dict, ref: dict) -> dict:
    """The numbers left out of :func:`compare`: every step's losses, the worst leaf's change."""
    if got["grad"] is None or got["delta"] is None:
        return {}
    keep = _kept(ref)
    grads = _leaf_gaps(got["grad"], ref["grad"], keep)
    return {"loss_gap_all_steps": _loss_gap(got["losses"], ref["losses"]),
            "step_gap_worst_leaf": max(_leaf_gaps(got["delta"], ref["delta"], keep)),
            "grad_worst_leaf": keep[grads.index(max(grads))],
            "grad_gap_median_leaf": statistics.median(grads)}


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> TrainCycle:
    cell = TrainCycle(cfg, traffic, seed, device)
    sync(device)
    return cell

