"""A stub model for the layout tests, copied into a checkout as
``models/stub.py``: a least-squares fit of ``w`` and ``b`` by Adam over
batches of rows, with every name models/__init__.py lists and a trainer
that keeps program.py's trainer contract.  Its reference is the same
arithmetic, written out again."""
from __future__ import annotations

import contextlib
import sys
import time

import torch
from torch.profiler import record_function

B1, B2, EPS = 0.9, 0.999, 1e-8


def make_inputs(options, seed, start_it, device, warm_radii):
    o = options
    rows = torch.Generator(device=device)
    rows.manual_seed(int(o["data"]["seed"]))
    x = torch.randn((int(o["batches"]), int(o["rows"]), int(o["width"])),
                    generator=rows, device=device)
    y = x.sum(-1) / 4.0
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    w = torch.randn(int(o["width"]), generator=gen, device=device)
    return {"opt": options, "x": x, "y": y, "w": w,
            "b": torch.zeros(1, device=device), "seed": int(seed),
            "start_it": int(start_it)}


def _loss(w, b, x, y, it):
    k = it % x.shape[0]
    return ((x[k] @ w + b - y[k]) ** 2).mean()


def _adam(p, g, m, v, count, lr):
    m.mul_(B1).add_((1 - B1) * g)
    v.mul_(B2).add_((1 - B2) * g * g)
    p.sub_(lr * (m / (1 - B1 ** count)) /
           (torch.sqrt(v / (1 - B2 ** count)) + EPS))


class StubTrainer:
    spans = False

    def __init__(self, inputs, device):
        self.device = torch.device(device)
        self.x, self.y = inputs["x"], inputs["y"]
        self.p = {"w": inputs["w"].clone(), "b": inputs["b"].clone()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr = float(inputs["opt"]["lr"])
        self.it = inputs["start_it"]
        self.count = 0
        self.rays_per_step = self.x.shape[1]
        self.step_s = []

    def _step(self):
        t0 = time.perf_counter()
        with (record_function("bench.train_step") if self.spans
              else contextlib.nullcontext()):
            p = {k: v.requires_grad_(True) for k, v in self.p.items()}
            loss = _loss(p["w"], p["b"], self.x, self.y, self.it)
            grads = torch.autograd.grad(loss, list(p.values()))
            self.count += 1
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    v.requires_grad_(False)
                    _adam(v, g, self.mu[k], self.nu[k], self.count, self.lr)
        self.step_s.append(time.perf_counter() - t0)
        return loss.detach()

    def run(self, max_iter, log_every=100, on_step=None, stats=False):
        while self.it < max_iter:
            metrics = {"loss": self._step()}
            if stats:
                metrics["live_frac"] = torch.ones(())
            if on_step:
                on_step(self, metrics)
                on_step(self, None)
            self.it += 1


def build(inputs, device):
    return StubTrainer(inputs, device)


def params(trainer):
    return dict(trainer.p)


def first_grad_norms(trainer):
    return {k: torch.linalg.vector_norm(m) / (1 - B1)
            for k, m in trainer.mu.items()}


class Reference:
    def __init__(self, inputs, device, tf32=False, fault=None):
        self.x = inputs
        self.dev = torch.device(device)

    def run(self, n):
        x = self.x
        p = {"w": x["w"].clone(), "b": x["b"].clone()}
        start = {k: v.clone() for k, v in p.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, grad_norms = [], None
        for i in range(n):
            for t in p.values():
                t.requires_grad_(True)
            loss = _loss(p["w"], p["b"], x["x"], x["y"], x["start_it"] + i)
            g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            if grad_norms is None:
                grad_norms = {k: float(torch.linalg.vector_norm(t))
                              for k, t in g.items()}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for k, t in p.items():
                    t.requires_grad_(False)
                    _adam(t, g[k], m[k], v2[k], i + 1,
                          float(x["opt"]["lr"]))
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": {k: float(torch.linalg.vector_norm(
                    p[k] - start[k])) for k in p},
                "rows": int(x["x"].shape[1])}


def start_iteration(options, anchor):
    """The stub has no schedule lists: its traffic starts at
    ``{"iteration": n}``."""
    return int(anchor["iteration"])


def schedule_moves(options, start, n):
    return []


def step_shape(cell, ref):
    return {"rows": ref["rows"], "width": int(cell.config["options"]
                                              ["width"])}


def step_floor_s(shape):
    """Forward and backward of the rows' product, at 67 TFLOP/s."""
    return 3 * 2 * shape["rows"] * shape["width"] / 67e12


census = sys.modules[__name__]


def describe(trainer):
    return f"iteration {trainer.it}"
