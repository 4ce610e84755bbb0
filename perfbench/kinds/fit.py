"""Traffic kind ``fit``: training the scoring head, a closed loop of fits
of one trainer, back to back.

Set-up builds the program's trainer once (``downstream.train._trainer``,
as ``fit`` builds it: the head, Adam's state, the epoch buffers and the
captured step), drives it through the first ``checked_steps`` steps of
epoch 0 by the window's own call (``run``, a replay of the captured step),
keeps what they left (each step's loss, the first gradient as Adam's first
moment holds it, the weights after the last), and finishes the epoch. The
window then runs fits of ``epochs`` epochs on that same trainer, back to
back, each the fit a user runs from the seed's weights: Adam's state (the
weights, the moments, the count; ``Adam.state()``) set back to the start,
each epoch a permutation drawn on the device from the seed, its gather
(``fill``, which stages the epoch's first batch) and one step a batch, the
fit ending in the fetch of its weights, which waits for the card.

What is compared comes from set-up's first steps and from the window's
fits: each fit's weights against the first's, the last fit's first steps'
losses against set-up's, and the last fit's loss at the first step of
epoch 1 against the reference's (:mod:`perfbench.lib.compare`).

The traffic's parameters: ``rows`` labelled 9-mers of the synthetic MHC-I
task (:mod:`perfbench.lib.synth_mhc`), ``epochs``, ``batch``,
``learning_rate``, ``checked_steps``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.lib import compare, reference
from perfbench.lib.synth_mhc import make_task
from perfbench.lib.trace import traced


def streams(seed: int, n: int = 3) -> list:
    """``n`` independent seeds of one ``--seed``."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1)])
    return [int(s) for s in ss.generate_state(n, np.uint64) >> np.uint64(1)]


def make_weights(config: dict, seed: int, device) -> dict:
    """The head's fp32 weights of ``config`` from ``seed``, made on
    ``device`` by one ``torch.Generator`` in one call: ``embed`` N(0,
    0.1^2), each weight He's N(0, 2 / fan-in), biases 0. Returns numpy
    arrays."""
    k, e = int(config["k"]), int(config["embed_dim"])
    widths = [int(config["hidden"])] * int(config["depth"]) + [1]
    shapes, n_in = [("embed", (21, e), 0.1)], k * e
    for i, width in enumerate(widths, start=1):
        shapes.append((f"w{i}", (n_in, width), (2.0 / n_in) ** 0.5))
        n_in = width
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(int(np.prod(s)) for _n, s, _a in shapes)
    z = torch.randn(total, generator=gen, device=device).cpu().numpy()
    out, at = {}, 0
    for name, shape, scale in shapes:
        size = int(np.prod(shape))
        out[name] = (z[at:at + size].reshape(shape) * np.float32(scale)
                     ).astype(np.float32)
        at += size
    for i, width in enumerate(widths, start=1):
        out[f"b{i}"] = np.zeros(width, np.float32)
    return out


def optimizer_of(head):
    """The program's ``Adam`` that steps ``head`` (the one object that
    refers to it as its ``head``)."""
    from vcf2prot_tpu_torch.downstream.adam import Adam

    found = [o for o in gc.get_referrers(head)
             if isinstance(o, Adam) and o.head is head]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} optimizers step the trainer's head")
    return found[0]


def max_diff(a, b) -> float:
    """The largest absolute difference of two equal-shaped arrays (inf
    where either holds a NaN)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float("inf") if np.isnan(d).any() else float(d.max(initial=0.0))


class Cell:
    """One fit cell: ``config`` (the head), ``traffic`` (this kind's
    parameters), ``seed``, ``device``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.task_seed, self.weight_seed, self.order_seed = streams(seed)
        self.rows = int(traffic["rows"])
        self.batch = int(traffic["batch"])
        self.epochs = int(traffic["epochs"])
        self.lr = float(traffic["learning_rate"])
        self.checked = int(traffic["checked_steps"])
        self.n_batches = -(-self.rows // self.batch)
        self.padded = self.n_batches * self.batch
        self.trace = None
        self.steps = 0  # steps the trainer has taken

    # inputs, made by the benchmark and handed to both sides

    def make_inputs(self) -> None:
        windows, labels = make_task(self.rows, self.task_seed,
                                    k=int(self.config["k"]))
        self.arrays = (np.zeros((self.padded, windows.shape[1]), np.uint8),
                       np.zeros(self.padded, np.float32),
                       np.zeros(self.padded, np.float32))
        self.arrays[0][:self.rows] = windows
        self.arrays[1][:self.rows] = labels
        self.arrays[2][:self.rows] = 1.0
        self.params = make_weights(self.config, self.weight_seed, self.device)
        self.order_gen = torch.Generator(device=self.device)
        self.seed_orders()
        self.order0 = self.next_order()

    def next_order(self) -> torch.Tensor:
        return torch.randperm(self.padded, generator=self.order_gen,
                              device=self.device)

    def seed_orders(self) -> None:
        """The epochs' permutations from the start of the seed's."""
        self.order_gen.manual_seed(self.order_seed)

    def batches(self):
        """The batches of epoch 0 and the first of epoch 1, each epoch's
        order worked out again from the seed, as device tensors."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.order_seed)
        data = [torch.from_numpy(a).to(self.device) for a in self.arrays]
        for epoch in range(2):
            order = torch.randperm(self.padded, generator=gen,
                                   device=self.device)
            for b in range(self.n_batches if epoch == 0 else 1):
                idx = order[b * self.batch:(b + 1) * self.batch]
                yield tuple(a.index_select(0, idx) for a in data)

    # the program

    def build(self) -> None:
        """The program's trainer, made once (``build_s``: its seconds)."""
        from vcf2prot_tpu_torch.downstream import train

        t0 = time.perf_counter()
        self.replicas, self.losses, self.fill, self.run = train._trainer(
            self.arrays, self.params, (self.device,), self.batch, self.lr,
            True, 0.0, self.epochs * self.n_batches, True)
        self.build_s = time.perf_counter() - t0
        self.opt = optimizer_of(self.replicas[0])
        self.start = [t.detach().clone() for t in self.opt.state()]

    def step(self) -> None:
        self.run()
        self.steps += 1

    def reset(self) -> None:
        """Adam's state (the weights with it) back to the start of a fit."""
        with torch.no_grad():
            for t, s in zip(self.opt.state(), self.start):
                t.copy_(s)

    def _leaves(self, flat: torch.Tensor) -> dict:
        """Views of a copy of the head's flat buffer ``flat`` by leaf."""
        head = self.replicas[0]
        base = head.flat.data_ptr()
        out = {}
        for name, p in head.named_parameters():
            at = (p.data_ptr() - base) // p.element_size()
            out[name] = flat[at:at + p.numel()].view(p.shape)
        return out

    def program_first_steps(self) -> dict:
        """The trainer's first steps of epoch 0, by the window's calls."""
        head = self.replicas[0]
        self.fill(self.order0)
        self.step()
        grad = self.opt.mu.detach().clone() / (1.0 - reference.ADAM_B1)
        for _ in range(self.checked - 1):
            self.step()
        flat = head.flat.detach().clone()
        start = {n: torch.from_numpy(v).to(self.device)
                 for n, v in self.params.items()}
        after = self._leaves(flat)
        return {"losses": self.losses[:self.checked].tolist(),
                "grad": self._leaves(grad),
                "change": {n: after[n] - start[n] for n in after}}

    def setup(self) -> None:
        self.make_inputs()
        self.build()
        self.first = self.program_first_steps()
        for _ in range(self.n_batches - self.checked):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def one_fit(self) -> dict:
        """One fit from the seed's weights; its trained weights."""
        self.fit_start = self.steps
        with record_function("perfbench.reset"):
            self.reset()
            self.seed_orders()
        for _ in range(self.epochs):
            order = self.next_order()
            with record_function("perfbench.fill"):
                self.fill(order)
            with record_function("perfbench.steps"):
                for _ in range(self.n_batches):
                    self.step()
        with record_function("perfbench.fetch"):
            return self.replicas[0].to_params()

    def window(self, seconds: float, trace: bool) -> dict:
        """Fits back to back until ``seconds`` have passed, the last one
        whole; with ``trace`` the first one under the profiler. A fit
        whose weights differ from the first's has failed."""
        weights = []
        t0 = time.perf_counter()
        if trace:
            w, self.trace = traced(self.one_fit, self.device)
            weights.append(w)
        while not weights or time.perf_counter() - t0 < seconds:
            weights.append(self.one_fit())
        wall = time.perf_counter() - t0
        diffs = [max(max_diff(w[n], weights[0][n]) for n in w)
                 for w in weights]
        self.refit = max(diffs)
        return {"attempted": len(weights),
                "failed": sum(d != 0 for d in diffs),
                "rows": len(weights) * self.epochs * self.rows,
                "traced_steps": self.epochs * self.n_batches,
                "batch": self.batch, "wall_s": wall,
                "trainer_setup_s": self.build_s}

    def result(self) -> dict:
        """The program's record: set-up's first steps, the last fit's loss
        at the first step of epoch 1, and ``refit_diff``."""
        at = self.fit_start
        n = self.losses.numel()
        losses = self.losses.cpu().numpy()
        last = [float(losses[(at + i) % n]) for i in range(self.checked)]
        refit = max(self.refit, max_diff(last, self.first["losses"]))
        return {**self.first, "refit_diff": refit,
                "epoch1_loss": float(losses[(at + self.n_batches) % n])}

    def free(self) -> None:
        """Drop the program's state (the captured graph with it)."""
        for name in ("replicas", "losses", "fill", "run", "opt", "start"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers compared (:func:`perfbench.lib.compare.numbers`)
        of the program's record against the reference's."""
        got = self.result()
        self.free()
        return compare.numbers(got, self.reference())

    def reference(self, rounding: str = "bf16", fault: str = None) -> dict:
        """The reference's record over epoch 0 and the first step of epoch
        1, in ``rounding``, with ``fault`` planted: one of
        :func:`perfbench.lib.reference.first_steps`' or ``"wrap"`` (epoch
        1's first step takes epoch 0's first batch)."""
        reference.fp32_products()
        params = {n: torch.from_numpy(v).to(self.device)
                  for n, v in self.params.items()}
        batches = self.batches()
        if fault == "wrap":
            batches = list(batches)
            batches[-1] = batches[0]
            fault = None
        ref = reference.first_steps(params, batches, self.lr,
                                    reference.ROUNDINGS[rounding], fault,
                                    change_after=self.checked)
        ref["epoch1_loss"] = ref["losses"][self.n_batches]
        return ref
