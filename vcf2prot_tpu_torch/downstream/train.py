"""Training of the peptide scoring head on one device: the port of
``vcf2prot_tpu/downstream/train.py`` (``fit``, ``:46-231``).

Closes the ``--neoantigen_params`` loop: fit the head on labelled peptide
windows and save an ``.npz`` in ``load_params``' schema, which the port's
neoantigen paths serve. The forward is the serving forward
(:class:`~vcf2prot_tpu_torch.downstream.scoring.TrainableHead`: K8's fold
and K3 for layer 1 with K4 and K8's gradient as its backward, then K7 for
the hidden layers after it, both ways), so training and serving cannot
skew.

What follows the reference exactly: the input checks, the batch size
(``min(_bucket(batch_size), _bucket(n))``), zero windows padding the rows
to whole batches under a mask, BCE-with-logits for binary labels and MSE
for any other, the loss ``sum(per * mask) / max(sum(mask), 1)`` per batch
plus ``l2 * sum(w * w)`` over the ``w*`` weights, ``optax.adam``'s update
in optax's order (:class:`~vcf2prot_tpu_torch.downstream.adam.Adam`, K5
on the card), its state starting at zeros with count 0, and an epoch
shuffle of all padded rows. The shuffle is a ``torch.Generator`` on the
device, seeded by ``seed``: a run is reproducible, but its permutations
are not JAX's, so the tests feed both the same ones (:func:`_epoch_orders`).

The reference ran the whole fit as one jitted program (``fit_body``), with
nothing crossing the host link until the final fetch. Here the fit is
device work with no host wait from the first step to the final fetch: the
data is uploaded once (:func:`_trainer`); each epoch's permutation gathers
the rows into static epoch buffers on the device (:func:`_epoch_loop`);
K9 then stages the epoch's first batch (the batch picked from those
buffers by a step count on the device), zeroes the gradient buffer and
casts the hidden weights to bf16, once an epoch. One training step (the
forward and the loss, the backward through K8 and K3 (the fold and layer
1), K7 (the hidden layers after the first), K6 both ways (the output layer
and the loss), K4 and K8's gradient, then K5, whose tail stores the loss
and advances the count and whose jobs zero the gradient, cast the updated
hidden weights and stage the next batch; :func:`_step_fn`) is captured in
a CUDA graph and replayed once per batch (:class:`CapturedStep`), so a
replay launches the step's kernels and no torch op; each step's loss
lands in a device tensor, and the weights and losses are fetched once, at
the end.
On the CPU the same step runs eagerly, on the kernels' plain versions;
``capture=False`` runs it eagerly on the card, to hold the captured fit
against it.

``fit(..., mesh=...)`` is the reference's data-parallel fit
(``train.py:89-96``, ``:133-216``) over a mesh, a tuple of
``torch.device``s that may repeat one: one replica of the head per shard,
and shard ``i`` takes rows ``[i*rows, (i+1)*rows)`` of every global batch of
one permutation, drawn on the mesh's first device, into its own epoch
buffers. Each replica's loss divides by the global batch's mask count and
adds ``l2 / n_shards``; after every replica's backward, the fp32 parameter
gradients (each already rounded to bf16 where XLA rounds a shard's
cotangent, hazard 11) are summed in shard order on the first device, adam
(K5) steps there, and the weights are copied back to the other replicas.
It runs the same step function and epoch loop as one device, eagerly
(capturing it needs peer copies inside a capture), with no wait in a
step: K9 at the head of every step on each replica's device, K5 and its
tail (no jobs) on the first.

    python -m vcf2prot_tpu_torch.downstream.train data.tsv out.npz \\
        [--epochs 30] [--lr 1e-3] [--batch 4096] [--seed 0] [--l2 0] \\
        [--holdout 0.2] [--embed_dim 32] [--hidden 128] [--depth 1] \\
        [--device cuda]

reads ``peptide<TAB>label`` rows (no header, one peptide length), trains,
writes the ``.npz`` and reports the holdout AUC (binary labels) or MSE; it
prints each epoch's mean loss and one line of the fit's seconds, its
set-up's, epochs' and fetch's (host clock: the tracer's ``v2p.train.fit``,
``v2p.train.trainer``, ``v2p.train.epochs`` and ``v2p.head.fetch``
spans), the set-up split by
the trainer's parts (``v2p.train.head``, ``.upload``, ``.buffers``, and on
a CUDA device the captured step's ``.warmup`` and ``.capture``).
"""
from __future__ import annotations

import argparse
import sys
import weakref
from time import perf_counter_ns

import numpy as np
import torch

from ..parallel.sharded import as_mesh, per_device
from ..utils.timers import TRACER
from .adam import Adam, adam_update
from .dense import KERNELS as DENSE_KERNELS
from .fold import KERNELS as FOLD_KERNELS
from .head_tail import (  # noqa: F401 (batch_loss: the loss of scores)
    batch_loss,
    head_tail_backward,
    head_tail_forward,
)
from .scoring import (
    ScoringHead,
    TrainableHead,
    head_shape,
    init_params,
    score_windows,
    window_layer1,
    window_layer1_backward,
    window_layer1_batch,
)
from .step import step_prologue

# steps run on a side stream before a capture
CAPTURE_WARMUP = 3
# the wrappers (and their launch counters) of the kernels a step launches
STEP_KERNELS = (step_prologue, window_layer1, window_layer1_batch,
                window_layer1_backward, head_tail_forward,
                head_tail_backward, adam_update, *DENSE_KERNELS,
                *FOLD_KERNELS)
# the replays of every captured step, and their host nanoseconds
REPLAYS = TRACER.counter("v2p.train.replays")
# the captured steps alive (a freed one's replays are in the eager counts)
_CAPTURED = weakref.WeakSet()


def launches(kernel) -> int:
    """The launches of ``kernel``, a wrapper: its own count of the
    launches it made (``kernel.launches``) plus, for a kernel of
    STEP_KERNELS, the launches each captured step's graph holds times its
    replays."""
    n = kernel.launches
    if kernel in STEP_KERNELS:
        i = STEP_KERNELS.index(kernel)
        n += sum(step.launches[i] * step.replays for step in list(_CAPTURED))
    return n


def _bucket(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b



def _epoch_orders(seed: int, padded: int, epochs: int, device):
    """Each epoch's order of the padded rows: a permutation from one
    ``torch.Generator`` on ``device``, seeded by ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for _ in range(epochs):
        yield torch.randperm(padded, generator=gen, device=device)


def train_step(replicas, opt, shards, binary: bool, l2: float = 0.0,
               zero: bool = True, hidden=None, ones=None,
               record=None) -> torch.Tensor:
    """One optimizer step of the replicas of a head (:class:`TrainableHead`s,
    one per shard; a single-device fit has one): ``replicas[i]`` takes
    ``shards[i] = (w, y, m, count)``, the u8 windows ``[B, k]``, labels
    and mask of its rows and ``count``, the whole batch's mask count (None:
    ``m.sum()``), its loss from :meth:`TrainableHead.loss` (K6 for the
    output layer and the loss). The other replicas' flat gradients are added to the
    first's in shard order, ``opt`` (:class:`Adam` in a fit) steps the
    first replica, whose weights are then copied to the others. Returns the
    sum of the shards' losses on the first replica's device. Nothing waits
    for the device, so a single-device step can be captured.

    The gradients add into each replica's ``flat_grad``, which ``zero``
    zeroes first; a fit's step passes False, the step before's K5 or K9
    having zeroed them. ``hidden[i]``: replica ``i``'s hidden weights in
    bf16 (None: cast in the step). ``ones[i]``: an fp32 1 on replica
    ``i``'s device that seeds its backward (None: autograd makes one).
    ``record``, a dict of ``losses``, ``steps`` and, on one device, the
    step's jobs (:func:`~vcf2prot_tpu_torch.downstream.adam.adam_update`):
    ``opt`` (an :class:`Adam`) also stores the loss at ``losses[steps %
    len(losses)]`` and advances ``steps``, K5's tail, and takes the jobs."""
    n = len(replicas)
    loss = None
    for i, (head, (w, y, m, count)) in enumerate(zip(replicas, shards)):
        if zero:
            head.flat_grad.zero_()
        part = head.loss(w, y, m, binary, count,
                         None if hidden is None else hidden[i])
        if l2:
            # added once in all: each shard carries 1/n of it
            part = part + l2 * sum((p * p).sum() for name, p in
                                   head.named_parameters()
                                   if name[0] == "w") / n
        part.backward(None if ones is None else ones[i])
        part = part.detach()
        loss = part if loss is None else loss + part.to(loss.device)
    main = replicas[0]
    for head in replicas[1:]:
        main.flat_grad += head.flat_grad.to(main.flat_grad.device)
    if record is None:
        opt.step()
    else:
        opt.step(loss, **record)
    with torch.no_grad():
        for head in replicas[1:]:
            head.flat.copy_(main.flat)
    return loss


def _step_fn(replicas, opt, epochs, batches, hidden, ones, losses, steps,
             binary: bool, l2: float, every_step: bool):
    """One training step of a fit, on static tensors only, and its
    prologue: ``(step, prologue)``. ``prologue()`` launches K9
    (:func:`~vcf2prot_tpu_torch.downstream.step.step_prologue`) on each
    replica: batch ``steps % n_batches`` of its epoch buffers ``epochs[i]``
    (windows ``[n_batches, rows, k]``, labels, mask and, on a mesh, the
    global batches' mask counts) copied into its static batch
    ``batches[i]``, its gradient buffer zeroed, its hidden weights cast
    into ``hidden[i]``. ``step()`` runs :func:`train_step` (each backward
    seeded by ``ones[i]``), whose K5 stores the loss at ``losses[steps %
    len(losses)]`` and advances ``steps`` (a device int64). With
    ``every_step`` (a mesh must take it: K5 runs on the first replica
    alone) the step starts with ``prologue()``; without it, K5's jobs do
    the prologue's work for the next step (batch ``(steps + 1) %
    n_batches``), and the caller runs ``prologue()`` once an epoch, after
    it refills the epoch buffers. ``step`` reads nothing back to the host,
    so a single-device step can be captured."""
    casts = [[(getattr(head, n).detach(), w)
              for n, w in zip(head.names[1:-1], bf16)]
             for head, bf16 in zip(replicas, hidden)]
    shards = [(*batch[:3], batch[3] if len(batch) > 3 else None)
              for batch in batches]
    record = dict(losses=losses, steps=steps)
    if not every_step:
        if len(replicas) > 1:
            raise ValueError("a mesh's step needs the prologue every step")
        record.update(epoch=epochs[0], batch=batches[0], casts=casts[0])

    def prologue():
        for head, epoch, batch, cast in zip(replicas, epochs, batches,
                                            casts):
            step_prologue(steps.to(head.flat.device), epoch, batch,
                          head.flat_grad, cast)

    def step():
        if every_step:
            prologue()
        train_step(replicas, opt, shards, binary, l2, zero=False,
                   hidden=hidden, ones=ones, record=record)

    return step, prologue


def _hidden_weights(head) -> list:
    """Views of one bf16 buffer, made once, for the bf16 casts of
    ``head``'s hidden weights (``names[1:-1]``), each starting a multiple
    of 16 bytes into it, so that every view is 16-byte aligned as K7's
    Hopper path needs; zeros until the fit's first K9. K7's forward saves
    its view for the backward; the step's K5 (its casts) rewrites the view,
    and that is right only because K5 runs after this step's backward, at
    its end (with ``every_step``, K9 at the head of the next step)."""
    weights = [getattr(head, n) for n in head.names[1:-1]]
    offsets = np.cumsum([0] + [-(-w.numel() // 8) * 8 for w in weights])
    buf = torch.zeros(int(offsets[-1]), dtype=torch.bfloat16,
                      device=head.flat.device)
    return [buf[int(o):int(o) + w.numel()].view_as(w)
            for o, w in zip(offsets, weights)]


class CapturedStep:
    """A training step captured in one CUDA graph; calling it replays the
    graph. ``step`` runs CAPTURE_WARMUP times first on a side stream
    (torch.cuda.graphs' recipe: the allocator, cuBLAS and autograd set up
    there), and ``state``, the tensors a step changes that no prologue
    rewrites, is restored after them, so that the captured fit equals the
    eager one once the fit's first K9 has staged the batch, zeroed the
    gradient and cast the restored weights. A capture launches nothing and
    a replay launches every kernel captured: ``launches`` holds the
    launches of STEP_KERNELS the graph holds and ``replays`` counts the
    replays (:func:`launches` reads both); a replay also adds one to
    REPLAYS with its host nanoseconds, and nothing else. A failed capture
    or replay raises. The graph holds raw addresses of every tensor the
    step touches, so the object keeps ``step`` (and through its closure
    those tensors: the head, the optimizer's state, the epoch buffers, the
    step count) alive: freed, their memory would be handed to later
    allocations that the replays then overwrite. What a step makes (the
    activations and bf16 weights that K7's backward saves, its scratch)
    comes from the graph's own memory pool, which lives as long as the
    graph."""

    def __init__(self, step, state):
        self.step = step
        self.replays = 0
        with TRACER.span("v2p.train.warmup"):
            saved = [t.clone() for t in state]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(CAPTURE_WARMUP):
                    step()
            torch.cuda.current_stream().wait_stream(side)
        with TRACER.span("v2p.train.capture"):
            before = [f.launches for f in STEP_KERNELS]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                step()
            self.launches = [f.launches - n
                             for f, n in zip(STEP_KERNELS, before)]
            for f, n in zip(STEP_KERNELS, before):
                f.launches = n
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)
        _CAPTURED.add(self)

    def __call__(self) -> None:
        t0 = perf_counter_ns()
        self.graph.replay()
        self.replays += 1
        REPLAYS.n += 1
        REPLAYS.ns += perf_counter_ns() - t0

    def __del__(self, kernels=STEP_KERNELS):
        # a freed step's replays stay in launches() (``kernels`` bound
        # here: a step freed at exit outlives the module's globals)
        for f, n in zip(kernels, getattr(self, "launches", ())):
            f.launches += n * self.replays


def _trainer(arrays, params, devices, batch_size: int, learning_rate: float,
             binary: bool, l2: float, n_losses: int, capture: bool,
             every_step: bool = False):
    """A fit's set-up: the padded rows ``arrays`` (u8 windows ``[P, k]``,
    fp32 labels and mask, ``P`` a multiple of ``batch_size``) uploaded
    once per distinct device, one replica of ``params`` a device, K5's
    state, static epoch buffers (each replica's slice of every global
    batch), a device loss buffer of ``n_losses``, and the step's static
    tensors (each replica's batch, its bf16 hidden weights and an fp32 1),
    all made before any capture: a captured step holds their addresses.
    Returns ``(replicas, losses, fill, run)``: ``fill(order)`` gathers an
    epoch's rows in the order ``order`` (a device tensor) into the epoch
    buffers and, on one device, launches K9 to stage the epoch's first
    batch; ``run()`` takes one step (:func:`_step_fn`), a replay of its
    captured graph (:class:`CapturedStep`) on one CUDA device unless
    ``capture`` is False. ``every_step`` (always on a mesh) runs K9 at the
    head of every step instead, and K5 without the step's jobs. Nothing
    here waits for the device once set up. The set-up is the span
    ``v2p.train.trainer``, its children ``v2p.train.head`` (the replicas
    and K5's state), ``v2p.train.upload`` (the rows), ``v2p.train.buffers``
    (the epoch and step buffers) and the captured step's
    ``v2p.train.warmup`` and ``v2p.train.capture``; each ``fill`` is the
    span ``v2p.train.fill``, with a device mark at its start."""
    n_shards = len(devices)
    every_step = every_step or n_shards > 1
    n_batches = arrays[0].shape[0] // batch_size
    rows = batch_size // n_shards
    dev = devices[0]
    with TRACER.span("v2p.train.trainer"):
        with TRACER.span("v2p.train.head"):
            replicas = [TrainableHead.from_params(params).to(d)
                        for d in devices]
            opt = Adam(replicas[0], learning_rate)
        with TRACER.span("v2p.train.upload"):
            data = dict(zip(devices, per_device(devices, lambda d: [
                torch.from_numpy(a).to(d) for a in arrays])))
        with TRACER.span("v2p.train.buffers"):
            shard_bufs = [[torch.zeros((n_batches, rows, *a.shape[1:]),
                                       dtype=a.dtype, device=d)
                           for a in data[d]] for d in devices]
            # each global batch's mask count, on each device: whole
            # numbers, exact in fp32
            counts = (None if n_shards == 1 else
                      {d: torch.zeros(n_batches, dtype=torch.float32,
                                      device=d) for d in data})
            losses = torch.zeros(n_losses, dtype=torch.float32, device=dev)
            steps = torch.zeros((), dtype=torch.int64, device=dev)
            epochs = [bufs + ([] if counts is None else [counts[d]])
                      for d, bufs in zip(devices, shard_bufs)]
            batches = [[torch.zeros(t.shape[1:], dtype=t.dtype,
                                    device=t.device) for t in epoch]
                       for epoch in epochs]
            hidden = [_hidden_weights(head) for head in replicas]
            ones = [torch.ones((), dtype=torch.float32, device=d)
                    for d in devices]
        run, prologue = _step_fn(replicas, opt, epochs, batches, hidden,
                                 ones, losses, steps, binary, l2, every_step)
        if n_shards == 1 and dev.type == "cuda" and capture:
            run = CapturedStep(run, opt.state() + [losses, steps])

    def fill(order):
        with TRACER.span("v2p.train.fill"):
            TRACER.mark("v2p.train.fill", dev)
            by_shard = order.view(n_batches, n_shards, rows)
            for i, (d, bufs) in enumerate(zip(devices, shard_bufs)):
                idx = by_shard[:, i].reshape(-1).to(d)
                for src, dst in zip(data[d], bufs):
                    torch.index_select(src, 0, idx,
                                       out=dst.view(-1, *src.shape[1:]))
            if counts is not None:
                torch.sum(data[dev][2].index_select(0, order).view(
                    n_batches, -1), 1, out=counts[dev])
                for d, c in counts.items():
                    if d != dev:
                        c.copy_(counts[dev])
            if not every_step:
                prologue()

    return replicas, losses, fill, run


def _epoch_loop(orders, fill, run, n_batches: int) -> None:
    """A fit's epochs: each epoch's order (a device tensor) gathers the
    padded rows into the epoch buffers (``fill``), then ``run`` takes one
    step a batch. Nothing here waits for the device (``chip_smoke.py``
    runs a single-device fit's under ``torch.cuda.set_sync_debug_mode(
    "error")``)."""
    for order in orders:
        fill(order)
        for _ in range(n_batches):
            run()


def fit(windows: np.ndarray, labels: np.ndarray, k: int = None,
        epochs: int = 30, batch_size: int = 4096, learning_rate: float = 1e-3,
        seed: int = 0, params: dict = None, l2: float = 0.0,
        verbose: bool = False, device="cuda", mesh=None,
        capture: bool = True) -> dict:
    """Fit the scoring head on ``windows u8[N, k]`` / ``labels f32[N]`` on
    ``device`` (CUDA by default; ``"cpu"`` runs every kernel's plain
    version). Binary labels train with sigmoid cross-entropy, any other
    labels with the squared error, both on the raw score the ranking paths
    sort by. Returns the trained weights, a dict of fp32 numpy arrays ready
    for ``save_params`` / ``load_params``.

    On a CUDA device each step is a replay of one captured CUDA graph
    (module docstring); ``capture=False`` runs the same step eagerly there,
    with the same result bit for bit. On the CPU the step runs eagerly.

    ``mesh``, a tuple of ``torch.device``s (``parallel.mesh.make_mesh``,
    or one device repeated), trains data-parallel over it in place of
    ``device``, its steps run eagerly: the batch size rounds up to a
    multiple of the mesh size and each device takes its slice of every global batch
    (module docstring); the trajectory is the single-device one up to float
    reassociation."""
    devices = (as_mesh(mesh) if mesh is not None
               else (torch.device(device),))
    if (any(d.type == "cuda" for d in devices)
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass device='cpu' to train on "
                           "the CPU")
    windows = np.asarray(windows, np.uint8)
    labels = np.asarray(labels, np.float32)
    n, wk = windows.shape
    if n == 0:
        raise ValueError(
            "no training rows: windows is empty (e.g. --holdout 1.0 leaves "
            "nothing to fit on)"
        )
    if k is None:
        k = wk
    if wk != k:
        raise ValueError(f"windows are {wk}-mers but k={k}")
    if labels.shape != (n,):
        raise ValueError("labels must be f32[N] aligned with windows")
    if params is None:
        params = init_params(k, seed=seed)
    _names, head_k = head_shape(params)
    if head_k != k:
        raise ValueError(f"the head scores {head_k}-mers, not {k}-mers")
    binary = bool(np.isin(labels, (0.0, 1.0)).all())

    n_shards = len(devices)
    batch_size = min(_bucket(batch_size), _bucket(max(n, 1)))
    batch_size = max(batch_size, n_shards)  # every shard sees >= 1 row
    if batch_size % n_shards:
        # a mesh of 6: an equal slice of every batch for every shard
        batch_size += n_shards - batch_size % n_shards
    n_batches = (n + batch_size - 1) // batch_size
    padded = n_batches * batch_size
    win_p = np.zeros((padded, k), np.uint8)
    win_p[:n] = windows
    lab_p = np.zeros(padded, np.float32)
    lab_p[:n] = labels
    mask_p = np.zeros(padded, np.float32)
    mask_p[:n] = 1.0

    with TRACER.span("v2p.train.fit") as whole:
        replicas, losses, fill, run = _trainer(
            (win_p, lab_p, mask_p), params, devices, batch_size,
            learning_rate, binary, l2, epochs * n_batches, capture)
        with TRACER.span("v2p.train.epochs") as loop:
            _epoch_loop(_epoch_orders(seed, padded, epochs, devices[0]),
                        fill, run, n_batches)
        out = replicas[0].to_params()
    if verbose:
        for e, row in enumerate(losses.view(epochs, n_batches).cpu().numpy()):
            print(f"epoch {e + 1}/{epochs}: loss {row.mean():.5f}")
        trainer = TRACER.last("v2p.train.trainer")
        parts = ", ".join(f"{r.name.rsplit('.', 1)[1]} {r.seconds:.3f} s"
                          for r in TRACER.children(trainer))
        print(f"fit {whole.seconds:.3f} s: set-up {trainer.seconds:.3f} s "
              f"({parts}), epochs {loop.seconds:.3f} s, fetch "
              f"{TRACER.last('v2p.head.fetch').seconds:.3f} s (host clock: "
              f"the epochs queue the card's work, the fetch waits for it)")
    return {name: out[name] for name in sorted(out)}


def save_params(path: str, params: dict) -> None:
    """Save trained weights in the ``--neoantigen_params`` schema
    (scoring.load_params validates shapes on the way back in); any head
    width/depth round-trips."""
    np.savez(
        path,
        **{name: np.asarray(v, np.float32) for name, v in params.items()},
    )


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (the ranking paths sort by score, so ranking quality
    is the metric that matters)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels) > 0.5
    pos, neg = scores[labels], scores[~labels]
    if not len(pos) or not len(neg):
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(len(order), np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    return float(
        (ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2)
        / (len(pos) * len(neg))
    )


def read_tsv(path):
    """``(windows u8[N, k], labels f32[N], k)`` of a ``peptide<TAB>label``
    file; exits with a message on a malformed one."""
    peptides, labels = [], []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            try:
                pep, lab = line.split("\t")
            except ValueError:
                raise SystemExit(f"{path}:{ln}: expected 'peptide<TAB>label'")
            peptides.append(pep.encode("ascii"))
            labels.append(float(lab))
    if not peptides:
        raise SystemExit(f"{path}: no rows")
    k = len(peptides[0])
    if any(len(p) != k for p in peptides):
        raise SystemExit(f"{path}: peptides must all be the same length")
    windows = np.frombuffer(b"".join(peptides), np.uint8).reshape(-1, k)
    return windows, np.asarray(labels, np.float32), k


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vcf2prot_tpu_torch.downstream.train",
        description="Train the neoantigen scoring head and write a "
                    "--neoantigen_params .npz.",
    )
    ap.add_argument("tsv")
    ap.add_argument("out_npz")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--l2", type=float, default=0.0)
    ap.add_argument("--holdout", type=float, default=0.2,
                    help="fraction held out for the final AUC report")
    ap.add_argument("--embed_dim", type=int, default=32,
                    help="per-position embedding width")
    ap.add_argument("--hidden", type=int, default=128,
                    help="hidden-layer width")
    ap.add_argument("--depth", type=int, default=1,
                    help="number of hidden layers")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        log("error: no CUDA device (--device cpu trains on the CPU)")
        return 1

    windows, labels, k = read_tsv(args.tsv)
    log(f"{len(windows)} peptides, k={k}; head "
        f"E={args.embed_dim} H={args.hidden} depth={args.depth}")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(windows))
    n_hold = int(len(windows) * args.holdout)
    hold, tr = order[:n_hold], order[n_hold:]
    params = fit(
        windows[tr], labels[tr], k=k, epochs=args.epochs,
        batch_size=args.batch, learning_rate=args.lr, seed=args.seed,
        l2=args.l2, verbose=True, device=args.device,
        params=init_params(k, embed_dim=args.embed_dim, hidden=args.hidden,
                           depth=args.depth, seed=args.seed),
    )
    save_params(args.out_npz, params)
    log(f"saved {args.out_npz}")
    if n_hold:
        head = ScoringHead.from_params(params).to(args.device)
        scores = score_windows(windows[hold], head).cpu().numpy()
        binary = bool(np.isin(labels, (0.0, 1.0)).all())
        if binary:
            log(f"holdout AUC: {auc(scores, labels[hold]):.4f} "
                f"({n_hold} rows)")
        else:
            mse = float(np.mean((scores - labels[hold]) ** 2))
            log(f"holdout MSE: {mse:.5f} ({n_hold} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
