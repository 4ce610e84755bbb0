"""Training of the peptide scoring head on one device: the port of
``vcf2prot_tpu/downstream/train.py`` (``fit``, ``:46-231``).

Closes the ``--neoantigen_params`` loop: fit the head on labelled peptide
windows and save an ``.npz`` in ``load_params``' schema, which the port's
neoantigen paths serve. The forward is the serving forward
(:class:`~vcf2prot_tpu_torch.downstream.scoring.TrainableHead`: K3 for
layer 1 with K4 as its gradient, then fp32 products of bf16 values), so
training and serving cannot skew.

What follows the reference exactly: the input checks, the batch size
(``min(_bucket(batch_size), _bucket(n))``), zero windows padding the rows
to whole batches under a mask, BCE-with-logits for binary labels and MSE
for any other, the loss ``sum(per * mask) / max(sum(mask), 1)`` per batch
plus ``l2 * sum(w * w)`` over the ``w*`` weights, adam (``torch.optim.Adam``
with optax.adam's defaults: the same update), and an epoch shuffle of all
padded rows. The shuffle is a ``torch.Generator`` on the device, seeded by
``seed``: a run is reproducible, but its permutations are not JAX's, so the
tests feed both the same ones (:func:`_epoch_orders`).

The reference ran the whole fit as one jitted program. Here it is an eager
loop on the device: the data is uploaded once, each step's loss is kept in
a device tensor and fetched once at the end. The one wait per step is K3's
wrapper checking its windows' bounds.

``fit(..., mesh=...)`` is the reference's data-parallel fit
(``train.py:89-96``, ``:133-216``) over a mesh, a tuple of
``torch.device``s that may repeat one: one replica of the head per shard,
and shard ``i`` takes rows ``[i*rows, (i+1)*rows)`` of every global batch of
one permutation, drawn on the mesh's first device. Each replica's loss
divides by the global batch's mask count and adds ``l2 / n_shards``; after
every replica's backward, the fp32 parameter gradients (each already
rounded to bf16 where XLA rounds a shard's cotangent, hazard 11) are
summed in shard order on the first device, adam steps there, and the
weights are copied back to the other replicas.

    python -m vcf2prot_tpu_torch.downstream.train data.tsv out.npz \\
        [--epochs 30] [--lr 1e-3] [--batch 4096] [--seed 0] [--l2 0] \\
        [--holdout 0.2] [--embed_dim 32] [--hidden 128] [--depth 1] \\
        [--device cuda]

reads ``peptide<TAB>label`` rows (no header, one peptide length), trains,
writes the ``.npz`` and reports the holdout AUC (binary labels) or MSE.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharded import as_mesh, per_device
from .scoring import ScoringHead, TrainableHead, init_params, score_windows


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


def batch_loss(scores, y, m, binary: bool, count=None) -> torch.Tensor:
    """The masked mean loss of one batch: optax's
    ``sigmoid_binary_cross_entropy`` when ``binary``, else the squared
    error, summed over the rows with ``m`` = 1 and divided by their count
    (at least 1). A shard of a data-parallel batch passes the whole
    batch's ``count``."""
    if binary:
        per = -y * F.logsigmoid(scores) - (1.0 - y) * F.logsigmoid(-scores)
    else:
        per = (scores - y) ** 2
    return (per * m).sum() / torch.clamp(
        m.sum() if count is None else count, min=1.0)


def train_step(replicas, opt, shards, binary: bool,
               l2: float = 0.0) -> torch.Tensor:
    """One adam step of the replicas of a head (:class:`TrainableHead`s,
    one per shard; a single-device fit has one): ``replicas[i]`` takes
    ``shards[i] = (w, y, m, count)``, the u8 windows ``[B, k]``, labels
    and mask of its rows and ``count``, the whole batch's mask count (None:
    ``m.sum()``). ``opt`` steps the first replica, whose weights are then
    copied to the others. Returns the sum of the shards' losses on the
    first replica's device (no wait)."""
    n = len(replicas)
    loss = None
    for head, (w, y, m, count) in zip(replicas, shards):
        head.zero_grad(set_to_none=True)
        part = batch_loss(head(w), y, m, binary, count)
        if l2:
            # added once in all: each shard carries 1/n of it
            part = part + l2 * sum((p * p).sum() for name, p in
                                   head.named_parameters()
                                   if name[0] == "w") / n
        part.backward()
        part = part.detach()
        loss = part if loss is None else loss + part.to(loss.device)
    main = list(replicas[0].parameters())
    for head in replicas[1:]:
        for p, q in zip(main, head.parameters()):
            p.grad += q.grad.to(p.device)
    opt.step()
    with torch.no_grad():
        for head in replicas[1:]:
            for p, q in zip(main, head.parameters()):
                q.copy_(p)
    return loss


def fit(windows: np.ndarray, labels: np.ndarray, k: int = None,
        epochs: int = 30, batch_size: int = 4096, learning_rate: float = 1e-3,
        seed: int = 0, params: dict = None, l2: float = 0.0,
        verbose: bool = False, device="cuda", mesh=None) -> dict:
    """Fit the scoring head on ``windows u8[N, k]`` / ``labels f32[N]`` on
    ``device`` (CUDA by default; ``"cpu"`` runs every kernel's plain
    version). Binary labels train with sigmoid cross-entropy, any other
    labels with the squared error, both on the raw score the ranking paths
    sort by. Returns the trained weights, a dict of fp32 numpy arrays ready
    for ``save_params`` / ``load_params``.

    ``mesh``, a tuple of ``torch.device``s (``parallel.mesh.make_mesh``,
    or one device repeated), trains data-parallel over it in place of
    ``device``: the batch size rounds up to a multiple of the mesh size and
    each device takes its slice of every global batch (module docstring);
    the trajectory is the single-device one up to float reassociation."""
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
    head = TrainableHead.from_params(params)
    if head.k != k:
        raise ValueError(f"the head scores {head.k}-mers, not {k}-mers")
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

    replicas = [head.to(devices[0])] + [
        TrainableHead.from_params(params).to(d) for d in devices[1:]
    ]
    opt = torch.optim.Adam(replicas[0].parameters(), lr=learning_rate)
    # the data once per distinct device
    data = dict(zip(devices, per_device(devices, lambda d: [
        torch.from_numpy(a).to(d) for a in (win_p, lab_p, mask_p)
    ])))
    rows = batch_size // n_shards
    losses = torch.empty((epochs, n_batches), dtype=torch.float32,
                         device=devices[0])
    for e, order in enumerate(
            _epoch_orders(seed, padded, epochs, devices[0])):
        order = order.view(n_batches, n_shards, rows)
        # each global batch's mask count: whole numbers, exact in fp32
        counts = data[devices[0]][2][order].sum((1, 2))
        shards = []
        for i, d in enumerate(devices):
            wd, yd, md = data[d]
            idx = order[:, i].to(d)
            shards.append((wd[idx], yd[idx], md[idx], counts.to(d)))
        for b in range(n_batches):
            losses[e, b] = train_step(
                replicas, opt,
                [(w[b], y[b], m[b], c[b]) for w, y, m, c in shards],
                binary, l2,
            )
    out = replicas[0].to_params()
    if verbose:
        for e, row in enumerate(losses.cpu().numpy()):
            print(f"epoch {e + 1}/{epochs}: loss {row.mean():.5f}")
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
