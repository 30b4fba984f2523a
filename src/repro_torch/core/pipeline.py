"""Pipeshard: the layer stack cut into stages over a ``stage`` mesh axis,
microbatches pipelined between them by point-to-point handoffs, tensor
parallelism inside each stage (port of ``repro/core/pipeline.py``).

The tables are the reference's, copied (pure Python and numpy; the port
imports nothing of the JAX package): ``validate_stages``,
``stage_gather_index``, ``banked_slot`` and ``schedule_tables``.
``pipeline_mesh`` applies the reference's reshaping rule to a grid of
``torch.distributed`` ranks instead of devices.

The runtime is new.  The reference scans one forward per tick and
leaves the backward to reverse-mode AD; here every stage runs its
backwards explicitly, in the order its schedule gives:

  * stage ``s`` holds exactly the layers of its chunks (``n_stages * v``
    chunks, chunk ``c`` on stage ``c % n_stages``): the rows of
    ``stage_gather_index`` with the padded slots dropped (``stage_rows``).
    An uneven split costs no padded layers, and computes the reference's
    numbers, whose padded slots are the identity;
  * ``pipeline_timeline`` lays the work out tick by tick: each stage runs
    its forwards in the order of ``schedule_tables``, and fills the other
    ticks with backwards, a chunk's in microbatch order (GPipe: every
    forward, then every backward; 1F1B: a warm-up of ``S - s`` forwards,
    then one backward and one forward; interleaved: a backward as soon
    as its successor chunk's gradient has arrived).  A handoff made in
    tick ``t`` is used from tick ``t + 1``;
  * ``StageRunner`` runs one stage's part of the timeline: the first
    stage embeds (the VLM's patches through its projector too, so the
    hidden states carry P + S positions), the last runs the final norm,
    the head and ``lm_loss`` for each microbatch with the whole batch's
    token count as the denominator, so the microbatch losses add up to
    the batch's loss.
    Activations go forward and their gradients back between neighbours,
    the sends and receives of a tick paired in one ``batch_isend_irecv``
    (``core.sharding.exchange``); a handoff between two chunks of one
    rank is a local one.  Carriers are fp32 unless asked otherwise.
    Each chunk, the embedding and the head accumulate their own fp32
    gradients in microbatch order, so every schedule computes the same
    bits;
  * the hybrid family's stack is its groups, and every stage runs the
    shared block at the head of each of its groups: each chunk
    accumulates its own gradient of it, added in chunk order;
  * the encoder-decoder's first stage holds the encoder's stack whole
    (the others none of it: ``held_rows``) and runs the encoder once a
    microbatch at chunk 0; its output travels with the hidden states to
    every chunk (each chunk's carriers hold the b S rows of the hidden
    states and then the b F of the encoder's output), and its gradient
    comes back on the same carriers, each chunk adding its layers'
    share to the next chunk's as one graph adds a layer's uses, so the
    encoder's backward reads the same sum under every schedule (under a
    cut of the heads the sum is partial over the model axis until the
    first stage's f, ``Model.encoder_output``, adds it over the axis);
  * the MoE family's aux: each chunk's forward adds its layers' aux
    divided by the microbatch count to the objective its backward
    differentiates (the reference's sum over stages and microbatches
    over ``m``), and writes each layer's share at its (layer,
    microbatch) place of a [layers, m] table, which ``PipelineStep``
    sums over the stages (one value and zeros an entry) and then in one
    fixed order, so that every schedule reports the same loss.

``core.steps.PipelineStep`` drives it, reduces the gradients over the
mesh and updates the params.  ``StageServer`` runs a stage's part of a
serving step (``serve.steps.ServePlan`` under pipeshard): the same
chunks on the stage's layers' rows of the cache, one pass of the whole
batch, no backward.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import parse_schedule
from repro_torch.core.plans import STAGE_AXIS
from repro_torch.optim.adamw import tree_leaves, tree_map

# the reference's ``pipeline_mesh`` names its result's axes so
STAGED_AXES = (STAGE_AXIS, "data", "model")


def pipeline_mesh(grid, axis_names: Sequence[str], n_stages: int,
                  stage_order=None, stage_layers=None,
                  schedule: str = "gpipe") -> np.ndarray:
    """Reshape a (pod?, data, model) grid of ranks into (stage, data,
    model), the reference's rule: the stage axis absorbs the pod axis
    first, then splits the data axis if more stages are asked for;
    ``stage_order`` permutes the pod blocks (stage k runs on block
    ``stage_order[k]``); ``stage_layers`` is only shape-checked (one
    positive entry per chunk of ``schedule``).

    Returns:
        The ``[n_stages, pod * data / n_stages, model]`` array of ranks,
        whose axes are ``STAGED_AXES``.
    """
    _, virt = parse_schedule(schedule)
    if stage_layers is not None:
        layers = tuple(stage_layers)
        if len(layers) != n_stages * virt:
            raise ValueError(
                f"stage_layers {layers} has {len(layers)} entries for "
                f"n_stages={n_stages} x {virt} virtual ({schedule})")
        if any(l < 1 for l in layers):
            raise ValueError(f"every stage needs >= 1 layer, "
                             f"got {layers}")
    names = tuple(axis_names)
    grid = np.asarray(grid)
    shape = dict(zip(names, grid.shape))
    pod = shape.get("pod", 1)
    data = shape.get("data", 1)
    model = shape.get("model", 1)
    if n_stages % pod != 0 and pod % n_stages != 0:
        raise ValueError(f"n_stages={n_stages} incompatible with pod={pod}")
    rest = n_stages // pod if n_stages >= pod else 1
    if data % rest != 0:
        raise ValueError(
            f"cannot split data={data} into {rest} pipeline sub-stages")
    if stage_order is not None:
        order = tuple(stage_order)
        if sorted(order) != list(range(pod)):
            raise ValueError(
                f"stage_order {order} is not a permutation of the "
                f"{pod} pod blocks")
        if "pod" in names:
            grid = np.take(grid, order, axis=names.index("pod"))
        elif order != (0,):
            raise ValueError("stage_order given but mesh has no pod axis")
    return grid.reshape(n_stages, (pod * data) // n_stages, model)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def stack_length(cfg, stack) -> int:
    """Length of the stacked layer axis (scan *groups* for hybrid)."""
    return _first_leaf(stack).shape[0]


def validate_stages(cfg, stack, n_stages: int,
                    stage_layers=None,
                    schedule: str = "gpipe") -> Optional[tuple]:
    """Check the layer stack can be cut into the schedule's chunks.

    Returns:
        The normalized per-chunk split as a tuple when ``stage_layers``
        is given, else ``None`` for the even split of GPipe and 1F1B,
        or the explicit even per-chunk tuple for interleaved schedules.
    """
    _, virt = parse_schedule(schedule)
    n_chunks = n_stages * virt
    L = stack_length(cfg, stack)
    if stage_layers is not None:
        layers = tuple(int(l) for l in stage_layers)
        if len(layers) != n_chunks or sum(layers) != L \
                or any(l < 1 for l in layers):
            raise ValueError(
                f"{cfg.name}: stage_layers {layers} does not partition the "
                f"{L}-entry stack into {n_chunks} {schedule} chunks")
        return layers
    if L % n_chunks != 0:
        raise ValueError(
            f"{cfg.name}: stack length {L} (groups for hybrid) not divisible "
            f"by {n_chunks} ({n_stages} stages, {schedule}) — pick a divisor "
            f"or pass an explicit stage_layers split (see DESIGN.md §4)")
    return None if virt == 1 else (L // n_chunks,) * n_chunks


def pipeline_split(cfg, stack, n_stages: int, stage_layers=None,
                   schedule: str = "gpipe") -> Tuple[int, ...]:
    """The per-chunk split a pipeline runs: ``stage_layers`` checked by
    ``validate_stages``, or the even split of the stack (layers, or the
    hybrid family's groups) into the schedule's chunks."""
    _, virt = parse_schedule(schedule)
    n_chunks = n_stages * virt
    return validate_stages(cfg, stack, n_stages, stage_layers,
                           schedule=schedule) \
        or (stack_length(cfg, stack) // n_chunks,) * n_chunks


def stage_gather_index(split, n_stages: int, virt: int = 1):
    """Gather index + validity mask realizing a per-chunk layer split:
    stage s holds its chunks (chunk ``c = k * n_stages + s``, ``k <
    virt``) back to back, each padded to the longest chunk by repeating
    its last layer; the mask marks the real slots.

    Returns:
        ``(idx, layer_valid)`` numpy arrays of length ``n_stages * virt *
        max(split)``, in stage-major chunk order.
    """
    split = tuple(int(l) for l in split)
    if len(split) != n_stages * virt:
        raise ValueError(f"split {split} has {len(split)} entries for "
                         f"{n_stages} stages x {virt} virtual")
    max_l = max(split)
    offs = np.concatenate(([0], np.cumsum(split)))
    chunk_of = [k * n_stages + s
                for s in range(n_stages) for k in range(virt)]
    idx = np.concatenate([
        offs[c] + np.minimum(np.arange(max_l), split[c] - 1)
        for c in chunk_of]).astype(np.int32)
    layer_valid = np.concatenate(
        [np.arange(max_l) < split[c] for c in chunk_of])
    return idx, layer_valid


def banked_slot(stage: int, chunk: int, n_stages: int,
                virt: int = 1) -> bool:
    """Whether ``stage``'s output for local ``chunk`` is banked (kept as
    a finished microbatch) instead of sent on the ring — true only for
    the last stage's last chunk."""
    return stage == n_stages - 1 and chunk == virt - 1


def schedule_tables(schedule: str, n_stages: int,
                    n_micro: int) -> Dict[str, np.ndarray]:
    """The reference's static forward-slot tables (shape ``[n_stages,
    T]``): ``active``, ``chunk``, ``mb`` (stage s runs the forward of
    local chunk ``chunk[s, t]`` of microbatch ``mb[s, t]`` at tick t) and
    the arrival tables ``arr_valid``, ``arr_chunk``, ``arr_mb``.

      * GPipe: ``T = m + S - 1``, stage s runs microbatch ``t - s``;
      * 1F1B: ``T = 2m + S - 2``, forward i at ``t = s + i + max(0, i -
        (S-1-s))``;
      * interleaved: greedy list scheduling of the ``v * m`` per-stage
        items, priority ``(i + c, c)``.
    """
    kind, virt = parse_schedule(schedule)
    T_MAX = 1 << 30                         # "never done" sentinel
    S, m = n_stages, n_micro
    if kind == "gpipe":
        T = m + S - 1
        slots = [{s: (0, t - s) for s in range(S) if 0 <= t - s < m}
                 for t in range(T)]
    elif kind == "1f1b":
        T = 2 * m + S - 2
        slots = [dict() for _ in range(T)]
        for s in range(S):
            for i in range(m):
                t = s + i + max(0, i - (S - 1 - s))
                slots[t][s] = (0, i)
    else:                                   # interleaved, v >= 2
        done: Dict[tuple, int] = {}
        pending = {s: [(k, i) for k in range(virt) for i in range(m)]
                   for s in range(S)}
        slots = []
        t, left = 0, S * virt * m
        while left:
            row = {}
            for s in range(S):
                ready = []
                for k, i in pending[s]:
                    c = k * S + s
                    if c == 0 or done.get((c - 1, i), T_MAX) < t:
                        ready.append((i + c, c, k, i))
                if ready:
                    _, c, k, i = min(ready)
                    row[s] = (k, i)
                    done[(c, i)] = t
                    pending[s].remove((k, i))
                    left -= 1
            slots.append(row)
            t += 1
        T = len(slots)
    active = np.zeros((S, T), bool)
    chunk = np.zeros((S, T), np.int32)
    mb = np.zeros((S, T), np.int32)
    for t, row in enumerate(slots):
        for s, (k, i) in row.items():
            active[s, t], chunk[s, t], mb[s, t] = True, k, i
    arr_valid = np.zeros((S, T), bool)
    arr_chunk = np.zeros((S, T), np.int32)
    arr_mb = np.zeros((S, T), np.int32)
    for s in range(S):
        prev = (s - 1) % S
        for t in range(1, T):
            if not active[prev, t - 1]:
                continue
            k, i = int(chunk[prev, t - 1]), int(mb[prev, t - 1])
            if banked_slot(prev, k, S, virt):
                continue                    # last chunk: banked, not sent
            arr_valid[s, t] = True
            arr_chunk[s, t] = k + (1 if prev == S - 1 else 0)
            arr_mb[s, t] = i
    return {"active": active, "chunk": chunk, "mb": mb,
            "arr_valid": arr_valid, "arr_chunk": arr_chunk,
            "arr_mb": arr_mb}


# --------------------------------------------------------------------- #
# the port's runtime
# --------------------------------------------------------------------- #

def chunk_spans(split, n_stages: int, stage: int) -> List[Tuple[int, int]]:
    """(start, length) of each of ``stage``'s chunks in its rows
    (``stage_rows``): chunk ``k * n_stages + stage`` is its k-th."""
    spans, start = [], 0
    for k in range(len(split) // n_stages):
        n = int(split[k * n_stages + stage])
        spans.append((start, n))
        start += n
    return spans


def stage_rows(split, n_stages: int, virt: int, stage: int) -> np.ndarray:
    """The stack rows ``stage`` holds, its chunks back to back:
    ``stage_gather_index``'s with the padded slots dropped."""
    idx, valid = stage_gather_index(split, n_stages, virt)
    per = virt * max(split)
    sl = slice(stage * per, (stage + 1) * per)
    return idx[sl][valid[sl]]


# the stacked params a pipeline stage holds rows of: the decoder's (the
# hybrid family's groups), and the encoder-decoder's encoder stack
STACKS = ("layers/", "encoder/layers/")


def held_rows(path: str, rows, stage: int, length: int):
    """The rows of a params leaf's first dim a pipeline stage holds: of
    the stack (``layers/``) its chunks' ``rows`` (``stage_rows``); of
    the encoder-decoder's encoder stack (``encoder/layers/``, ``length``
    rows) every row on the first stage, which runs the encoder, and none
    on the others; None for a leaf outside the stacks, which every stage
    holds whole."""
    if path.startswith(STACKS[0]):
        return rows
    if path.startswith(STACKS[1]):
        return np.arange(length if stage == 0 else 0)
    return None


Action = Optional[Tuple[str, int, int]]     # ("F" | "B", local chunk, mb)


def pipeline_timeline(schedule: str, n_stages: int,
                      n_micro: int) -> List[Tuple[Action, ...]]:
    """Every stage's work tick by tick: ``ticks[t][s]`` is ``("F", k,
    i)`` (the forward of local chunk k of microbatch i), ``("B", k, i)``
    (its backward) or None.

    Each stage runs its forwards in the order of ``schedule_tables``; a
    forward waits for its input, a backward for its own forward and, but
    on the last chunk, for its successor chunk's gradient; a handoff made
    in tick t is there from tick t + 1.  Each chunk's backwards run in
    microbatch order.  GPipe runs every forward of a stage before its
    first backward; 1F1B a warm-up of ``min(S - s, m)`` forwards, then a
    backward and a forward in turn, so a stage never holds more than
    ``S - s`` microbatches; interleaved runs a ready backward before a
    forward (the deepest chunk first).
    """
    kind, virt = parse_schedule(schedule)
    S, m = n_stages, n_micro
    last = S * virt - 1
    tables = schedule_tables(schedule, S, m)
    act, chunk, mbt = tables["active"], tables["chunk"], tables["mb"]
    fwd = [[(int(chunk[s, t]), int(mbt[s, t]))
            for t in range(act.shape[1]) if act[s, t]] for s in range(S)]
    programs: List[Optional[List[str]]] = []
    for s in range(S):
        if kind == "gpipe":
            programs.append(["F"] * m + ["B"] * m)
        elif kind == "1f1b":
            w = min(S - s, m)
            prog, nf = ["F"] * w, w
            for _ in range(m):
                prog.append("B")
                if nf < m:
                    prog.append("F")
                    nf += 1
            programs.append(prog)
        else:
            programs.append(None)
    f_done = [set() for _ in range(S)]
    acts = [set() for _ in range(S)]        # inputs that have arrived
    grads = [set() for _ in range(S)]       # output gradients arrived
    next_f = [0] * S
    next_b = [[0] * virt for _ in range(S)]
    pc = [0] * S
    ticks: List[Tuple[Action, ...]] = []
    left = 2 * S * virt * m

    def f_ready(s):
        if next_f[s] >= len(fwd[s]):
            return None
        k, i = fwd[s][next_f[s]]
        return (k, i) if (k * S + s == 0 or (k, i) in acts[s]) else None

    def b_ready(s, k):
        i = next_b[s][k]
        if i >= m or (k, i) not in f_done[s]:
            return None
        return (k, i) if (k * S + s == last or (k, i) in grads[s]) else None

    while left:
        row: List[Action] = []
        for s in range(S):
            a: Action = None
            if programs[s] is not None:
                if pc[s] < len(programs[s]):
                    want = programs[s][pc[s]]
                    got = f_ready(s) if want == "F" else b_ready(s, 0)
                    if got is not None:
                        a = (want,) + got
                        pc[s] += 1
            else:
                ready = [b_ready(s, k) for k in reversed(range(virt))]
                ready = [r for r in ready if r is not None]
                if ready:
                    a = ("B",) + ready[0]
                elif f_ready(s) is not None:
                    a = ("F",) + f_ready(s)
            row.append(a)
        if not any(row):
            raise RuntimeError(f"{schedule} S={S} m={m}: no stage can "
                               f"move at tick {len(ticks)}")
        for s, a in enumerate(row):       # the tick's effects, after it
            if a is None:
                continue
            left -= 1
            kind_a, k, i = a
            c = k * S + s
            if kind_a == "F":
                f_done[s].add((k, i))
                next_f[s] += 1
                if c < last:
                    acts[(s + 1) % S].add((k + (s == S - 1), i))
            else:
                next_b[s][k] += 1
                if c > 0:
                    grads[(s - 1) % S].add((k - (s == 0), i))
        ticks.append(tuple(row))
    return ticks


def _accumulate(acc: list, grads) -> None:
    """``acc[j] += grads[j]`` in fp32, in place after a first copy (None:
    nothing yet / no gradient)."""
    for j, g in enumerate(grads):
        if g is None:
            continue
        if acc[j] is None:
            acc[j] = g.to(torch.float32, copy=True)
        else:
            acc[j].add_(g)


class StageRunner:
    """One stage's part of a pipelined step (see the module docstring).

    ``ranks[s]`` is the rank of stage s at this rank's (data, model)
    place; ``split`` the layers of every chunk.  ``run`` takes this
    stage's params in the local layout (``layers`` leaves holding
    ``stage_rows`` back to back, every other leaf whole or cut over the
    model axis), this rank's slice of the batch as tensors on the
    model's device and the whole batch's token count, and returns the
    sums over its microbatches of (loss, ce, aux, zloss, accuracy) (the
    last stage's, without the MoE family's aux), the MoE family's
    [layers, m] table of each layer's aux over m (its chunks' entries,
    zeros elsewhere; None for the other families) and the fp32
    gradients in the local layout (zeros for the leaves the stage does
    not use).  ``peak_in_flight``:
    the most (chunk, microbatch) graphs the last ``run`` held at once
    (an encoder-decoder's hold their microbatch's encoder output).
    """

    def __init__(self, model, schedule: str, n_micro: int, split,
                 stage: int, ranks: Sequence[int], *, remat: bool = True,
                 carrier_dtype=torch.float32):
        self.model, self.m, self.remat = model, n_micro, remat
        self.carrier = carrier_dtype
        self.S = len(ranks)
        _, self.v = parse_schedule(schedule)
        self.s, self.ranks = stage, tuple(ranks)
        self.last = self.S * self.v - 1
        self.spans = chunk_spans(split, self.S, stage)
        # the stack's entry at which each of this stage's chunks starts
        self.firsts = [int(sum(split[:k * self.S + stage]))
                       for k in range(self.v)]
        self.depth = int(sum(split))
        self.timeline = pipeline_timeline(schedule, self.S, n_micro)

    # ---------------------------------------------------------------- #
    def run(self, params, batch, denom):
        from repro_torch.core.sharding import exchange
        from repro_torch.models.model import n_prefix
        model, S, s = self.model, self.S, self.s
        cfg = model.cfg
        head_key = "embed" if cfg.tie_embeddings else "lm_head"

        def live(tree):       # detached leaves that take gradients
            return tree_map(lambda t: t.detach().requires_grad_(True), tree)

        chunks = [live(tree_map(lambda t: t.narrow(0, a, n),
                                params["layers"])) for a, n in self.spans]
        # the hybrid's shared block: each chunk's own leaves of it
        shared = [live(params["shared"]) if "shared" in params else None
                  for _ in chunks]
        # the embedding's (with the position table, the VLM's projector
        # and the encoder-decoder's encoder) and the head's own leaves
        # (one table twice when tied), so that each accumulates its own
        # gradient
        emb = live({k: params[k] for k in ("embed", "pos_embed", "projector",
                                           "encoder")
                    if k in params}) if s == 0 else None
        head = live({"final_norm": params["final_norm"],
                     head_key: params[head_key]}) if s == S - 1 else None
        acc_chunk = [[None] * len(tree_leaves(c)) for c in chunks]
        acc_shared = [[None] * len(tree_leaves(t)) if t else []
                      for t in shared]
        acc_emb = [None] * len(tree_leaves(emb)) if emb else []
        acc_head = [None] * len(tree_leaves(head)) if head else []
        B = batch["tokens"].shape[0]
        if B % self.m:
            raise ValueError(f"local batch {B} does not split into "
                             f"{self.m} microbatches")
        b = B // self.m
        mbs = [{k: v[i * b:(i + 1) * b] for k, v in batch.items()}
               for i in range(self.m)]
        d = cfg.d_model
        # the hidden states' length: the VLM's patches stand before the
        # text
        S_txt = batch["tokens"].shape[1] + n_prefix(cfg, batch)
        # an encoder-decoder's carriers hold the hidden states' b S rows
        # and then the encoder output's b F, each part contiguous, so
        # that a chunk's gradients reduce as one graph's would
        F_len = batch["frames"].shape[1] if "frames" in batch else 0
        carrier = (b, S_txt, d) if not F_len else (b * (S_txt + F_len), d)
        dev = model.device
        cdt = model.compute_dtype
        sums = torch.zeros(5, dtype=torch.float32, device=dev)
        layer_aux = torch.zeros((self.depth, self.m), dtype=torch.float32,
                                device=dev) if cfg.family == "moe" else None
        inbox_act: Dict[tuple, torch.Tensor] = {}
        inbox_grad: Dict[tuple, torch.Tensor] = {}
        saved: Dict[tuple, tuple] = {}
        self.peak_in_flight = 0

        def forward(k, i):
            nonlocal sums
            c = k * S + s
            mb = mbs[i]
            if c == 0:
                x, pos = model.embed_stage(emb, mb)
                if F_len:
                    x = torch.cat([x.flatten(0, 1), model.encoder_output(
                        emb, mb).flatten(0, 1)])
                x_in, h = None, x.to(self.carrier).to(cdt)
            else:
                pos = mb.get("positions")
                x_in = inbox_act.pop((k, i)).requires_grad_(True)
                h = x_in.to(cdt)
            # the encoder's output, the same on every chunk of the
            # microbatch (its gradient comes back on the carrier)
            enc = None
            if F_len:
                n = b * S_txt
                h, enc = h[:n].view(b, S_txt, d), h[n:].view(b, F_len, d)
            y, aux = model.run_layers(chunks[k], h, positions=pos,
                                      remat=self.remat, shared=shared[k],
                                      enc_out=enc)
            # this chunk's part of the step's aux: its layers' over m
            if layer_aux is not None:
                first = self.firsts[k]
                layer_aux[first:first + aux.shape[0], i] = \
                    aux.detach() / self.m
                aux = aux.sum() / self.m
            else:
                aux = None
            if c == self.last:
                out = y.to(self.carrier)
                loss, met = model.head_loss(head, out.to(cdt), mb,
                                            denom=denom)
                saved[(k, i)] = (x_in, loss if aux is None else loss + aux,
                                 None)
                sums = sums + torch.stack(
                    [loss.detach()] + [met[n].detach().float() for n in
                                       ("ce", "aux", "zloss", "accuracy")])
                return None
            if enc is not None:
                y = torch.cat([y.flatten(0, 1), enc.flatten(0, 1)])
            out = y.to(self.carrier)
            saved[(k, i)] = (x_in, out, aux)
            return ((s + 1) % S, (k + (s == S - 1), i), inbox_act,
                    out.detach())

        def backward(k, i):
            c = k * S + s
            x_in, out, aux = saved.pop((k, i))
            outs, grad_outs = [out], None
            if c != self.last:
                grad_outs = [inbox_grad.pop((k, i))]
                if aux is not None:
                    outs.append(aux)
                    grad_outs.append(torch.ones_like(aux))
            groups = [(chunks[k], acc_chunk[k])]
            if shared[k] is not None:
                groups.append((shared[k], acc_shared[k]))
            if c == 0:
                groups.append((emb, acc_emb))
            if c == self.last:
                groups.append((head, acc_head))
            inputs = [t for tree, _ in groups for t in tree_leaves(tree)]
            if x_in is not None:
                inputs.append(x_in)
            got = torch.autograd.grad(outs, inputs, grad_outs,
                                      allow_unused=True)
            at = 0
            for _, acc in groups:
                _accumulate(acc, got[at:at + len(acc)])
                at += len(acc)
            if x_in is None:
                return None
            gx = got[-1] if got[-1] is not None else torch.zeros_like(x_in)
            return ((s - 1) % S, (k - (s == 0), i), inbox_grad, gx)

        for row in self.timeline:
            a = row[s]
            handoff = None
            if a is not None:
                handoff = (forward if a[0] == "F" else backward)(a[1], a[2])
            sends, recvs = [], []
            self.peak_in_flight = max(self.peak_in_flight, len(saved))
            if handoff is not None:
                dst, key, box, t = handoff
                if dst == s:
                    box[key] = t                  # a local handoff
                else:
                    sends.append((self.ranks[dst], t))
            if S > 1:
                for src in sorted({(s - 1) % S, (s + 1) % S}):
                    pa = row[src]
                    if pa is None:
                        continue
                    kind, k, i = pa
                    c = k * S + src
                    if kind == "F" and c < self.last and (src + 1) % S == s:
                        key, box = (k + (src == S - 1), i), inbox_act
                    elif kind == "B" and c > 0 and (src - 1) % S == s:
                        key, box = (k - (src == 0), i), inbox_grad
                    else:
                        continue
                    buf = torch.empty(carrier, dtype=self.carrier,
                                      device=dev)
                    recvs.append((self.ranks[src], buf))
                    box[key] = buf
            if sends or recvs:
                exchange(sends, recvs)
        assert not saved and not inbox_act and not inbox_grad

        def total(accs, tree):
            """The accumulated gradients as ``tree``; zeros for None."""
            it = iter(accs)

            def one(t):
                g = next(it, None)
                return torch.zeros(t.shape, dtype=torch.float32,
                                   device=dev) if g is None else g

            return tree_map(one, tree)

        per_chunk = [total(acc, c) for acc, c in zip(acc_chunk, chunks)]
        parts = ([total(acc_emb, emb)] if emb else []) + \
            ([total(acc_head, head)] if head else []) + \
            [{"shared": total(acc, t)} for acc, t in zip(acc_shared, shared)
             if t is not None]
        grads = {}
        for key, leaf in params.items():
            if key == "layers":
                grads[key] = per_chunk[0] if self.v == 1 else tree_map(
                    lambda *ts: torch.cat(ts), *per_chunk)
                continue
            # zeros for a leaf this stage does not use; the tied table on
            # a stage of one: the embedding's, then the head's; the
            # shared block: its chunks' in chunk order
            mine = [p[key] for p in parts if key in p] or [total([], leaf)]
            grads[key] = mine[0] if len(mine) == 1 else tree_map(
                lambda *ts: functools.reduce(torch.add, ts), *mine)
        return sums, layer_aux, grads


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

class StageServer:
    """One stage's part of a serving step under a pipeline plan: prefill
    or one decode step of this rank's rows of the batch through the
    stages, without microbatches (the reference's serving steps have
    none, and a plan's schedule does not change serving).

    ``split`` is the layers (the hybrid family's groups) of each of the
    ``n_stages * v`` chunks, chunk ``c`` on stage ``c % n_stages``;
    ``ranks[s]`` is the rank of stage ``s`` at this rank's (data, model)
    place and ``group`` the stage axis's process group.  The stage's
    params hold the rows of its chunks back to back (``stage_rows``), as
    does its cache.  The first stage embeds; each chunk's stage runs its
    layers on its rows of the cache and hands the hidden state, in the
    compute dtype, to the next chunk's stage (a copy: counted ``send``
    and ``recv``, or local within a rank); the last stage runs the final
    norm and the head, and its logits of this rank's rows reach every
    stage by one counted ``broadcast``.  An encoder-decoder's first stage
    runs the encoder at prefill, and its output of this rank's rows
    reaches every stage by one counted ``broadcast`` too: each stage
    fills its layers' rows of the cross cache from it."""

    def __init__(self, model, split, stage: int, ranks: Sequence[int],
                 group):
        self.model, self.s, self.ranks, self.group = model, stage, \
            tuple(ranks), group
        self.S = len(self.ranks)
        self.v = len(split) // self.S
        self.spans = chunk_spans(split, self.S, stage)

    def prefill(self, params, batch, cache, *, window: int = 0,
                last_pos=None, blocks=None):
        """(logits [B_r, V] of this rank's rows, filled cache)."""
        from repro_torch.models.model import n_prefix
        model = self.model
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is not None:
            positions = torch.as_tensor(positions, device=model.device)

        def embed():
            return model.embed_stage(params, batch)[0]

        # the VLM's patches stand before the prompt
        rows_seq = (tokens.shape[0],
                    tokens.shape[1] + n_prefix(model.cfg, batch))
        kw = dict(window=window, positions=positions, blocks=blocks)
        if "frames" in batch:
            kw["enc_out"] = self._encode(params, batch)
        return self._run(params, cache, embed, rows_seq, kw, last_pos)

    def _encode(self, params, batch):
        """The encoder's output [B_r, F, d] of this rank's rows on every
        stage: the first stage's, broadcast over the stage axis."""
        from repro_torch.core.sharding import broadcast
        model = self.model
        if self.s == 0:
            enc = model.encoder_output(params, batch)
        else:
            f = batch["frames"]
            enc = torch.empty(tuple(f.shape[:2]) + (model.cfg.d_model,),
                              dtype=model.compute_dtype, device=model.device)
        if self.S > 1:
            broadcast(enc, self.group, self.ranks[0])
        return enc

    def decode(self, params, cache, tokens, *, window: int = 0,
               blocks=None):
        """(logits [B_r, V] of this rank's rows ``tokens`` [B_r, 1], the
        cache advanced one token)."""
        return self._run(params, cache,
                         lambda: self.model.decode_embed(params, cache,
                                                         tokens),
                         (tokens.shape[0], 1),
                         dict(decode=True, window=window, blocks=blocks),
                         None)

    def _run(self, params, cache, embed, rows_seq, kw, last_pos):
        from repro_torch.core.sharding import broadcast, exchange, map_cache
        model, S, s = self.model, self.S, self.s
        x, outs = None, []
        for c in range(S * self.v):
            owner, prev = c % S, (c - 1) % S
            if c and prev != owner:
                if s == prev:
                    exchange([(self.ranks[owner], x)], [])
                elif s == owner:
                    x = torch.empty(rows_seq + (model.cfg.d_model,),
                                    dtype=model.compute_dtype,
                                    device=model.device)
                    exchange([], [(self.ranks[prev], x)])
            if s != owner:
                continue
            if c == 0:
                x = embed()
            a, n = self.spans[c // S]
            layers = {"layers": tree_map(lambda t: t.narrow(0, a, n),
                                         params["layers"])}
            if "shared" in params:
                layers["shared"] = params["shared"]
            part = map_cache(lambda _, leaf: leaf.narrow(0, a, n), cache)
            x, part = model.serve_layers(layers, x, part, **kw)
            outs.append(part)
        # k/v and the states were written in place through the views; a
        # chunk's ring indices are new tensors
        cache = map_cache(lambda name, leaf, *parts: torch.cat(parts)
                          if name == "index" else leaf, cache, *outs)
        if s == S - 1:
            logits = model.serve_logits(params, x, last_pos)
        else:
            logits = torch.empty((rows_seq[0], model.cfg.vocab_size),
                                 dtype=torch.float32, device=model.device)
        if S > 1:
            broadcast(logits, self.group, self.ranks[S - 1])
        return logits, cache
