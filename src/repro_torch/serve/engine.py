"""Serving engines (port of ``repro/serve/engine.py``), on one device or
under a plan on a mesh.

  * ``Engine`` — fixed-batch prefill + decode: every request in a batch
    waits for the longest prompt and the longest generation.
  * ``ContinuousEngine`` — slot-based continuous batching: a persistent
    decode cache of ``slots`` slots, bucketed batch-1 prefill (exact
    length for the SSM and hybrid families), an insert
    that scatters each new request into a free slot, eviction on EOS or
    budget with immediate backfill, and an ``OutputQueue`` so slow
    consumers never stall the decode step.  Greedy tokens are identical
    to the fixed-batch engine's for the same prompt.

Both default to ``device="cuda"`` and raise when no card is present.
Without ``plan`` and ``mesh`` they run on one device.  With them
(``serve.steps.ServePlan``: every family under every plan of
``core.plans.PLANS``; pipeshard on a staged mesh,
``launch.mesh.make_pipeline_mesh``, with ``stage_layers``) every rank of
the mesh runs the engine on the same requests and returns the whole
batch's tokens; it takes this rank's blocks of the params
(``shard_params``).
An encoder-decoder's batch carries its ``frames`` beside the prompt
tokens: ``Engine`` encodes them once a batch, in the prefill.  A
vision-language model's batch carries ``patch_embeds`` [B, P,
vision_dim]: the prefill fills the cache with the P projected patches
and the prompt, so ``max_len`` must cover P + prompt + new tokens.
On the card, prefill attention runs kernel A, int8-KV decode runs kernel
B, every RMSNorm runs kernel 6, and the prefill scans of the SSM and
hybrid families run kernels 4 and 3 (``kernels/ops.py``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import Model, map_cache, n_prefix
from repro_torch.serve.steps import (
    ServePlan, decode_slots_step, insert_step, prefill_step, serve_step,
)


def sample_tokens(logits, generator: Optional[torch.Generator], *,
                  temperature: float = 0.0, top_k: int = 0):
    """Greedy (temperature 0) or top-k temperature sampling; [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, float("-inf")), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_model_device(model: Model, device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"engine device {dev} but model on {model.device}")
    return model.device


def _serve_plan(model: Model, plan, mesh, max_len: int, window: int = 0,
                stage_layers=None) -> Optional[ServePlan]:
    """The engine's ``ServePlan``, or None on one device."""
    if (plan is None) != (mesh is None):
        raise ValueError("serving under a plan takes both plan= and mesh=")
    if plan is None:
        return None
    return ServePlan(model, plan, mesh, max_len=max_len, window=window,
                     stage_layers=stage_layers)


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: List[float] = field(default_factory=list)
    n_slots: int = 1            # live batch rows: one step = n_slots tokens
    total_decode_s: float = 0.0  # whole-loop wall time (timing=False path)
    n_steps: int = 0

    @property
    def steps_per_s(self) -> float:
        """Decode steps per second (drops the first, warm-up, step when
        per-step timings exist; falls back to the loop wall clock)."""
        times = self.decode_s[1:] or self.decode_s
        if times:
            return 1.0 / float(np.mean(times))
        if self.total_decode_s > 0 and self.n_steps:
            return self.n_steps / self.total_decode_s
        return 0.0

    @property
    def tokens_per_s(self) -> float:
        """Aggregate generated tokens/s: ``steps_per_s * n_slots``."""
        return self.steps_per_s * self.n_slots


class _Served:
    """What both engines do alike on one device and under a plan: their
    ``model``, ``plan`` (a ``ServePlan`` or None), ``max_len``,
    ``window`` and ``kv_dtype``."""

    def shard_params(self, params):
        """This rank's blocks of the full params (the params themselves on
        one device)."""
        return params if self.plan is None else self.plan.shard_params(params)

    def _init_cache(self, batch: int, *, slots: bool = False):
        """A fresh cache (this rank's share of it under a plan)."""
        if self.plan is not None:
            return self.plan.init_cache(batch, kv_dtype=self.kv_dtype,
                                        slots=slots)
        init = self.model.init_slot_cache if slots else self.model.init_cache
        return init(batch, self.max_len, window=self.window,
                    kv_dtype=self.kv_dtype)


class Engine(_Served):
    """Fixed-batch prefill + decode for one model, on one device or under
    ``plan`` on ``mesh``.

    For the MoE family a token's output depends on the batch it is routed
    with: an expert takes at most its capacity (``capacity_factor`` of
    the batch's fair share) and drops the rest.  So a request's tokens
    equal ``ContinuousEngine``'s for the same prompt only while no expert
    overflows, in either engine's batches."""

    def __init__(self, model: Model, *, batch_size: int, max_len: int,
                 window: int = 0, temperature: float = 0.0, top_k: int = 0,
                 kv_dtype: str = "fp32", device="cuda", plan=None, mesh=None,
                 stage_layers=None):
        self.device = _check_model_device(model, device)
        self.model = model
        self.plan = _serve_plan(model, plan, mesh, max_len, window,
                                stage_layers)
        self.window = window
        self.temperature, self.top_k = temperature, top_k
        self.batch_size, self.max_len = batch_size, max_len
        self.kv_dtype = kv_dtype

    @torch.no_grad()
    def generate(self, params, batch: Dict[str, Any], n_tokens: int, *,
                 seed: int = 0, timing: bool = True) -> Dict[str, Any]:
        """batch: prompt tokens [B, S] (and an encoder-decoder's
        ``frames`` [B, F, d], a vision-language model's ``patch_embeds``
        [B, P, vision_dim]).  Returns the generated token matrix [B,
        n_tokens] (numpy) and timing stats.  Raises where the cache
        (``max_len`` positions, no window) cannot hold a vision-language
        model's patches, prompt and new tokens.

        ``timing=False`` skips the per-step sync and host copy, so decode
        steps queue back to back; only the loop total is measured."""
        P = n_prefix(self.model.cfg, batch)
        S = batch["tokens"].shape[1]
        if P and not self.window and P + S + n_tokens - 1 > self.max_len:
            raise ValueError(f"a cache of {self.max_len} positions cannot "
                             f"hold {P} patches, {S} prompt tokens and "
                             f"{n_tokens - 1} more")
        stats = ServeStats(n_slots=self.batch_size)
        gen = None
        if self.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        dev = self.device
        # a fresh cache per call: decode writes it in place
        cache = self._init_cache(self.batch_size)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_step(self.model, params, batch, cache,
                                     window=self.window, plan=self.plan)
        tok = sample_tokens(logits, gen, temperature=self.temperature,
                            top_k=self.top_k)[:, None]
        out: List[Any] = [tok.cpu()]
        stats.prefill_s = time.perf_counter() - t0
        t_loop = time.perf_counter()
        for _ in range(n_tokens - 1):
            if timing:
                t0 = time.perf_counter()
            logits, next_tok, cache = serve_step(self.model, params, cache,
                                                 tok, window=self.window,
                                                 plan=self.plan)
            if self.temperature > 0:
                tok = sample_tokens(logits, gen,
                                    temperature=self.temperature,
                                    top_k=self.top_k)[:, None]
            else:
                tok = next_tok
            if timing:
                out.append(tok.cpu())
                stats.decode_s.append(time.perf_counter() - t0)
            else:
                out.append(tok)
        _sync(dev)
        stats.total_decode_s = time.perf_counter() - t_loop
        stats.n_steps = n_tokens - 1
        tokens = np.concatenate([t.cpu().numpy() for t in out], axis=1)
        return {"tokens": tokens, "stats": stats}


# --------------------------------------------------------------------- #
# continuous batching
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class Request:
    """One serving request: a prompt and its generation budget."""
    uid: int
    prompt: Any                       # int32 token ids [prompt_len]
    max_new: int = 0                  # 0 => the run()-level default


class SlotScheduler:
    """Host-side slot bookkeeping for continuous batching.  Invariants:
    a slot is free or live, never both; ``len(free) + occupancy ==
    n_slots``; ``admit`` only hands out a free slot; ``record_token`` and
    ``evict`` reject free slots."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self._free = deque(range(n_slots))
        self._uid: Dict[int, int] = {}      # slot -> request uid
        self._count: Dict[int, int] = {}    # slot -> tokens generated
        self._limit: Dict[int, int] = {}    # slot -> max_new budget

    @property
    def occupancy(self) -> int:
        return len(self._uid)

    def has_free(self) -> bool:
        return bool(self._free)

    def live_slots(self) -> List[int]:
        return sorted(self._uid)

    def uid_of(self, slot: int) -> int:
        return self._uid[slot]

    def admit(self, uid: int, max_new: int) -> int:
        """Claim a free slot for request ``uid``; returns the slot."""
        if not self._free:
            raise RuntimeError("admit with no free slot")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        slot = self._free.popleft()
        self._uid[slot] = uid
        self._count[slot] = 0
        self._limit[slot] = max_new
        return slot

    def record_token(self, slot: int) -> bool:
        """Count one generated token; True when the slot hit its budget."""
        if slot not in self._uid:
            raise KeyError(f"slot {slot} is not live")
        self._count[slot] += 1
        return self._count[slot] >= self._limit[slot]

    def evict(self, slot: int) -> int:
        """Release a live slot (EOS or budget); returns its uid."""
        if slot not in self._uid:
            raise KeyError(f"slot {slot} is not live")
        uid = self._uid.pop(slot)
        del self._count[slot], self._limit[slot]
        self._free.append(slot)
        return uid

    def check(self) -> None:
        """Audit the invariants."""
        free, live = set(self._free), set(self._uid)
        if free & live:
            raise AssertionError(f"slots both free and live: {free & live}")
        if len(self._free) + len(self._uid) != self.n_slots:
            raise AssertionError(
                f"occupancy leak: {len(self._free)} free + "
                f"{len(self._uid)} live != {self.n_slots}")


class OutputQueue:
    """Decode-side handoff to consumers: the decode loop only appends raw
    token rows; detokenizing runs in ``drain``, on the consumer's clock."""

    def __init__(self, detokenize: Optional[Callable[[Any], Any]] = None):
        self._q: deque = deque()
        self._detok = detokenize

    def __len__(self) -> int:
        return len(self._q)

    def put(self, uid: int, token_ids) -> None:
        self._q.append((uid, token_ids))

    def drain(self) -> List:
        """Pop every finished request as ``(uid, output)``."""
        out = []
        while self._q:
            uid, ids = self._q.popleft()
            out.append((uid, self._detok(ids) if self._detok else ids))
        return out


@dataclass
class ContinuousStats:
    n_slots: int = 1
    prefill_s: List[float] = field(default_factory=list)
    decode_s: List[float] = field(default_factory=list)   # timing=True
    ttft_s: Dict[int, float] = field(default_factory=dict)
    occupancy: List[int] = field(default_factory=list)    # per decode step
    n_tokens: int = 0            # generated tokens across all requests
    total_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        """Goodput: generated tokens per wall-clock second of the run."""
        return self.n_tokens / self.total_s if self.total_s > 0 else 0.0

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancy)) if self.occupancy else 0.0


DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


class ContinuousEngine(_Served):
    """Slot-based continuous batching over a persistent decode cache, on
    one device or under ``plan`` on ``mesh`` (batch-1 prefills run whole
    on every rank; the rank whose rows hold a slot inserts into it).

    Prompt lengths pad up to a bucket (the causal mask keeps the pad tail
    invisible, and the insert rewinds the slot's index to the true
    length).  For the MoE family the pad tokens also take part in routing
    and capacity, as in the reference, whose buckets are the same.  The
    SSM and hybrid families prefill at the exact length
    instead (``exact_prefill``): their recurrences would fold pad tokens
    into the state.  Greedy only: every request's tokens equal the
    fixed-batch ``Engine``'s for the same prompt, except for the MoE
    family when an expert overflows its capacity in either engine's
    batches (prefill batches differ: one padded request here, the whole
    batch there), where a dropped token changes what follows; they equal
    the reference ``ContinuousEngine``'s in that case too.

    The encoder-decoder and vision-language families raise, as in the
    reference: a request would need its own frames or patches beside its
    prompt."""

    def __init__(self, model: Model, *, slots: int, max_len: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 kv_dtype: str = "fp32", eos_id: int = -1, pad_id: int = 0,
                 detokenize: Optional[Callable[[Any], Any]] = None,
                 device="cuda", plan=None, mesh=None, stage_layers=None):
        if model.cfg.family in ("vlm", "encdec"):
            raise NotImplementedError(
                f"continuous batching serves token-only prompts; family "
                f"{model.cfg.family!r} needs per-request modality extras")
        self.device = _check_model_device(model, device)
        self.model = model
        self.plan = _serve_plan(model, plan, mesh, max_len,
                                stage_layers=stage_layers)
        self.window = 0
        self.slots, self.max_len = slots, max_len
        self.kv_dtype = kv_dtype
        self.eos_id, self.pad_id = eos_id, pad_id
        self.exact_prefill = model.cfg.family in ("ssm", "hybrid")
        self.buckets = tuple(sorted(b for b in buckets if b <= max_len))
        self.output_queue = OutputQueue(detokenize)

    def _bucket_of(self, n: int) -> int:
        if n > self.max_len:
            raise ValueError(f"prompt of {n} tokens exceeds max_len "
                             f"{self.max_len}")
        if self.exact_prefill:
            return n
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_len      # longest prompts pad to the full cache

    def _prefill_one(self, params, prompt, src_cache):
        """Bucketed batch-1 prefill into ``src_cache`` (in place);
        returns (first token, cache, true length)."""
        if self.exact_prefill:
            # the recurrence starts from the cache's state, which holds
            # the previous request's: every prompt starts from zeros
            map_cache(lambda _, leaf: leaf.zero_(), src_cache)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        L = int(prompt.shape[0])
        padded = np.full((1, self._bucket_of(L)), self.pad_id, np.int64)
        padded[0, :L] = prompt
        logits, pcache = prefill_step(
            self.model, params,
            {"tokens": torch.from_numpy(padded).to(self.device)},
            src_cache, last_pos=L - 1, plan=self.plan)
        return int(torch.argmax(logits, dim=-1)[0]), pcache, L

    @torch.no_grad()
    def run(self, params, requests: Sequence[Request], *,
            max_new: int = 32, timing: bool = False) -> Dict[str, Any]:
        """Serve ``requests`` to completion; returns per-request outputs
        (uid -> generated token ids, EOS included when hit) and stats."""
        reqs = [r if isinstance(r, Request) else Request(i, r)
                for i, r in enumerate(requests)]
        sched = SlotScheduler(self.slots)
        stats = ContinuousStats(n_slots=self.slots)
        pending = deque(reqs)
        bufs: Dict[int, List[int]] = {}
        slot_tok = np.full((self.slots, 1), self.pad_id, np.int64)
        live = np.zeros((self.slots,), bool)
        dev = self.device
        cache = self._init_cache(self.slots, slots=True)
        src = self._init_cache(1)
        t_start = time.perf_counter()

        def finish(slot: int) -> None:
            uid = sched.evict(slot)
            live[slot] = False
            slot_tok[slot, 0] = self.pad_id
            self.output_queue.put(uid, np.asarray(bufs.pop(slot), np.int32))

        while pending or sched.occupancy:
            while pending and sched.has_free():
                req = pending.popleft()
                budget = req.max_new or max_new
                t0 = time.perf_counter()
                tok0, pcache, L = self._prefill_one(params, req.prompt, src)
                now = time.perf_counter()   # tok0 was read: device synced
                stats.prefill_s.append(now - t0)
                stats.ttft_s[req.uid] = now - t_start
                slot = sched.admit(req.uid, budget)
                cache = insert_step(cache, pcache, slot, L, plan=self.plan,
                                    slots=self.slots)
                bufs[slot] = [tok0]
                live[slot] = True
                slot_tok[slot, 0] = tok0
                stats.n_tokens += 1
                if sched.record_token(slot) or tok0 == self.eos_id:
                    finish(slot)
            if not sched.occupancy:
                continue     # everything admitted finished at prefill
            if timing:
                t0 = time.perf_counter()
            _, next_tok, cache = decode_slots_step(
                self.model, params, cache,
                torch.from_numpy(slot_tok).to(dev),
                torch.from_numpy(live).to(dev), pad_id=self.pad_id,
                plan=self.plan)
            nt = next_tok.cpu().numpy()   # host sync: scheduler input
            if timing:
                stats.decode_s.append(time.perf_counter() - t0)
            stats.occupancy.append(sched.occupancy)
            for slot in sched.live_slots():
                t = int(nt[slot, 0])
                bufs[slot].append(t)
                slot_tok[slot, 0] = t
                stats.n_tokens += 1
                if sched.record_token(slot) or t == self.eos_id:
                    finish(slot)
        _sync(dev)
        stats.total_s = time.perf_counter() - t_start
        return {"outputs": dict(self.output_queue.drain()), "stats": stats}
