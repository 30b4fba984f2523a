"""Schedule race detector (port of ``repro/analysis/schedlint.py``):
exhaustive dependency-soundness check of the port's
``core.pipeline.schedule_tables`` (a bit-equal copy of the
reference's) over a (schedule x S x m x v) grid.

The scheduled pipeline runner executes the tables literally: at tick t
every stage runs (or idles) the forward slot ``active/chunk/mb[s, t]``
says, and consumes whatever its ring predecessor's send delivered at
the start of the tick (``arr_*[s, t]``).  The tables are therefore a
complete static description of the dataflow, and every race the runner
could hit is decidable by walking them:

  * SCHED001 — completeness: each of the ``S*v*m`` work items runs
    exactly once, so warm-up and drain cover every microbatch and the
    last stage banks all ``m`` final-chunk outputs.
  * SCHED002 — slot validity: chunk in ``[0, v)``, microbatch in
    ``[0, m)`` on every active slot (an array slot can only hold one
    item, so "two chunks in one tick" surfaces as a SCHED001 miss).
  * SCHED003 — dependency soundness: every consume (chunk c > 0) has a
    matching arrival at or before its tick, whose producer ran
    *strictly earlier*; the arrival is unique up to consumption (no
    inbox clobber).
  * SCHED004 — send/receive pairing: every valid arrival maps back to a
    real, non-banked predecessor slot with the ring chunk-increment
    applied (``banked_slot`` is the single source of truth); every
    non-banked send lands as a valid arrival one tick later (nothing
    falls off the end of the table).
  * SCHED005 — tick-count formulas: GPipe ``T == m+S-1``, 1F1B
    ``T == 2m+S-2``, interleaved ``T >= m-1 + S*v`` (ring critical
    path).

``check_tables`` is pure (tables in, problems out) so tests can feed it
deliberately corrupted tables; ``run`` sweeps the acceptance grid
S in 1..4, m in 1..8, v in 1..3.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.analysis import Finding, PassResult
from repro_torch.core.costmodel import parse_schedule
from repro_torch.core.pipeline import banked_slot, schedule_tables

#: the verified-for-all-small-sizes guarantee (the acceptance grid).
GRID_SCHEDULES = ("gpipe", "1f1b", "interleaved2", "interleaved3")
GRID_S = range(1, 5)
GRID_M = range(1, 9)


def check_tables(tables: Dict[str, np.ndarray], schedule: str,
                 n_stages: int, n_micro: int) -> List[Tuple[str, str]]:
    """Verify one table set; returns (rule, problem) pairs, [] if sound."""
    kind, virt = parse_schedule(schedule)
    S, m = n_stages, n_micro
    active, chunk, mb = tables["active"], tables["chunk"], tables["mb"]
    arr_valid = tables["arr_valid"]
    arr_chunk, arr_mb = tables["arr_chunk"], tables["arr_mb"]
    T = active.shape[1]
    where = f"{schedule} S={S} m={m}"
    problems: List[Tuple[str, str]] = []

    def bad(rule: str, msg: str) -> None:
        problems.append((rule, f"{where}: {msg}"))

    # SCHED002 + SCHED001: every item (global chunk c, microbatch i)
    # runs exactly once, on the stage the ring assigns it.
    runs: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for s in range(S):
        for t in range(T):
            if not active[s, t]:
                continue
            k, i = int(chunk[s, t]), int(mb[s, t])
            if not (0 <= k < virt and 0 <= i < m):
                bad("SCHED002", f"stage {s} tick {t} runs out-of-range "
                                f"slot (chunk {k}, mb {i})")
                continue
            c = k * S + s
            if (c, i) in runs:
                bad("SCHED001", f"item (chunk {c}, mb {i}) runs twice: "
                                f"stage/tick {runs[(c, i)]} and ({s}, {t})")
            runs[(c, i)] = (s, t)
    for c in range(S * virt):
        for i in range(m):
            if (c, i) not in runs:
                bad("SCHED001", f"item (chunk {c}, mb {i}) never runs — "
                                f"warm-up/drain incomplete")

    # SCHED004 (receive side): every valid arrival pairs with a real,
    # non-banked send from the ring predecessor one tick earlier.
    for s in range(S):
        prev = (s - 1) % S
        for t in range(T):
            if not arr_valid[s, t]:
                continue
            if t == 0:
                bad("SCHED004", f"stage {s} receives at tick 0 — nothing "
                                f"was sent yet")
                continue
            if not active[prev, t - 1]:
                bad("SCHED004", f"stage {s} tick {t} arrival has no "
                                f"producing slot on stage {prev} at "
                                f"tick {t - 1}")
                continue
            kp, ip = int(chunk[prev, t - 1]), int(mb[prev, t - 1])
            if banked_slot(prev, kp, S, virt):
                bad("SCHED004", f"stage {s} tick {t} arrival claims a "
                                f"banked send (stage {prev} chunk {kp})")
                continue
            k_exp = kp + (1 if prev == S - 1 else 0)
            if int(arr_chunk[s, t]) != k_exp or int(arr_mb[s, t]) != ip:
                bad("SCHED004", f"stage {s} tick {t} arrival labelled "
                                f"(chunk {int(arr_chunk[s, t])}, mb "
                                f"{int(arr_mb[s, t])}) but predecessor "
                                f"sent (chunk {k_exp}, mb {ip})")
    # SCHED004 (send side): every non-banked send lands somewhere.
    for s in range(S):
        nxt = (s + 1) % S
        for t in range(T):
            if not active[s, t] or banked_slot(s, int(chunk[s, t]),
                                               S, virt):
                continue
            if t + 1 >= T or not arr_valid[nxt, t + 1]:
                bad("SCHED004", f"stage {s} tick {t} send of (chunk "
                                f"{int(chunk[s, t])}, mb "
                                f"{int(mb[s, t])}) never received by "
                                f"stage {nxt} — lost at the table edge")

    # SCHED003: every consume has a strictly-earlier matching produce,
    # delivered exactly once before it is consumed.
    for (c, i), (s, t) in sorted(runs.items()):
        if c == 0:
            continue                        # reads the real microbatch
        k = c // S
        arrivals = [ta for ta in range(T)
                    if arr_valid[s, ta] and int(arr_chunk[s, ta]) == k
                    and int(arr_mb[s, ta]) == i]
        early = [ta for ta in arrivals if ta <= t]
        if not early:
            bad("SCHED003", f"item (chunk {c}, mb {i}) consumed at "
                            f"stage {s} tick {t} but its input never "
                            f"arrives by then (race)")
            continue
        if len(early) > 1:
            bad("SCHED004", f"item (chunk {c}, mb {i}) delivered "
                            f"{len(early)} times to stage {s} before "
                            f"its consume at tick {t} — inbox clobber")
        ta = early[0]
        # the arrival at ta was sent at ta-1; receive-side SCHED004
        # already ties it to a real producer slot, so the produce tick
        # is ta-1 <= t-1 < t: strictly earlier by construction.  Guard
        # against the degenerate self-receive anyway.
        if ta - 1 >= t:
            bad("SCHED003", f"item (chunk {c}, mb {i}) produced at tick "
                            f"{ta - 1} but consumed at tick {t}")

    # SCHED005: tick-count formulas / critical-path lower bound.
    if kind == "gpipe" and T != m + S - 1:
        bad("SCHED005", f"gpipe T={T}, expected m+S-1={m + S - 1}")
    elif kind == "1f1b" and T != 2 * m + S - 2:
        bad("SCHED005", f"1f1b T={T}, expected 2m+S-2={2 * m + S - 2}")
    elif T < m - 1 + S * virt:
        bad("SCHED005", f"T={T} beats the ring critical path "
                        f"m-1+S*v={m - 1 + S * virt} — impossible")
    return problems


def run(root: str) -> PassResult:
    res = PassResult("schedlint")
    line = inspect.getsourcelines(schedule_tables)[1]
    cells = items = 0
    for schedule in GRID_SCHEDULES:
        for S in GRID_S:
            for m in GRID_M:
                tables = schedule_tables(schedule, S, m)
                cells += 1
                items += S * parse_schedule(schedule)[1] * m
                for rule, msg in check_tables(tables, schedule, S, m):
                    res.findings.append(Finding(
                        rule, "error", "src/repro_torch/core/pipeline.py",
                        line, msg))
    res.stats = {"cells_checked": cells, "items_verified": items,
                 "schedules": len(GRID_SCHEDULES)}
    return res
