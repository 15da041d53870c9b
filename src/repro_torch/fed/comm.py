"""Analytic communication accounting, star-topology cost model, Section 3
(port of `repro/fed/comm.py`).

Bytes exchanged between ONE agent and the server to reach a target
accuracy: rounds(eps) x bytes/round.  Per-round payloads are
strategy-derived (`CommStrategy.bytes_per_round`), and every row also
carries the MEASURED per-round bytes (`transport.measured_bytes_per_round`,
the packed wire buffers' lengths), so analytic and empirical accounting
are compared on every run.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Any, Dict

from .strategies import CommStrategy, resolve_strategy
from .transport import measured_bytes_per_round

Pytree = Any


def knob_signature(strategy: CommStrategy, fields=None) -> str:
    """Deterministic rendering of a strategy's hyperparameter knobs
    (dataclass fields in declaration order), the row key of `comm_table`
    when names collide.  `fields` restricts to a subset of field names; by
    default every non-default knob is rendered."""
    if not dataclasses.is_dataclass(strategy):
        return repr(strategy)
    parts = []
    for f in dataclasses.fields(strategy):
        v = getattr(strategy, f.name)
        if fields is not None:
            if f.name not in fields:
                continue
        elif f.default is not dataclasses.MISSING and v == f.default:
            continue
        parts.append(f"{f.name}={v!r}")
    return ",".join(parts)


def _collision_fields(strategies) -> set:
    """Field names that disambiguate a group of same-class strategies:
    anything set away from its default on any member, plus anything that
    differs across the group."""
    names = set()
    for s in strategies:
        if not dataclasses.is_dataclass(s):
            continue
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            if f.default is dataclasses.MISSING or v != f.default:
                names.add(f.name)
            elif any(
                dataclasses.is_dataclass(o) and getattr(o, f.name, v) != v
                for o in strategies
            ):
                names.add(f.name)
    return names


def comm_table(
    x: Pytree, y: Pytree, num_local_steps: int, rounds_to_eps: Dict
) -> Dict[str, Dict[str, float]]:
    """rounds_to_eps: measured rounds to reach the target per algorithm
    (math.inf if never reached), keyed by algorithm name or by a
    `CommStrategy` instance.  Returns per-algorithm bytes per round
    (priced and measured) and total bytes to target, keyed by name.

    String keys keep their plain name.  Strategy instances whose base
    name collides are keyed by their distinguishing knob signature,
    independent of insertion order; entries indistinguishable even by
    knobs get a `+` suffix."""
    resolved = []
    for algo, rounds in rounds_to_eps.items():
        strategy = resolve_strategy(algo)
        base = algo if isinstance(algo, str) else strategy.name
        resolved.append((base, isinstance(algo, str), strategy, rounds))
    counts = Counter(base for base, _, _, _ in resolved)
    keys = {
        b: _collision_fields([s for bb, _, s, _ in resolved if bb == b])
        for b, n in counts.items()
        if n > 1
    }
    out = {}
    for base, is_str, strategy, rounds in resolved:
        name = base
        if counts[base] > 1 and not is_str:
            sig = knob_signature(strategy, keys[base])
            name = f"{base}[{sig}]" if sig else f"{base}+"
        while name in out:
            name += "+"
        per_round = strategy.bytes_per_round(x, y, num_local_steps)
        measured = measured_bytes_per_round(strategy, x, y, num_local_steps)
        total = per_round * rounds if math.isfinite(rounds) else math.inf
        out[name] = {
            "bytes_per_round": float(per_round),
            "measured_bytes_per_round": float(measured),
            "rounds_to_eps": float(rounds),
            "total_bytes": float(total),
        }
    return out
