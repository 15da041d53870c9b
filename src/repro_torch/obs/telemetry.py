"""The telemetry sink: per-round / per-phase spans, counters, probes (port
of `repro/obs/telemetry.py`).

One owner for observability events across every runtime.  A `Telemetry`
instance is a host-side event sink the runners emit into; it never touches
a tensor, so a runner given `telemetry=None` runs the code it ran before
the sink existed, and one given a sink computes the same iterates bit for
bit (tests/test_torch_obs.py).  Enabled without probes it costs a few
microseconds of host bookkeeping per round (`benchmarks/obs.py` gates the
wall-clock overhead at <= 3%).

Event kinds (each event is one flat dict, the reference's schema):

  span     {"kind": "span", "name": <phase or "round">, "round": t,
            "seconds": wall, ...}: "round" spans carry the runtime
            ("sync" / "async" / "sparse" / elastic labels) and dispatch
            counts; phase spans are named after `core.engine.make_phases`
            (broadcast / exchange_corrections / local_steps / aggregate).
            A span measures host time: CUDA launches return before the
            device finishes, as JAX's dispatch does.  Only the sync
            runner's `phase_spans=True` dispatch ends each phase in a
            `torch.cuda.synchronize`, so its phase spans are device time.
  counter  {"kind": "counter", "name": ..., "round": t, "value": n, ...}:
           wire bytes ("wire_bytes" with per_agent / n_active), peak
           memory, active-set sizes.
  probe    {"kind": "probe", "name": ..., "round": t, "value": ...}:
           sampled invariant probes (`obs.probes`), opted into by name
           through `probes=(...)`, sampled every `probe_every` rounds.
  event    {"kind": "event", "name": ..., ...}: discrete occurrences,
           "shard_skipped" (async elastic), "realign" / "dense_fallback"
           (sparse engine), "profile_trace".

The `round` field defaults to the sink's `current_round`, set by
`begin_round`.  Attach an `obs.RunLedger` to stream every event to JSONL
as it is emitted; `profile_rounds` wraps each listed round in a
`torch.profiler` session, exported as a Chrome trace under `profile_dir`
(the reference's `jax.profiler` trace).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


class Telemetry:
    """Host-side observability sink (see module docstring).

    Off is `None`, not a disabled instance: runners guard every emit site
    with `if telemetry is not None`, so the disabled path is the code
    without the sink."""

    def __init__(
        self,
        ledger=None,
        probes: Sequence[str] = (),
        probe_every: int = 1,
        phase_spans: bool = False,
        gap_fn: Optional[Callable] = None,
        profile_dir: Optional[str] = None,
        profile_rounds: Sequence[int] = (),
    ):
        self.events: List[Dict[str, Any]] = []
        self.ledger = ledger
        self.probes = frozenset(probes)
        self.probe_every = max(1, int(probe_every))
        self.phase_spans = bool(phase_spans)
        #: duality-gap oracle for the "duality_gap" probe, supplied by the
        #: caller (the saddle point is problem knowledge)
        self.gap_fn = gap_fn
        self.profile_dir = profile_dir
        self.profile_rounds = frozenset(int(r) for r in profile_rounds)
        self.current_round: Optional[int] = None
        self._profiler = None

    # ------------------------------------------------------------- emit
    def emit(self, kind: str, name: str, round: Optional[int] = None,
             **attrs) -> Dict[str, Any]:
        ev: Dict[str, Any] = {"kind": kind, "name": name}
        r = self.current_round if round is None else round
        if r is not None:
            ev["round"] = int(r)
        ev.update(attrs)
        self.events.append(ev)
        if self.ledger is not None:
            self.ledger.write(ev)
        return ev

    def counter(self, name: str, value, round: Optional[int] = None,
                **attrs) -> Dict[str, Any]:
        return self.emit("counter", name, round=round, value=int(value), **attrs)

    @contextlib.contextmanager
    def span(self, name: str, round: Optional[int] = None, **attrs):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit("span", name, round=round,
                      seconds=time.perf_counter() - t0, **attrs)

    def round_event(self, t: int, runtime: str, seconds: float,
                    **attrs) -> Dict[str, Any]:
        """The per-round span, emitted after the fact from the runner's own
        wall-clock measurement (the number its history records)."""
        return self.emit("span", "round", round=t, seconds=float(seconds),
                         runtime=runtime, **attrs)

    # ------------------------------------------------------------ rounds
    def begin_round(self, t: int) -> None:
        self.current_round = int(t)
        if self.profile_dir is not None and t in self.profile_rounds:
            self.start_profile()

    def end_round(self, t: int) -> None:
        if self._profiler is not None:
            self.stop_profile()

    def start_profile(self) -> None:
        if self._profiler is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()

    def stop_profile(self) -> None:
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir,
                            f"round_{self.current_round}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.emit("event", "profile_trace", dir=self.profile_dir, path=path)

    # ------------------------------------------------------------ probes
    def probe_due(self, name: str, t: int) -> bool:
        return name in self.probes and t % self.probe_every == 0

    def probe_value(self, name: str, t: int, value, **attrs) -> Dict:
        return self.emit("probe", name, round=t, value=value, **attrs)

    # ----------------------------------------------------------- queries
    def series(self, kind: Optional[str] = None,
               name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [
            e for e in self.events
            if (kind is None or e["kind"] == kind)
            and (name is None or e["name"] == name)
        ]

    def probe_series(self, name: str) -> List[Any]:
        return [e["value"] for e in self.series("probe", name)]


def maybe_span(telemetry: Optional[Telemetry], name: str, **attrs):
    """`telemetry.span(...)` when enabled, a no-op context otherwise, so a
    runner's phase blocks are written once for both modes."""
    if telemetry is None:
        return contextlib.nullcontext()
    return telemetry.span(name, **attrs)
