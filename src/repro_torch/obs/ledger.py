"""The structured run ledger: a JSONL event stream and a run manifest (port
of `repro/obs/ledger.py`).

A telemetry-enabled run leaves two files under its ledger directory:

  events.jsonl   one JSON object per telemetry event, appended as emitted
                 (the `Telemetry` sink streams through `RunLedger.write`);
  manifest.json  what it takes to re-run or audit the run: the resolved
                 config, the strategy's class / name / knob signature
                 (`fed.comm.knob_signature`, the key `comm_table` rows
                 use), the seed folds (the dedicated `NOISE_STREAM` and
                 `AVAILABILITY_STREAM` constants and the folded keys they
                 produce) and the schedule digest (`summary_trace`: per
                 round a CRC32 of the sorted active ids).

The manifest of a run equals the reference's key for key and value for
value (tests/test_torch_obs.py).  Consumers read the ledger back with
`RunLedger.events` / `RunLedger.manifest`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def _jsonable(o):
    """JSON default: numpy scalars and arrays and torch tensors to plain
    Python."""
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "tolist"):  # torch tensors
        return o.tolist()
    return str(o)


class RunLedger:
    """Append-only JSONL event stream and manifest in one directory."""

    EVENTS = "events.jsonl"
    MANIFEST = "manifest.json"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._fh = None

    # ------------------------------------------------------------ write
    def write(self, event: Dict[str, Any]) -> None:
        if self._fh is None:
            self._fh = open(os.path.join(self.directory, self.EVENTS), "a")
        self._fh.write(json.dumps(event, default=_jsonable) + "\n")
        self._fh.flush()

    def write_manifest(self, manifest: Dict[str, Any]) -> str:
        path = os.path.join(self.directory, self.MANIFEST)
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2, default=_jsonable)
        return path

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------------- read
    @classmethod
    def events(cls, directory: str) -> List[Dict[str, Any]]:
        path = os.path.join(directory, cls.EVENTS)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    @classmethod
    def manifest(cls, directory: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(directory, cls.MANIFEST)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)


def run_manifest(
    *,
    config: Optional[Dict[str, Any]] = None,
    strategy=None,
    seed: Optional[int] = None,
    noise_seed: Optional[int] = None,
    availability_seed: Optional[int] = None,
    schedule=None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the run manifest (module docstring).  Every section is
    optional: pass what the run resolved.  The seed folds are always
    recorded with their stream constants, so an audit can check that no
    stream aliases another."""
    import numpy as np

    from ..fed.noise import NOISE_STREAM, noise_key
    from ..sim.schedule import AVAILABILITY_STREAM, availability_key

    manifest: Dict[str, Any] = {}
    if config is not None:
        manifest["config"] = dict(config)
    if strategy is not None:
        from ..fed.comm import knob_signature

        manifest["strategy"] = {
            "class": type(strategy).__name__,
            "name": getattr(strategy, "name", type(strategy).__name__),
            "signature": knob_signature(strategy),
        }
    seeds: Dict[str, Any] = {
        "noise_stream": NOISE_STREAM,
        "availability_stream": AVAILABILITY_STREAM,
    }
    if seed is not None:
        seeds["seed"] = int(seed)
    if noise_seed is not None:
        seeds["noise_seed"] = int(noise_seed)
        seeds["noise_key"] = np.asarray(noise_key(noise_seed)).tolist()
    if availability_seed is not None:
        seeds["availability_seed"] = int(availability_seed)
        seeds["availability_key"] = np.asarray(
            availability_key(availability_seed)).tolist()
    manifest["seeds"] = seeds
    if schedule is not None:
        manifest["schedule"] = dict(schedule.summary_trace())
    if extra:
        manifest.update(extra)
    return manifest
