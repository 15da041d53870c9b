"""Peak-memory measurement (port of `repro/obs/memory.py`, its one owner).

`benchmarks.common.peak_memory` re-exports this function, so the memory
gate (`benchmarks.elastic --check-pods`) and other callers keep working;
pass a `Telemetry` sink to land the measurement in the run ledger.
"""
from __future__ import annotations

from typing import Dict, Optional


def _live_storages() -> dict:
    """Storage pointer -> bytes of every live torch tensor (gc census)."""
    import gc

    import torch

    out = {}
    for obj in gc.get_objects():
        try:
            if issubclass(type(obj), torch.Tensor) and not obj.is_meta:
                st = obj.untyped_storage()
                out[(obj.device.type, st.data_ptr())] = st.nbytes()
        except RuntimeError:  # tensors without storage
            continue
    return out


def peak_memory(fn, *args, telemetry=None, label: Optional[str] = None,
                **kwargs) -> Dict:
    """Run fn(*args, **kwargs) and report its memory footprint:

      host_peak_bytes    tracemalloc's peak of traced Python / numpy
                         allocations during the call (torch's own CPU
                         allocator is not traced);
      live_buffer_bytes  a census of the torch tensors the call left alive
                         (storages that did not exist before it), on
                         every device: what the host trace misses;
      device_peak_bytes  on a card, `torch.cuda.max_memory_allocated`
                         over the call less what was allocated at its
                         start (a true peak); None without CUDA;
      result             fn's return value.

    The measurement behind the O(active) memory gate
    (`benchmarks.elastic --check-pods`).  With a `telemetry` sink it is
    also emitted as a "peak_memory" counter (value = host peak; the live
    census, the device peak and `label` ride as attributes)."""
    import tracemalloc

    import torch

    cuda = torch.cuda.is_available()
    before = _live_storages()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    tracemalloc.start()
    try:
        result = fn(*args, **kwargs)
        _, host_peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    device_peak = None
    if cuda:
        torch.cuda.synchronize()
        device_peak = torch.cuda.max_memory_allocated() - base
    live = sum(b for k, b in _live_storages().items() if k not in before)
    rec = {"host_peak_bytes": int(host_peak), "live_buffer_bytes": int(live),
           "device_peak_bytes": device_peak, "result": result}
    if telemetry is not None:
        attrs = {"live_buffer_bytes": rec["live_buffer_bytes"],
                 "device_peak_bytes": device_peak}
        if label is not None:
            attrs["label"] = label
        telemetry.counter("peak_memory", rec["host_peak_bytes"], **attrs)
    return rec
