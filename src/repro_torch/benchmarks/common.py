"""Shared helpers of the port's benchmark drivers (the port's own copy of
what they need from `benchmarks/common.py`)."""
from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict, Iterable, List


def emit(rows: List[Dict], header: Iterable[str], title: str) -> None:
    """Print one benchmark table as CSV with a title banner."""
    print(f"\n# ==== {title} ====")
    w = csv.DictWriter(sys.stdout, fieldnames=list(header))
    w.writeheader()
    for r in rows:
        w.writerow({k: r.get(k, "") for k in header})
    sys.stdout.flush()


def arg_parser(description: str) -> argparse.ArgumentParser:
    """The drivers' common option: `--device` (default CUDA; `cpu` runs the
    kernels' plain versions)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu to run there)")
    return p


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


def peak_memory(fn, *args, **kwargs) -> Dict:
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
    (`benchmarks.elastic --check-pods`)."""
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
    return {"host_peak_bytes": int(host_peak), "live_buffer_bytes": int(live),
            "device_peak_bytes": device_peak, "result": result}
