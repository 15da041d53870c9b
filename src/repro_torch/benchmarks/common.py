"""Shared helpers of the port's benchmark drivers (the port's own copy of
what they need from `benchmarks/common.py`)."""
from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict, Iterable, List

from ..obs.memory import peak_memory  # noqa: F401  (re-exported; obs owns it)


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
