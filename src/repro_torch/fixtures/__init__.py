"""Committed data shared with the JAX package.

`paper_quadratic.npz` holds the Theorem 1 problem (d=20, n=100, m=8) and
the Sec 5.1 problem (d=50, n=500, m=20) exactly as the JAX builders draw
them from PRNGKey(0) (`thm1_G`, `thm1_Ab`, `sec51_G`, `sec51_Ab`), and the
JAX FedGDA-GT per-round gap trajectories on them (`thm1_gap`: K=10,
eta=2e-4, 4000 rounds; `sec51_gap`: K=20, eta=1e-4, 1500 rounds; each
with the final gap appended).  `tests/test_torch_fixtures.py` rebuilds it
from the JAX package; run that file as a script to rewrite it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

PAPER_QUADRATIC = Path(__file__).resolve().parent / "paper_quadratic.npz"


def load_paper_quadratic() -> Dict[str, np.ndarray]:
    with np.load(PAPER_QUADRATIC) as f:
        return {k: f[k] for k in f.files}
