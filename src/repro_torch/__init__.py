"""PyTorch/CUDA port of the federated minimax package (`repro`).

The JAX package `repro` stays the reference; this package mirrors its
module layout and names so every ported module has an obvious
counterpart.  It imports `torch`, never `jax` and nothing from `repro`.
Entry points that create tensors run on CUDA unless the caller passes
`device="cpu"` (see `device.resolve_device`); with no CUDA and no
explicit device they raise instead of falling back to the CPU.

Ported so far: `core` (types, projections, the phase-split engine with
client sampling and stochastic / momentum rounds, GDA / Local SGDA /
FedGDA-GT constructors, the Proposition 1 fixed-point tools, the Section
4 bounds), `fed.strategies` (FullSync, LocalOnly, GradientTracking,
PartialParticipation, the communication-efficient CompressedGT /
QuantizedGT, SAGDA and Local SGDA+), `fed.noise` (seeded Gaussian and
minibatch noise), `fed.comm` (the communication table), `fed.transport`
(the packed wire format), `fed.runtime` (the synchronous runner, its
elastic schedules and checkpoints), `fed.async_runtime` (the asynchronous
runner: agent shards on their own devices and CUDA streams), `obs`
(telemetry, invariant probes, the run ledger, `peak_memory`), `sim` (the
client population: churn and straggler schedules drawn as JAX draws them,
the membership-aware round, the O(active) engine and the pod tree), `optim` (schedules, heavy-ball momentum), `data` (Dirichlet
partitions), `prng` (JAX's threefry keys, uniforms, randint and
permutation bit for bit, normals to a few ulp), `problems` (Sec 5.1
quadratic and its Dirichlet variant, robust regression, agnostic FL,
Appendix C toy), `configs` (the ten
architectures), `models` (the forward path of the dense, local-attention,
Mamba-1, Mamba-2 and zamba2 hybrid kinds, text frontend, KV/SSM caches),
`launch.serve` (prefill and greedy decode), `launch.multihost` (the
multi-host launch path: `init_distributed`, `MultiHostRunner` with agent
shards encoding their own packed payloads, the payload layout),
`examples` (quickstart, agnostic FL, robust regression), `kernels` (the hand-written
CUDA `gt_update`, `compress_correction_2d`, `pack_payload_2d`,
`unpack_payload_2d`, `flash_attention` and `ssm_scan`) and `convert`
(state and model weights from the JAX package, as numpy).  Everything
else raises NotImplementedError naming its ROADMAP queue item.
"""
from .device import resolve_device
from .fed import AsyncFederatedRunner

__all__ = ["AsyncFederatedRunner", "resolve_device"]
