"""Architecture and input-shape configuration dataclasses."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # layer pattern, cycled over layers. entries:
    #   "attn"   — global attention + dense MLP
    #   "local"  — sliding-window attention + dense MLP
    #   "moe"    — global attention + MoE FFN
    #   "mamba1" / "mamba2" — SSM block (no attention/MLP)
    pattern: Tuple[str, ...] = ("attn",)
    sliding_window: int = 4096
    logit_softcap: float = 0.0  # attention logit softcap (gemma2)
    final_softcap: float = 0.0  # final-logit softcap (gemma2)
    rope_theta: float = 10000.0
    causal: bool = True  # False => encoder-only (hubert)
    # MoE
    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"
    # SSM
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    head_p: int = 64  # mamba2 head size
    ssm_chunk: int = 256
    # hybrid (zamba2): apply a single SHARED attention block after every
    # `shared_attn_every` pattern layers (0 = disabled)
    shared_attn_every: int = 0
    # modality frontend: "text" | "audio" | "vision_text"
    frontend: str = "text"
    num_patches: int = 256  # vision_text: patches prepended to the text
    frontend_dim: int = 1024  # embedding dim delivered by the stub frontend
    # distribution
    fed_mode: str = "A"  # A: agents over (pod,data); B: agents over (pod,)
    correction_dtype: Optional[str] = None  # e.g. "float8_e4m3fn"
    # communication strategy knobs (repro.fed.strategies): fraction of
    # clients sampled per round, kept fraction of sparsified tracking
    # corrections, and stochastic-quantization bit-width for them;
    # participation/compression_ratio 1.0 and quantization_bits >= 32 =
    # plain FedGDA-GT
    participation: float = 1.0
    compression_ratio: float = 1.0
    quantization_bits: int = 32
    # stochastic-gradient family (repro.fed.noise): "none" keeps the
    # deterministic oracle (bitwise-pinned legacy traces); "gaussian" /
    # "minibatch" wrap every local/anchor gradient eval in the named
    # NoiseModel, seeded from the DEDICATED noise stream (noise_seed ->
    # fed.noise.noise_key, never the sampling/compression RNG folds).
    # momentum > 0 runs Local-SGDA+-style heavy-ball local steps
    # (optim.momentum.heavy_ball) and voids the fused-anchor shortcut.
    noise: str = "none"
    noise_sigma: float = 0.1
    noise_fraction: float = 0.5
    noise_seed: int = 0
    momentum: float = 0.0
    # encode compressed corrections as REAL packed (value, index, scale)
    # payloads (repro.fed.transport) instead of dense masked trees —
    # identical iterates, packed payload bytes matching bytes_per_round
    wire_transport: bool = False
    # round execution schedule: "sync" lowers the whole round as one
    # fused program; "async" is the phase-dispatched runtime
    # (fed.async_runtime / launch.multihost) — per-agent-shard phase
    # programs, server-side exchange, packed-payload all-gather (the
    # dry-run tags its artifacts "__async" and adds the gather census)
    runtime: str = "sync"
    # client-population scenario (repro.sim.scenarios): "stable" is the
    # paper's full synchronous participation; any other preset (flaky /
    # diurnal / straggler_heavy) makes the launchers run the
    # membership-aware elastic round over a seeded RoundSchedule
    population: str = "stable"
    # two-level aggregation tree (agents -> pods -> server): 0 disables
    # the pod tier; > 0 splits the fed-axes devices into that many
    # contiguous pod groups (launch.mesh.pod_device_groups) and the
    # dry-run records the pod plan + per-pod wire price (--pods).
    # Must divide the federated device count of the target mesh
    pods: int = 0
    # shape support
    supports_decode: bool = True
    supports_long_context: bool = False
    # attention q-blocking (memory bound for the jnp path)
    q_block: int = 512
    citation: str = ""

    @property
    def layer_types(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.pattern))  # ceil
        return (self.pattern * reps)[: self.num_layers]

    def reduced(self) -> "ModelConfig":
        """2-layer / d_model<=512 / <=4-expert variant of the same family
        for CPU smoke tests (same pattern, same code paths)."""
        num_layers = max(2, min(2, self.num_layers))
        if len(self.pattern) > 1:
            num_layers = len(self.pattern)
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            d_inner=min(self.d_inner, 512) if self.d_inner else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            head_p=16,
            ssm_chunk=32,
            sliding_window=64,
            num_patches=8,
            frontend_dim=64,
            q_block=64,
            shared_attn_every=2 if self.shared_attn_every else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
