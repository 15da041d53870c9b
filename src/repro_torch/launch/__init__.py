"""Entry points of the port: `launch/serve.py` (the serving entry point),
`launch/train.py` (federated adversarial LM training),
`launch/multihost.py` (the multi-host federated launch path:
`init_distributed`, `MultiHostRunner`, the packed-payload layout and its
gather as one SPMD step) and the SPMD layer on `DeviceMesh` and DTensor:
`mesh.py` (production and host meshes), `shardings.py` (the sharding
rules), `steps.py` (the train / elastic / prefill / decode step
builders), `census.py` (the executed-op census) and `dryrun.py` (the
production-mesh dry-run on a fake world, `python -m
repro_torch.launch.dryrun`)."""
from .census import Census
from .mesh import (
    fed_axes,
    make_host_mesh,
    make_production_mesh,
    num_agents,
    pod_device_groups,
)
from .multihost import (
    MultiHostRunner,
    build_gather_decode_step,
    expected_gather_bytes,
    init_distributed,
    leaf_specs,
    payload_structs,
)
from .shardings import (
    agent_pspec,
    cache_pspec,
    cache_shardings,
    make_agent_constraint,
    param_pspec,
    param_shardings,
    placements,
    replicated,
    serve_batch_sharding,
    train_batch_shardings,
)
from .steps import (
    abstract_caches,
    abstract_params,
    build_decode_step,
    build_elastic_train_step,
    build_gather_decode_train_step,
    build_prefill_step,
    build_train_step,
    delta_struct,
    pod_aggregation_plan,
    step_builder_for,
    train_input_specs,
)

__all__ = [
    "Census",
    "MultiHostRunner",
    "abstract_caches",
    "abstract_params",
    "agent_pspec",
    "build_decode_step",
    "build_elastic_train_step",
    "build_gather_decode_step",
    "build_gather_decode_train_step",
    "build_prefill_step",
    "build_train_step",
    "cache_pspec",
    "cache_shardings",
    "delta_struct",
    "expected_gather_bytes",
    "fed_axes",
    "init_distributed",
    "leaf_specs",
    "make_agent_constraint",
    "make_host_mesh",
    "make_production_mesh",
    "num_agents",
    "param_pspec",
    "param_shardings",
    "payload_structs",
    "placements",
    "pod_aggregation_plan",
    "pod_device_groups",
    "replicated",
    "serve_batch_sharding",
    "step_builder_for",
    "train_batch_shardings",
    "train_input_specs",
]
