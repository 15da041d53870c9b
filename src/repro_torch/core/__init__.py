"""Core federated minimax algorithms (port of `repro.core`)."""
from .types import (
    MinimaxProblem,
    SaddleField,
    grad_xy,
    identity_proj,
    tree_broadcast_agents,
    tree_leaves,
    tree_map,
    tree_mean_over_agents,
    tree_sq_dist,
)
from .projections import l2_ball_proj, box_proj, simplex_proj
from .engine import (
    RoundPhases,
    RoundState,
    agent_mean,
    agent_weighted_sum,
    anchor_step,
    default_update,
    make_phases,
    make_round,
    run_strategy_rounds,
    tracking_corrections,
)
from .gda import make_gda_step, make_gda_step_reference, run_rounds
from .local_sgda import (
    make_local_sgda_round,
    make_local_sgda_round_reference,
    make_scheduled_local_sgda_round,
)
from .fedgda_gt import (
    communication_bytes_per_round,
    make_fedgda_gt_round,
    make_fedgda_gt_round_reference,
)
from .generalization import (
    empirical_rademacher,
    generalization_gap,
    lemma3_vc_bound,
    theorem2_bound,
)
from .fixed_point import (
    APPENDIX_C_MINIMAX_POINT,
    appendix_c_fixed_point,
    local_operators,
    prop1_residual,
)

__all__ = [
    "MinimaxProblem",
    "SaddleField",
    "grad_xy",
    "identity_proj",
    "tree_broadcast_agents",
    "tree_leaves",
    "tree_map",
    "tree_mean_over_agents",
    "tree_sq_dist",
    "l2_ball_proj",
    "box_proj",
    "simplex_proj",
    "RoundPhases",
    "RoundState",
    "agent_mean",
    "agent_weighted_sum",
    "anchor_step",
    "default_update",
    "make_phases",
    "make_round",
    "run_strategy_rounds",
    "tracking_corrections",
    "make_gda_step",
    "make_gda_step_reference",
    "run_rounds",
    "make_local_sgda_round",
    "make_local_sgda_round_reference",
    "make_scheduled_local_sgda_round",
    "make_fedgda_gt_round",
    "make_fedgda_gt_round_reference",
    "communication_bytes_per_round",
    "APPENDIX_C_MINIMAX_POINT",
    "appendix_c_fixed_point",
    "local_operators",
    "prop1_residual",
    "empirical_rademacher",
    "generalization_gap",
    "lemma3_vc_bound",
    "theorem2_bound",
]
