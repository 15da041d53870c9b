"""Optimizer pieces (port of `repro.optim`): the stepsize schedules and
heavy-ball momentum."""
from .momentum import heavy_ball, make_momentum_fedgda_gt_round
from .schedules import constant_schedule, diminishing_schedule

__all__ = [
    "constant_schedule",
    "diminishing_schedule",
    "heavy_ball",
    "make_momentum_fedgda_gt_round",
]
