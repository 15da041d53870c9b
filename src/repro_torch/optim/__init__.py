"""Optimizer pieces (port of `repro.optim`): the stepsize schedules.
Server momentum is ROADMAP Queue 1 item 7."""
from ..device import not_ported
from .schedules import constant_schedule, diminishing_schedule


def heavy_ball(*args, **kwargs):
    raise not_ported("optim.heavy_ball", "Queue 1 item 7")


def make_momentum_fedgda_gt_round(*args, **kwargs):
    raise not_ported("optim.make_momentum_fedgda_gt_round", "Queue 1 item 7")


__all__ = [
    "constant_schedule",
    "diminishing_schedule",
    "heavy_ball",
    "make_momentum_fedgda_gt_round",
]
