"""The paper's problems (port of `repro.problems`: the Sec 5.1 quadratic
and the Appendix C toy; the rest is ROADMAP Queue 1 items 2 and 12)."""
from .quadratic import make_quadratic_problem, quadratic_minimax_point
from .toy import make_appendix_c_problem

__all__ = [
    "make_quadratic_problem",
    "quadratic_minimax_point",
    "make_appendix_c_problem",
]
