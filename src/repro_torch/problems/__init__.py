"""The paper's problems (port of `repro.problems`: the Sec 5.1 quadratic,
the Sec 5.2 robust regression, the Appendix A.2 agnostic FL and the
Appendix C toy, the Dirichlet quadratic with its held-out split, and the
adversarial-embedding LM objective)."""
from .adversarial import delta_projection, init_delta, make_adversarial_loss
from .agnostic import make_agnostic_problem, per_agent_risks, uniform_lambda
from .quadratic import (
    make_dirichlet_quadratic_problem,
    make_quadratic_problem,
    quadratic_minimax_point,
)
from .robust_regression import make_robust_regression_problem, robust_loss
from .toy import make_appendix_c_problem

__all__ = [
    "delta_projection",
    "init_delta",
    "make_adversarial_loss",
    "make_dirichlet_quadratic_problem",
    "make_quadratic_problem",
    "quadratic_minimax_point",
    "make_robust_regression_problem",
    "robust_loss",
    "make_appendix_c_problem",
    "make_agnostic_problem",
    "per_agent_risks",
    "uniform_lambda",
]
