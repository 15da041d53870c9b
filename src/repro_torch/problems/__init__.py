"""The paper's problems (port of `repro.problems`: the Sec 5.1 quadratic,
the Sec 5.2 robust regression, the Appendix A.2 agnostic FL and the
Appendix C toy; the Dirichlet quadratic and the adversarial LM are ROADMAP
Queue 1 items 7 and 12)."""
from .agnostic import make_agnostic_problem, per_agent_risks, uniform_lambda
from .quadratic import make_quadratic_problem, quadratic_minimax_point
from .robust_regression import make_robust_regression_problem, robust_loss
from .toy import make_appendix_c_problem

__all__ = [
    "make_quadratic_problem",
    "quadratic_minimax_point",
    "make_robust_regression_problem",
    "robust_loss",
    "make_appendix_c_problem",
    "make_agnostic_problem",
    "per_agent_risks",
    "uniform_lambda",
]
