"""Application models built on the port: the Lorenz RK4 ensemble, the
Poisson CG solve and the Monte-Carlo estimators."""

from .lorenz import LorenzEnsemble
from .montecarlo import estimate_pi, gbm_terminal_mean
from .poisson import PoissonSolver
