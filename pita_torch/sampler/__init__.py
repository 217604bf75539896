from pita_torch.sampler.cnf import CNFResult, cnf_nll
from pita_torch.sampler.integrator import (
    GeneratorDraws,
    IntegrateResult,
    IntegratorConfig,
    integrate_sde,
    mala,
    negative_time_descent,
)
from pita_torch.sampler.terms import SDETerms, compute_sde_terms

__all__ = [
    "CNFResult",
    "GeneratorDraws",
    "IntegrateResult",
    "IntegratorConfig",
    "SDETerms",
    "cnf_nll",
    "compute_sde_terms",
    "integrate_sde",
    "mala",
    "negative_time_descent",
]
