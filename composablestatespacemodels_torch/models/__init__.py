from . import bijectors, observation, params, sde, tree
from .model import (ComposedModel, FirstElement, Fourier, LeafModel, Model,
                    bernoulli, beta, compose, lgcp, linear, negative_binomial,
                    poisson, seasonal, students_t, zero_inflated_poisson)
from .observation import (Bernoulli, Beta, Gaussian, LogGaussianCox,
                          NegativeBinomial, ObservationFamily, Poisson,
                          StudentsT, ZeroInflatedPoisson)
from .params import (BrownianParams, GenBrownianParams, OuParams, ParamNode,
                     add_flat, brownian_params,
                     brownian_params_unconstrained, covariance_params,
                     flatten_params, gen_brownian_params,
                     gen_brownian_params_unconstrained, mean_params,
                     ou_params, ou_params_unconstrained, param_names,
                     param_node, param_repeat, param_size, parameters,
                     params_from_numpy, params_to, perturb, perturb_mvn,
                     perturb_mvn_eigen, propose_identity, stack_flat,
                     unflatten_params)
from .sde import (Brownian, CompositeSde, GenBrownian, Ou, Sde,
                  brownian_motion, compose_sde, gen_brownian_motion,
                  ou_process)
from .tree import Branch, Leaf, Tree, branch, leaf, tree_map

__all__ = [
    "bijectors", "observation", "params", "sde", "tree",
    "Model", "LeafModel", "ComposedModel", "FirstElement", "Fourier",
    "poisson", "linear", "seasonal", "compose", "students_t", "bernoulli",
    "beta", "negative_binomial", "zero_inflated_poisson", "lgcp",
    "ObservationFamily", "Gaussian", "Poisson", "ZeroInflatedPoisson",
    "NegativeBinomial", "Bernoulli", "StudentsT", "Beta", "LogGaussianCox",
    "BrownianParams", "GenBrownianParams", "OuParams", "ParamNode",
    "brownian_params", "gen_brownian_params", "ou_params", "param_node",
    "parameters", "param_repeat", "params_from_numpy", "params_to",
    "brownian_params_unconstrained", "gen_brownian_params_unconstrained",
    "ou_params_unconstrained", "flatten_params", "unflatten_params",
    "param_size", "param_names", "add_flat", "propose_identity", "perturb",
    "perturb_mvn", "perturb_mvn_eigen", "mean_params", "stack_flat",
    "covariance_params",
    "Sde", "Brownian", "GenBrownian", "Ou", "CompositeSde",
    "brownian_motion", "gen_brownian_motion", "ou_process", "compose_sde",
    "Tree", "Leaf", "Branch", "leaf", "branch", "tree_map",
]
