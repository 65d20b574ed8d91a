from . import bijectors, observation, params, sde, tree
from .model import (ComposedModel, FirstElement, Fourier, LeafModel, Model,
                    compose, linear, poisson, seasonal)
from .observation import Gaussian, ObservationFamily, Poisson
from .params import (BrownianParams, GenBrownianParams, OuParams, ParamNode,
                     brownian_params, gen_brownian_params, ou_params,
                     param_node, param_repeat, parameters, params_from_numpy,
                     params_to)
from .sde import (Brownian, CompositeSde, GenBrownian, Ou, Sde,
                  brownian_motion, compose_sde, gen_brownian_motion,
                  ou_process)
from .tree import Branch, Leaf, Tree, branch, leaf

__all__ = [
    "bijectors", "observation", "params", "sde", "tree",
    "Model", "LeafModel", "ComposedModel", "FirstElement", "Fourier",
    "poisson", "linear", "seasonal", "compose",
    "ObservationFamily", "Gaussian", "Poisson",
    "BrownianParams", "GenBrownianParams", "OuParams", "ParamNode",
    "brownian_params", "gen_brownian_params", "ou_params", "param_node",
    "parameters", "param_repeat", "params_from_numpy", "params_to",
    "Sde", "Brownian", "GenBrownian", "Ou", "CompositeSde",
    "brownian_motion", "gen_brownian_motion", "ou_process", "compose_sde",
    "Tree", "Leaf", "Branch", "leaf", "branch",
]
