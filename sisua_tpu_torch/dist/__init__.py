"""sisua_tpu_torch.dist — the port's distributions (counterpart of
``sisua_tpu.dist``)."""

from .base import (Distribution, Independent, NoAnalyticKL,
                   concat_distributions, kl_divergence, mc_kl_divergence,
                   register_kl, stack_distributions, tree_map)
from .continuous import (Gamma, LogNormal, MultivariateNormalDiag,
                         MultivariateNormalTriL, NonzeroMaskedDeterministic,
                         Normal, VectorDeterministic)
from .count import (Bernoulli, NegativeBinomial, NegativeBinomialDisp,
                    NegativeBinomialDispLog, NegativeBinomialLog,
                    NegativeBinomialMixture, Poisson, ZeroInflated)
from .discrete import Categorical, OneHotCategorical
from .mixture import MixtureSameFamily

__all__ = [
    "Distribution", "Independent", "NoAnalyticKL", "kl_divergence",
    "mc_kl_divergence", "concat_distributions", "stack_distributions",
    "register_kl", "tree_map", "MultivariateNormalDiag",
    "MultivariateNormalTriL", "Normal",
    "VectorDeterministic", "NonzeroMaskedDeterministic", "Gamma", "LogNormal",
    "Poisson", "Bernoulli", "NegativeBinomial", "NegativeBinomialDisp",
    "NegativeBinomialDispLog", "NegativeBinomialLog",
    "NegativeBinomialMixture", "ZeroInflated",
    "Categorical", "OneHotCategorical", "MixtureSameFamily",
]
