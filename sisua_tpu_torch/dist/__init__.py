"""sisua_tpu_torch.dist — distributions of the SCVI slice (port of
``sisua_tpu.dist``)."""

from .base import (Distribution, Independent, NoAnalyticKL, kl_divergence,
                   register_kl)
from .continuous import MultivariateNormalDiag, Normal
from .count import (NegativeBinomial, NegativeBinomialDisp,
                    NegativeBinomialDispLog, NegativeBinomialLog,
                    ZeroInflated)

__all__ = [
    "Distribution", "Independent", "NoAnalyticKL", "kl_divergence",
    "register_kl", "MultivariateNormalDiag", "Normal", "NegativeBinomial",
    "NegativeBinomialDisp", "NegativeBinomialDispLog", "NegativeBinomialLog",
    "ZeroInflated",
]
