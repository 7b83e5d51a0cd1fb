"""sisua_tpu_torch.analysis — what a user runs on a fitted model: the
training-time metric callbacks and the imputation and marker-correlation
scores (counterpart of ``sisua_tpu.analysis``). ``Posterior``,
``Criticizer``, ``ClusteringScores``, the latent-space scores and the
plots wait for ROADMAP A12b (the card has no sklearn or matplotlib)."""

from .imputation import (correlation_scores, get_imputed_indices,
                         imputation_mean_score, imputation_score,
                         imputation_std_score)
from .sc_metrics import (CorrelationScores, ImputationError,
                         NegativeLogLikelihood, SingleCellMetric)

__all__ = [
    "imputation_score", "imputation_mean_score", "imputation_std_score",
    "correlation_scores", "get_imputed_indices", "SingleCellMetric",
    "NegativeLogLikelihood", "ImputationError", "CorrelationScores",
]
