"""sisua_tpu_torch.analysis: what a user runs on a fitted model
(counterpart of ``sisua_tpu.analysis``): the posterior hub
(``Posterior``), the disentanglement suite (``Criticizer``), the
latent-space scores, the training-time metric callbacks and the
imputation and marker-correlation scores, on the port's own estimators
(``estimators``: the card has no sklearn). ``ResultsSheet`` and the plots
wait for a plotting layer and a pandas-free score table (ROADMAP A12c).
"""

from .criticizer import Criticizer, discretize_factors
from .imputation import (correlation_scores, get_imputed_indices,
                         imputation_mean_score, imputation_score,
                         imputation_std_score)
from .latent import (clustering_scores, multi_label_adj_Rindex,
                     streamline_classifier, unsupervised_clustering_accuracy)
from .posterior import Posterior
from .sc_metrics import (ClusteringScores, CorrelationScores,
                         ImputationError, NegativeLogLikelihood,
                         SingleCellMetric)

__all__ = [
    "Posterior", "Criticizer", "discretize_factors",
    "imputation_score", "imputation_mean_score", "imputation_std_score",
    "correlation_scores", "get_imputed_indices", "clustering_scores",
    "unsupervised_clustering_accuracy", "multi_label_adj_Rindex",
    "streamline_classifier", "SingleCellMetric", "NegativeLogLikelihood",
    "ImputationError", "CorrelationScores", "ClusteringScores",
]
