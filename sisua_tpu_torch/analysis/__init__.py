"""sisua_tpu_torch.analysis: what a user runs on a fitted model
(counterpart of ``sisua_tpu.analysis``): the posterior hub
(``Posterior``), the disentanglement suite (``Criticizer``), the
latent-space scores, the training-time metric callbacks and the
imputation and marker-correlation scores, on the port's own estimators
(``estimators``: the card has no sklearn), the score table and the
comparison figures over many posteriors (``ResultsSheet``), the plots and
the monitor callbacks. A figure's data step runs on the device, its
render step needs matplotlib (``utils.visualization``).
"""

from .criticizer import Criticizer, discretize_factors
from .imputation import (correlation_scores, get_imputed_indices,
                         imputation_mean_score, imputation_score,
                         imputation_std_score, plot_imputation)
from .latent import (clustering_scores, multi_label_adj_Rindex,
                     plot_distance_heatmap, plot_latents_binary,
                     plot_latents_protein_pairs, streamline_classifier,
                     unsupervised_clustering_accuracy)
from .posterior import Posterior
from .results_sheet import ResultsSheet
from .sc_metrics import (ClusteringScores, CorrelationScores,
                         ImputationError, NegativeLogLikelihood,
                         SingleCellMetric)
from .sc_monitor import (HeatmapPlot, LearningCurves, ScatterPlot,
                         SingleCellMonitor)

__all__ = [
    "Posterior", "ResultsSheet", "Criticizer", "discretize_factors",
    "imputation_score", "imputation_mean_score", "imputation_std_score",
    "correlation_scores", "get_imputed_indices", "clustering_scores",
    "unsupervised_clustering_accuracy", "multi_label_adj_Rindex",
    "streamline_classifier", "SingleCellMetric", "NegativeLogLikelihood",
    "ImputationError", "CorrelationScores", "ClusteringScores",
    "plot_imputation", "plot_distance_heatmap", "plot_latents_protein_pairs",
    "plot_latents_binary", "SingleCellMonitor", "LearningCurves",
    "ScatterPlot", "HeatmapPlot",
]
