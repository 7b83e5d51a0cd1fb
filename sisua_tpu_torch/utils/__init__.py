"""sisua_tpu_torch.utils — host utilities (counterpart of
``sisua_tpu.utils``, less the JAX profiler and XLA's compilation cache;
the port profiles with ``torch.profiler``). The plots import matplotlib
only when they render (``visualization``)."""

from .io_utils import (load_data_from_csv, save_data, save_data_to_R,
                       save_data_to_csv)
from .others import (UnitTimer, anything2image, apply_threshold,
                     dimension_reduction, filtering_experiment_path, mpi_map,
                     steady_window_rates, thresholding_by_sparsity,
                     thresholding_by_sparsity_matching)
from .plot_utils import (plot_countsum_comparison, plot_countsum_series,
                         plot_monitoring_epoch, plot_series_statistics)
from .visualization import (Visualizer, downsample_data, fast_scatter,
                            plot_evaluate_classifier,
                            plot_evaluate_reconstruction,
                            plot_evaluate_regressor, save_figures,
                            show_image)

__all__ = [
    "save_data", "save_data_to_csv", "save_data_to_R", "load_data_from_csv",
    "filtering_experiment_path", "dimension_reduction",
    "thresholding_by_sparsity", "thresholding_by_sparsity_matching",
    "apply_threshold", "anything2image", "UnitTimer", "steady_window_rates",
    "mpi_map",
    "plot_series_statistics", "plot_monitoring_epoch",
    "plot_countsum_series", "plot_countsum_comparison",
    "Visualizer", "fast_scatter", "plot_evaluate_classifier",
    "plot_evaluate_regressor", "plot_evaluate_reconstruction",
    "save_figures", "downsample_data", "show_image",
]
