"""sisua_tpu_torch — the PyTorch + CUDA port of sisua_tpu.

The JAX package ``sisua_tpu`` stays the reference; this package mirrors its
module layout and names (``dist``, ``rv``, ``nn``, ``ops``, ``models``,
``train``, ``data``, ``analysis``) so each counterpart is found by path. It
imports ``torch`` and never ``jax``, ``flax``, ``optax`` or ``pandas``, and
nothing from ``sisua_tpu``.

The Pallas kernels of the JAX package are CUDA C++ in ``csrc/`` (the fused
ZINB/NB log-likelihood forward and backward, with a member axis for
vmapped ensembles, and the speed-of-light probes), built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes`` (``ops/_build.py``). On
CPU tensors every kernel wrapper runs its plain PyTorch version instead.

Port state: every model of the JAX zoo, ``fit`` with its streaming,
device-resident and out-of-core loops (validation, early stopping, the
seven optimizers, mixed precision, ``scan_steps``), ``evaluate`` and
serving, checkpoints either package reads, the vmapped ensemble of any
model class (``train.VmapEnsemble``) and the on-card hyper-parameter search
(``models.hyper_params.fit_hyper_vmap``), and what a user runs on a
fitted model (``analysis``: the posterior hub ``Posterior`` with its
``Criticizer``, the latent-space scores on the port's own estimators,
the training-time metric callbacks, the imputation and marker-correlation
scores; ``label_threshold.ProbabilisticEmbedding``;
``differential_expression``; ``ops.knn_mi``, the gene × protein mutual
information on the card), and the experiment entry points: the YAML
experimenter and its sqlite scoreboard (``train.experimenter``,
``train.scoreboard``), ``fit_hyper``, the numpy synthetic datasets behind
``data.get_dataset``, ``analysis.ResultsSheet``, ``cross_analyze`` and the
``cli`` package (train, predict, evaluate, embed, showdata); the data
ingestion layer (``data.loaders``: the registry's loaders on raw files or
caches placed under ``$SISUA_DATA``, the 10x and AnnData readers, the
``OMIC`` flag); the figures
(each a data step in torch on the device and a matplotlib render step:
the ``plot_*`` methods of ``SingleCellOMIC``, ``Posterior`` and
``ResultsSheet``, the monitor callbacks); the data analyzer of
``data.SingleCellOMIC`` (QC, filters, PCA/UMAP, neighbours, clusterings,
rank tests, correlations, mutual information, importances, PCA, t-SNE
and UMAP) on the card, ``utils``, the classical baselines
(``baselines.run_baseline``: PCA, probabilistic PCA, sparse PCA, NMF
and factor analysis, scored like the deep models), and the device mesh
(``parallel``: ``fit``, serving, the fleet, the experimenter, the
posterior and the CLIs over a (data × model) mesh of
``torch.distributed`` ranks). Top-level names resolve
lazily, as in the JAX package: ``sisua_tpu_torch.SCVI``, ``.get_model``,
``.load_model``, ``.Trainer``, ``.DataFeeder``, ``.VmapEnsemble``,
``.Posterior``, ``.SisuaExperimenter``, ``.get_dataset``, ``.OMIC``.
"""

__version__ = "0.1.0"

_SUBMODULES = ("data", "models", "train", "dist", "nn", "rv", "ops",
               "interpolation", "convert", "native", "analysis",
               "label_threshold", "baselines", "cli", "utils",
               "cross_analyze", "parallel")


def __getattr__(name):
  """Lazy top-level re-exports from ``models``, ``data``, ``analysis``
  and ``train``; submodule names resolve directly first."""
  import importlib
  if name in _SUBMODULES:
    return importlib.import_module(f".{name}", __name__)
  if name.startswith("__"):
    raise AttributeError(name)
  for module in ("models", "data", "analysis", "train"):
    mod = importlib.import_module(f".{module}", __name__)
    if hasattr(mod, name):
      return getattr(mod, name)
  raise AttributeError(f"module 'sisua_tpu_torch' has no attribute {name!r}")


# the JAX package's top-level names that the port has (a static list, so
# dir() does not import the models)
_TOP_LEVEL_NAMES = (
    "Posterior", "Criticizer", "MISA", "SCALE", "SCALAR", "SCVI", "SISUA", "VAE", "TotalVI",
    "DeepCountAutoencoder", "SCScope", "FVAE", "SemiFVAE", "AUTOZI", "SOLO",
    "CellAssign", "NetConf", "RVmeta", "SingleCellModel", "get_model",
    "load_model", "Trainer", "VmapEnsemble", "DataFeeder",
    "MARKER_ADT_GENE", "MARKER_ADTS", "MARKER_ATAC", "MARKER_GENES",
    "PROTEIN_PAIR_NEGATIVE", "PROTEIN_PAIR_POSITIVE",
    "standardize_protein_name",
    "OMIC", "SingleCellOMIC", "get_dataset", "get_dataset_meta",
    "get_dataset_availability", "ResultsSheet",
    "SisuaExperimenter",
)


def __dir__():
  return sorted(set(_SUBMODULES) | set(_TOP_LEVEL_NAMES) | {"__version__"})
