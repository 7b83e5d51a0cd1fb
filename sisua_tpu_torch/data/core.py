"""The base of the port's multi-omic container, in numpy and scipy (port
of ``sisua_tpu/data/core.py``). ``_OMICbase`` ← ``data/analysis.py``'s
``_OMICanalyzer`` (the analysis methods) ← ``data/visualizer.py``'s
``_OMICvisualizer`` (the figures) ← ``data/dataset.py``'s
``SingleCellOMIC`` (``split``), as in the JAX package.

One matrix per omic (dense float32, or scipy CSR float32), each with its
var table; one *current* omic (the first added, or the one ``set_omic``
names) that ``X``, ``var``, ``n_vars`` and the getters default to. The
JAX container's pandas tables are dicts of numpy columns here:

  * ``obs``: per-cell columns, ``cell_id``, ``indices`` (the source rows,
    kept through slicing), each omic's statistics ``<omic>_total``,
    ``_log_counts``, ``_local_mean`` and ``_local_var`` (the scVI library
    prior: mean and variance of the log total counts), and what an
    analysis or a generator adds (cluster ids, QC columns, a ``batch``);
  * ``get_var(omic)``: that omic's per-variable columns, the var names
    under ``'var'`` (the JAX table's index) and what an analysis adds
    (``highly_variable``, the QC columns);
  * ``uns`` (fitted models, graphs, score tables) and ``obsm`` (per-cell
    matrices: embeddings, probabilities), as in the JAX container.

The statistics are computed when an omic is added or its values change
(``set_omic``, ``X``, ``corrupt``, the normalizations, a gene filter) and
sliced with the rows otherwise: a split keeps the whole dataset's
statistics, as in the JAX package. Every mutating call is recorded in
``history``; ``md5`` hashes the matrices and equality compares it.
Omics are named by strings, the names of the ``OMIC`` flag
(``const.py``), which every method takes too; a name joined by '_'
(``'transcriptomic_proteomic'``, or ``OMIC.transcriptomic |
OMIC.proteomic``) or a list names several.
"""

from __future__ import annotations

import hashlib
import warnings
from numbers import Number
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse

from .const import MARKER_GENES, get_all_omics
from .feeder import DataFeeder
from .utils import (apply_artificial_corruption, dedup_names,
                    get_library_size, is_binary_dtype, is_categorical_dtype)

__all__ = ["_OMICbase", "get_all_omics"]

_COUNT_OMICS = ("transcriptomic", "atac", "genomic", "itranscriptomic",
                "iatac", "igenomic")
_NB_OMICS = ("proteomic", "iproteomic", "pmhc", "ipmhc")
_LABEL_OMICS = ("celltype", "disease", "progenitor", "tissue", "icelltype",
                "idisease", "iprogenitor", "itissue")
_STATS = ("total", "log_counts", "local_mean", "local_var")


def _omic(o) -> str:
  return str(getattr(o, "name", o)).lower().strip()


def _as_matrix(X):
  if sparse.issparse(X):
    return X.tocsr().astype(np.float32)
  X = np.asarray(X)
  if X.ndim == 1:
    X = X[:, None]
  return np.ascontiguousarray(X, dtype=np.float32)


def _five(v) -> str:
  v = np.asarray(v, np.float64).ravel()
  if v.size == 0:
    return "(empty)"
  return (f"min:{v.min():.2f} q1:{np.percentile(v, 25):.2f} "
          f"med:{np.median(v):.2f} q3:{np.percentile(v, 75):.2f} "
          f"max:{v.max():.2f} mean:{v.mean():.2f}")


class _OMICbase:
  """The container's base: omics, statistics, slicing, corruption (see
  the module docstring)."""

  def __init__(self,
               X,
               cell_id: Optional[Sequence[str]] = None,
               gene_id: Optional[Sequence[str]] = None,
               omic: str = "transcriptomic",
               name: Optional[str] = None,
               duplicated_var: bool = False):
    X = _as_matrix(X)
    n = X.shape[0]
    if cell_id is None:
      cell_id = [f"Cell#{i}" for i in range(n)]
    self.obs: Dict[str, np.ndarray] = {
        "cell_id": np.asarray(cell_id, str),
        "indices": np.arange(n, dtype=np.int64)}
    self._omics: Dict[str, object] = {}
    self._vars: Dict[str, Dict[str, np.ndarray]] = {}
    self.uns: Dict = {}
    self.obsm: Dict[str, np.ndarray] = {}
    self._history: List[Tuple[str, dict]] = []
    self._name = name or "scOMIC"
    self._current_omic = _omic(omic)
    self._duplicated_var = bool(duplicated_var)
    self._verbose = False
    self.add_omic(omic, X, gene_id)

  # ------------------------------------------------------------------ caches
  def _invalidate_analysis_caches(self, omic: Optional[str] = None,
                                  rows_only: bool = False):
    """The base derives nothing; ``_OMICanalyzer`` drops its caches."""

  # ------------------------------------------------------------------ history
  def _record(self, name: str, local_vars: dict):
    kw = {k: v for k, v in local_vars.items()
          if k not in ("self", "__class__") and isinstance(
              v, (Number, str, bool, type(None), tuple))}
    self._history.append((name, kw))
    if self._verbose:
      print(f"[{self._name}] {name}({kw})")

  @property
  def history(self) -> List[Tuple[str, dict]]:
    return list(self._history)

  def set_verbose(self, verbose) -> "SingleCellOMIC":
    """If True, each recorded call is printed as it is made."""
    self._verbose = bool(verbose)
    return self

  @property
  def verbose(self) -> bool:
    return self._verbose

  # ------------------------------------------------------------------- omics
  def _omic_names(self, omic=None) -> List[str]:
    """The omics ``omic`` names: None the current one, a list each, a
    name joined by '_' each part (when every part is an omic)."""
    if omic is None:
      return [self._current_omic]
    if isinstance(omic, (list, tuple)):
      return [_omic(o) for o in omic]
    name = _omic(omic)
    parts = name.split("_")
    if name not in self._omics and len(parts) > 1 and all(
        p in self._omics for p in parts):
      return parts
    return [name]

  def _one(self, omic=None) -> str:
    return self._current_omic if omic is None else _omic(omic)

  @property
  def name(self) -> str:
    return self._name

  @property
  def current_omic(self) -> str:
    return self._current_omic

  def get_current_omic(self) -> str:
    return self._current_omic

  @property
  def omics(self) -> List[str]:
    return list(self._omics)

  @property
  def n_omics(self) -> int:
    return len(self._omics)

  @property
  def n_obs(self) -> int:
    return int(self.obs["cell_id"].shape[0])

  @property
  def n_vars(self) -> int:
    return int(self._omics[self._current_omic].shape[1])

  @property
  def shape(self) -> Tuple[int, int]:
    return (self.n_obs, self.n_vars)

  @property
  def X(self):
    return self._omics[self._current_omic]

  @X.setter
  def X(self, value):
    value = _as_matrix(value)
    if value.shape != self.X.shape:
      raise ValueError(f"Cannot change shape via .X: {self.X.shape} → "
                       f"{value.shape}")
    self._omics[self._current_omic] = value
    self._calculate_statistics(self._current_omic)
    self._invalidate_analysis_caches(self._current_omic)

  @property
  def var(self) -> Dict[str, np.ndarray]:
    return self._vars[self._current_omic]

  @property
  def var_names(self) -> np.ndarray:
    return self.var["var"]

  @property
  def obs_names(self) -> np.ndarray:
    return self.obs["cell_id"]

  def add_omic(self, omic, X, var_names: Optional[Sequence[str]] = None
               ) -> "SingleCellOMIC":
    """Register an omic matrix, its var table and its statistics. Repeated
    var names are suffixed '.1', '.2', … unless ``duplicated_var``."""
    omic = _omic(omic)
    X = _as_matrix(X)
    if X.shape[0] != self.n_obs:
      raise ValueError(f"Omic {omic} has {X.shape[0]} cells, the container "
                       f"has {self.n_obs}")
    if var_names is not None:
      var_names = np.asarray(var_names, str)
      if len(var_names) != X.shape[1]:
        raise ValueError(f"{len(var_names)} var names for {X.shape[1]} "
                         f"columns of {omic}")
      if not self._duplicated_var and len(set(var_names.tolist())) != len(
          var_names):
        var_names = np.asarray(dedup_names(var_names.tolist()), str)
    else:
      var_names = np.asarray([f"{omic}{i}" for i in range(X.shape[1])], str)
    self._omics[omic] = X
    self._vars[omic] = {"var": var_names}
    self._calculate_statistics(omic)
    self._record("add_omic", dict(omic=omic, shape=tuple(X.shape)))
    return self

  def set_omic(self, omic, X=None, recalculate_statistics: bool = True
               ) -> "SingleCellOMIC":
    """With ``X``, replace an omic's matrix in place (same shape; the
    statistics recomputed); without, make ``omic`` the current one."""
    omic = _omic(omic)
    if omic not in self._omics:
      raise KeyError(f"No omic {omic} in {self.omics}")
    if X is not None:
      X = _as_matrix(X)
      old = self._omics[omic]
      if X.shape != old.shape:
        raise ValueError(f"Dimensions mismatch, {omic} has dim={old.shape} "
                         f"but given: {X.shape}")
      self._omics[omic] = X
      if recalculate_statistics:
        self._calculate_statistics(omic)
      self._record("set_omic", dict(omic=omic, shape=tuple(X.shape)))
    else:
      self._current_omic = omic
    return self

  def _swap_omic(self, omic) -> "SingleCellOMIC":
    """A copy whose current omic is ``omic``."""
    new = self.copy()
    new.set_omic(omic)
    return new

  def get_omic(self, omic=None):
    return self._omics[self._one(omic)]

  def numpy(self, omic=None) -> np.ndarray:
    """Dense float32 matrix of an omic."""
    x = self.get_omic(omic)
    if sparse.issparse(x):
      x = x.toarray()
    return np.asarray(x, dtype=np.float32)

  def get_var(self, omic=None) -> Dict[str, np.ndarray]:
    """The omic's var table: ``{column: array}``, names under 'var'."""
    return self._vars[self._one(omic)]

  def get_var_indices(self, omic=None) -> Dict[str, int]:
    return {name: i for i, name in enumerate(self.get_var_names(omic))}

  def get_var_names(self, omic=None) -> np.ndarray:
    return self._vars[self._one(omic)]["var"]

  def get_dim(self, omic=None) -> int:
    return int(self.get_omic(omic).shape[1])

  def get_n_var(self, omic=None) -> int:
    return self.get_dim(omic)

  # --------------------------------------------------------------- statistics
  def _calculate_statistics(self, omic=None) -> None:
    omic = self._one(omic)
    x = self._omics[omic]
    total = np.asarray(x.sum(axis=1)).ravel()
    if total.min() < 0:  # not counts (e.g. latent means): stats of |x|
      with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stats = get_library_size(
            np.abs(x.toarray() if sparse.issparse(x) else x),
            return_log_count=True)
    else:
      stats = get_library_size(x, return_log_count=True)
    self.obs[f"{omic}_total"] = total.astype(np.float32)
    for key, value in zip(_STATS[1:], stats):
      self.obs[f"{omic}_{key}"] = value.ravel()

  def get_library_size(self, omic=None) -> np.ndarray:
    """(n_cells, 2) ``[local_mean, local_var]``: the scVI library prior's
    parameters fed to the model."""
    omic = self._one(omic)
    return np.stack([self.obs[f"{omic}_local_mean"],
                     self.obs[f"{omic}_local_var"]], 1).astype(np.float32)

  def stats(self, omic=None) -> Dict[str, np.ndarray]:
    omic = self._one(omic)
    return {k: self.obs[f"{omic}_{k}"] for k in _STATS}

  def _stat_column(self, omic, key) -> np.ndarray:
    return self.obs[f"{self._one(omic)}_{key}"][:, None].astype(np.float32)

  def total_counts(self, omic=None) -> np.ndarray:
    return self._stat_column(omic, "total")

  def log_counts(self, omic=None) -> np.ndarray:
    return self._stat_column(omic, "log_counts")

  def local_mean(self, omic=None) -> np.ndarray:
    return self._stat_column(omic, "local_mean")

  def local_var(self, omic=None) -> np.ndarray:
    return self._stat_column(omic, "local_var")

  def library_size(self, omic=None) -> Tuple[np.ndarray, np.ndarray]:
    """``(local_mean, local_var)``, each (n_cells, 1)."""
    return self.local_mean(omic), self.local_var(omic)

  def sparsity(self, omic=None) -> float:
    """Fraction of zero entries of an omic."""
    x = self.get_omic(omic)
    nnz = x.nnz if sparse.issparse(x) else np.count_nonzero(x)
    return 1.0 - nnz / (x.shape[0] * x.shape[1])

  def counts_per_cell(self, omic=None) -> np.ndarray:
    return np.asarray(self.get_omic(omic).sum(axis=1)).ravel()

  def counts_per_gene(self, omic=None) -> np.ndarray:
    return np.asarray(self.get_omic(omic).sum(axis=0)).ravel()

  # ------------------------------------------------------- id accessors
  @property
  def indices(self) -> np.ndarray:
    """The source rows of these cells (kept through slicing)."""
    return self.obs["indices"]

  @property
  def cell_id(self) -> np.ndarray:
    return self.obs["cell_id"]

  @property
  def gene_id(self) -> np.ndarray:
    return self.var_names

  @property
  def marker_genes(self) -> List[str]:
    """Var names of the current omic that are known marker genes."""
    known = {g.lower() for g in MARKER_GENES}
    return [g for g in self.gene_id if g.lower() in known]

  @property
  def dtype(self):
    return self.X.dtype

  def is_binary(self, omic=None) -> bool:
    return is_binary_dtype(self.get_omic(omic))

  def is_categorical(self, omic=None) -> bool:
    return is_categorical_dtype(self.get_omic(omic))

  # ------------------------------------------------------------- labels
  def get_labels_name(self, omic="proteomic") -> str:
    return f"{_omic(omic)}_labels"

  def labels(self, omic="proteomic") -> np.ndarray:
    """Per-cell label names of a label-like omic: the ``<omic>_labels``
    obs column, made from the argmax var name when absent."""
    omic = _omic(omic)
    key = self.get_labels_name(omic)
    if key not in self.obs:
      if omic not in self._omics:
        raise KeyError(f"No omic {omic} in {self.omics}")
      ids = np.argmax(self.numpy(omic), axis=1)
      self.obs[key] = self.get_var_names(omic)[ids]
    return self.obs[key]

  def describe(self) -> str:
    """Multi-line text summary of every omic."""
    pad = "\n     "
    text = f"SingleCellOMICs: {self.name}"
    for omic in self.omics:
      x = self.get_omic(omic)
      nz = x.data if sparse.issparse(x) else np.asarray(x)[np.nonzero(x)]
      kind = "binary" if self.is_binary(omic) else "continuous"
      text += f"\n  OMIC: '{omic}' - dtype: '{kind}'"
      text += pad + f"Sparsity  : {self.sparsity(omic):.2f}"
      text += pad + f"Nonzeros  : {_five(nz)}"
      text += pad + f"Cell      : {_five(self.counts_per_cell(omic))}"
      text += pad + f"Gene      : {_five(self.counts_per_gene(omic))}"
      text += pad + f"LogCount  : {_five(self.log_counts(omic))}"
      text += pad + f"LocalMean : {_five(self.local_mean(omic))}"
      text += pad + f"LocalVar  : {_five(self.local_var(omic))}"
    return text

  # ---------------------------------------------------------------- defaults
  def get_rv(self, omic=None):
    """The default likelihood of an omic: counts 'zinb', proteins 'nb',
    labels 'onehot', else 'diag'; binary counts 'bernoulli', one-hot
    proteins 'onehot'."""
    from ..rv import RVmeta
    name = self._one(omic)
    if name in _COUNT_OMICS:
      posterior = "zinb"
    elif name in _NB_OMICS:
      posterior = "nb"
    elif name in _LABEL_OMICS:
      posterior = "onehot"
    else:
      posterior = "diag"
    x = self._omics[name]
    if posterior == "nb" and is_categorical_dtype(x):
      posterior = "onehot"
    elif posterior in ("zinb", "nb") and is_binary_dtype(x):
      posterior = "bernoulli"
    return RVmeta(self.get_dim(name), posterior, True, name)

  create_rv = get_rv

  # ------------------------------------------------------------------ slicing
  def __getitem__(self, index) -> "SingleCellOMIC":
    """Row (cell) selection across every omic; returns a copy."""
    if isinstance(index, (int, np.integer)):
      index = [int(index)]
    new = self.__class__.__new__(self.__class__)
    new.obs = {k: v[index] for k, v in self.obs.items()}
    new._omics = {k: v[index] for k, v in self._omics.items()}
    new._vars = {k: dict(v) for k, v in self._vars.items()}
    new.uns = dict(self.uns)
    new.obsm = {k: v[index] for k, v in self.obsm.items()}
    new._history = list(self._history)
    new._name = self._name
    new._current_omic = self._current_omic
    new._duplicated_var = self._duplicated_var
    new._verbose = self._verbose
    return new

  def copy(self) -> "SingleCellOMIC":
    return self[np.arange(self.n_obs)]

  def apply_indices(self, indices, observation: bool = True
                    ) -> "SingleCellOMIC":
    """In place: keep these rows (``observation``) or these columns of
    the current omic. Caches of the population (graphs, score tables)
    are dropped on a row selection; everything derived from the omic on
    a column selection."""
    indices = np.asarray(indices)
    if indices.dtype == bool:
      indices = np.nonzero(indices)[0]
    if observation:
      self.obs = {k: v[indices] for k, v in self.obs.items()}
      self._omics = {k: v[indices] for k, v in self._omics.items()}
      self.obsm = {k: v[indices] for k, v in self.obsm.items()}
      self._invalidate_analysis_caches(rows_only=True)
    else:
      name = self._current_omic
      self._omics[name] = self._omics[name][:, indices]
      self._vars[name] = {k: v[indices] for k, v in self._vars[name].items()}
      self._calculate_statistics(name)
      self._invalidate_analysis_caches(name)
    self._record("apply_indices",
                 dict(n=int(len(indices)), observation=observation))
    return self

  def corrupt(self,
              omic=None,
              dropout_rate: float = 0.2,
              retain_rate: float = 0.2,
              distribution: str = "binomial",
              inplace: bool = True,
              seed: int = 8) -> "SingleCellOMIC":
    """Artificial count corruption of an omic (default the current one;
    a list corrupts each), through ``apply_artificial_corruption``, and
    its statistics recomputed from the corrupted counts."""
    obj = self if inplace else self.copy()
    names = obj._omic_names(omic)
    for name in names:
      obj._omics[name] = apply_artificial_corruption(
          obj._omics[name], dropout=dropout_rate, distribution=distribution,
          retain_rate=retain_rate, copy=False, seed=seed)
      obj._calculate_statistics(name)
      obj._invalidate_analysis_caches(name)
    obj._record("corrupt", dict(omic="_".join(names),
                                dropout_rate=dropout_rate,
                                retain_rate=retain_rate,
                                distribution=distribution, seed=seed))
    return obj

  # ------------------------------------------------------------------- equal
  def _md5(self) -> str:
    h = hashlib.md5()
    for k in sorted(self._omics):
      x = self._omics[k]
      if sparse.issparse(x):
        h.update(x.indptr.tobytes())
        h.update(x.indices.tobytes())
        h.update(np.ascontiguousarray(x.data).tobytes())
      else:
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()

  @property
  def md5(self) -> str:
    return self._md5()

  def __eq__(self, other) -> bool:
    return isinstance(other, _OMICbase) and self._md5() == other._md5()

  def __hash__(self):
    return id(self)

  def assert_matching_cells(self, other: "SingleCellOMIC"
                            ) -> "SingleCellOMIC":
    if self.n_obs != other.n_obs:
      raise ValueError(f"Cell mismatch: {self.n_obs} vs {other.n_obs}")
    return self

  def __repr__(self):
    lines = [f"SingleCellOMIC '{self._name}' cells={self.n_obs} "
             f"current={self._current_omic}"]
    for k, v in self._omics.items():
      kind = "sparse" if sparse.issparse(v) else "dense"
      lines.append(f"  omic {k}: {v.shape} ({kind})")
    if self._history:
      lines.append("  history:")
      for (fn, kw) in self._history[-8:]:
        lines.append(f"    {fn}({', '.join(f'{a}={b}' for a, b in kw.items())})")
    return "\n".join(lines)

  # ------------------------------------------------------------- data feeder
  def create_dataset(self,
                     omics=None,
                     labels_percent: float = 0.0,
                     batch_size: int = 64,
                     drop_remainder: bool = True,
                     shuffle: int = 1000,
                     seed: int = 1,
                     framework: str = "numpy",
                     extra_matrices: Optional[Sequence] = None
                     ) -> DataFeeder:
    """``DataFeeder`` over ``omics`` (default the current one), the
    library statistics of the first, and cell-aligned ``extra_matrices``
    appended (a batch one-hot). ``framework`` is the JAX signature's: the
    feeder gives numpy batches whatever it says, as there."""
    omics = self._omic_names(omics)
    mats = [self.get_omic(o) for o in omics]
    for m in extra_matrices or ():
      if m.shape[0] != self.n_obs:
        raise ValueError("an extra matrix must align on the cells")
      mats.append(m.tocsr().astype(np.float32) if sparse.issparse(m)
                  else np.asarray(m, np.float32))
    self._record("create_dataset",
                 dict(omics=tuple(omics),
                      labels_percent=float(labels_percent),
                      batch_size=batch_size))
    return DataFeeder(mats, library=self.get_library_size(omics[0]),
                      labels_percent=labels_percent, batch_size=batch_size,
                      drop_remainder=drop_remainder, shuffle=shuffle,
                      seed=seed)
