"""SingleCellOMIC: the port's multi-omic container, in numpy and scipy
(the subset of ``sisua_tpu/data/{core,dataset,analysis}.py`` that the
experiment path needs).

One matrix per omic (dense float32, or scipy CSR float32), each with its
var names; one *current* omic (the first added) that ``n_vars``,
``corrupt`` and the getters default to. ``obs`` is a dict of per-cell
arrays: ``cell_id``, ``indices`` (the source rows, kept through slicing)
and whatever a generator adds (``generate_citeseq``'s ``batch``). Each
omic keeps the JAX container's library statistics, ``(local_mean,
local_var)`` of its log total counts, computed when the omic is added or
corrupted and sliced with the rows, never recomputed on a slice: a split
keeps the whole dataset's statistics, as in the JAX package.

The subset: ``omics``, ``current_omic``, ``get_omic``, ``numpy``,
``get_var_names``, ``get_dim``, ``n_obs``, ``n_vars``, ``add_omic``, ``copy``, row indexing (``sco[rows]``), ``split``,
``corrupt``, ``get_library_size``, ``get_rv`` and ``create_dataset`` (the
port's ``DataFeeder``). Not ported: the pandas tables (``obs`` as a
DataFrame, ``var``), the analysis methods (HVG filters, PCA/t-SNE/UMAP,
clustering, the QC plots), ``apply_indices``, ``set_omic`` and the md5
equality.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse

from .const import UNIVERSAL_RANDOM_SEED
from .feeder import DataFeeder
from .utils import apply_artificial_corruption, get_library_size

__all__ = ["SingleCellOMIC"]

_COUNT_OMICS = ("transcriptomic", "atac", "genomic", "itranscriptomic",
                "iatac", "igenomic")
_NB_OMICS = ("proteomic", "iproteomic", "pmhc", "ipmhc")
_LABEL_OMICS = ("celltype", "disease", "progenitor", "tissue", "icelltype",
                "idisease", "iprogenitor", "itissue")


def _omic(o) -> str:
  return str(getattr(o, "name", o)).lower().strip()


def _as_matrix(X):
  if sparse.issparse(X):
    return X.tocsr().astype(np.float32)
  X = np.asarray(X)
  if X.ndim == 1:
    X = X[:, None]
  return np.ascontiguousarray(X, dtype=np.float32)


def _dedup(names: Sequence[str]) -> List[str]:
  """Suffix repeated names '.1', '.2', … in order (pandas'
  ``dedup_names``, which the JAX container applies)."""
  names = list(names)
  counts: Dict[str, int] = {}
  for i, col in enumerate(names):
    cur = counts.get(col, 0)
    while cur > 0:
      counts[col] = cur + 1
      col = f"{col}.{cur}"
      cur = counts.get(col, 0)
    names[i] = col
    counts[col] = cur + 1
  return names


def _is_binary(x) -> bool:
  if sparse.issparse(x):
    x = x.data
  flat = np.asarray(x).reshape(-1)
  for lo in range(0, flat.size, 16_777_216):
    chunk = flat[lo:lo + 16_777_216]
    if not np.all((chunk == 0) | (chunk == 1)):
      return False
  return True


def _is_categorical(x) -> bool:
  x = np.asarray(x.todense()) if sparse.issparse(x) else np.asarray(x)
  return x.ndim == 2 and bool(np.allclose(x.sum(-1), 1.0, atol=1e-3))


class SingleCellOMIC:
  """Multi-omic single-cell dataset (see the module docstring)."""

  def __init__(self,
               X,
               cell_id: Optional[Sequence[str]] = None,
               gene_id: Optional[Sequence[str]] = None,
               omic: str = "transcriptomic",
               name: Optional[str] = None):
    X = _as_matrix(X)
    n = X.shape[0]
    if cell_id is None:
      cell_id = [f"Cell#{i}" for i in range(n)]
    self.obs: Dict[str, np.ndarray] = {
        "cell_id": np.asarray(cell_id, str),
        "indices": np.arange(n, dtype=np.int64)}
    self._omics: Dict[str, object] = {}
    self._vars: Dict[str, np.ndarray] = {}
    self._library: Dict[str, np.ndarray] = {}
    self._name = name or "scOMIC"
    self._current_omic = _omic(omic)
    self.add_omic(omic, X, gene_id)

  # ------------------------------------------------------------------- omics
  @property
  def name(self) -> str:
    return self._name

  @property
  def current_omic(self) -> str:
    return self._current_omic

  @property
  def omics(self) -> List[str]:
    return list(self._omics)

  @property
  def n_obs(self) -> int:
    return int(self.obs["cell_id"].shape[0])

  @property
  def n_vars(self) -> int:
    return int(self._omics[self._current_omic].shape[1])

  def add_omic(self, omic, X, var_names: Optional[Sequence[str]] = None
               ) -> "SingleCellOMIC":
    """Register an omic matrix, its var names and its statistics."""
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
      if len(set(var_names.tolist())) != len(var_names):
        var_names = np.asarray(_dedup(var_names.tolist()), str)
    else:
      var_names = np.asarray([f"{omic}{i}" for i in range(X.shape[1])], str)
    self._omics[omic] = X
    self._vars[omic] = var_names
    self._calculate_statistics(omic)
    return self

  def get_omic(self, omic=None):
    return self._omics[self._current_omic if omic is None else _omic(omic)]

  def numpy(self, omic=None) -> np.ndarray:
    """Dense float32 matrix of an omic."""
    x = self.get_omic(omic)
    if sparse.issparse(x):
      x = x.toarray()
    return np.asarray(x, dtype=np.float32)

  def get_var_names(self, omic=None) -> np.ndarray:
    return self._vars[self._current_omic if omic is None else _omic(omic)]

  def get_dim(self, omic=None) -> int:
    return int(self.get_omic(omic).shape[1])

  # --------------------------------------------------------------- statistics
  def _calculate_statistics(self, omic: str) -> None:
    x = self._omics[omic]
    total = np.asarray(x.sum(axis=1)).ravel()
    if total.min() < 0:  # not counts (e.g. latent means): stats of |x|
      with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mean, var = get_library_size(
            np.abs(x.toarray() if sparse.issparse(x) else x))
    else:
      mean, var = get_library_size(x)
    self._library[omic] = np.concatenate([mean, var], 1).astype(np.float32)

  def get_library_size(self, omic=None) -> np.ndarray:
    """(n_cells, 2) ``[local_mean, local_var]``: the scVI library prior's
    parameters fed to the model."""
    return self._library[self._current_omic if omic is None
                         else _omic(omic)]

  def get_rv(self, omic=None):
    """The default likelihood of an omic: counts 'zinb', proteins 'nb',
    labels 'onehot', else 'diag'; binary counts 'bernoulli', one-hot
    proteins 'onehot'."""
    from ..rv import RVmeta
    name = self._current_omic if omic is None else _omic(omic)
    if name in _COUNT_OMICS:
      posterior = "zinb"
    elif name in _NB_OMICS:
      posterior = "nb"
    elif name in _LABEL_OMICS:
      posterior = "onehot"
    else:
      posterior = "diag"
    x = self._omics[name]
    if posterior == "nb" and _is_categorical(x):
      posterior = "onehot"
    elif posterior in ("zinb", "nb") and _is_binary(x):
      posterior = "bernoulli"
    return RVmeta(self.get_dim(name), posterior, True, name)

  # ------------------------------------------------------------------ slicing
  def __getitem__(self, index) -> "SingleCellOMIC":
    """Row (cell) selection across every omic; returns a copy."""
    if isinstance(index, (int, np.integer)):
      index = [int(index)]
    new = self.__class__.__new__(self.__class__)
    new.obs = {k: v[index] for k, v in self.obs.items()}
    new._omics = {k: v[index] for k, v in self._omics.items()}
    new._vars = {k: v.copy() for k, v in self._vars.items()}
    new._library = {k: v[index] for k, v in self._library.items()}
    new._name = self._name
    new._current_omic = self._current_omic
    return new

  def copy(self) -> "SingleCellOMIC":
    return self[np.arange(self.n_obs)]

  def split(self, train_percent: float = 0.8,
            seed: int = UNIVERSAL_RANDOM_SEED
            ) -> Tuple["SingleCellOMIC", "SingleCellOMIC"]:
    """Train/test split by a seeded permutation (the JAX container's)."""
    if not 0.0 < train_percent < 1.0:
      raise ValueError(f"train_percent must be in (0, 1), given "
                       f"{train_percent}")
    n = self.n_obs
    ids = np.random.RandomState(seed).permutation(n)
    n_train = int(np.ceil(train_percent * n))
    train = self[ids[:n_train]]
    test = self[ids[n_train:]]
    train._name = f"{self._name}_train"
    test._name = f"{self._name}_test"
    return train, test

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
    names = ([obj._current_omic] if omic is None else
             [_omic(o) for o in omic] if isinstance(omic, (list, tuple))
             else [_omic(omic)])
    for name in names:
      obj._omics[name] = apply_artificial_corruption(
          obj._omics[name], dropout=dropout_rate, distribution=distribution,
          retain_rate=retain_rate, copy=False, seed=seed)
      obj._calculate_statistics(name)
    return obj

  # ------------------------------------------------------------- data feeder
  def create_dataset(self,
                     omics=None,
                     labels_percent: float = 0.0,
                     batch_size: int = 64,
                     drop_remainder: bool = True,
                     shuffle: int = 1000,
                     seed: int = 1,
                     extra_matrices: Optional[Sequence] = None
                     ) -> DataFeeder:
    """``DataFeeder`` over ``omics`` (default the current one), the
    library statistics of the first, and cell-aligned ``extra_matrices``
    appended (a batch one-hot)."""
    if omics is None:
      omics = [self._current_omic]
    elif isinstance(omics, str):
      omics = [omics]
    mats = [self.get_omic(o) for o in omics]
    for m in extra_matrices or ():
      if m.shape[0] != self.n_obs:
        raise ValueError("an extra matrix must align on the cells")
      mats.append(m.tocsr().astype(np.float32) if sparse.issparse(m)
                  else np.asarray(m, np.float32))
    return DataFeeder(mats, library=self.get_library_size(omics[0]),
                      labels_percent=labels_percent, batch_size=batch_size,
                      drop_remainder=drop_remainder, shuffle=shuffle,
                      seed=seed)
