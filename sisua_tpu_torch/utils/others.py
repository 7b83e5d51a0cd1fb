"""Host utilities (port of ``sisua_tpu/utils/others.py``, less the JAX
profiler and XLA's compilation cache): the order-preserving process map
the analyzer fans its tasks over, experiment-directory filtering, the
one-call embedding wrapper (PCA, t-SNE and UMAP on the card; t-SNE's
tree and forces on the host), thresholding a reconstruction to a target
sparsity, the steady-window rate of a training history, and a wall-clock
timer.
"""

from __future__ import annotations

import os
import time
from typing import List, Sequence, Union

import numpy as np

__all__ = [
    "filtering_experiment_path", "dimension_reduction",
    "thresholding_by_sparsity", "thresholding_by_sparsity_matching",
    "apply_threshold", "anything2image", "UnitTimer", "steady_window_rates",
    "mpi_map",
]


def mpi_map(fn, jobs: Sequence, ncpu: int = 1, chunksize: int = 1) -> List:
  """Order-preserving process-pool map (used to fan the analysis matrices
  over cores). ``ncpu<=1`` (or a single job) runs inline, with the same
  results. Workers are spawned, not forked as in the JAX package: a fork
  under the threads of torch and of the CUDA driver can deadlock, so
  ``fn`` must be a module-level function and ``jobs`` picklable (each job
  carries its data). Each worker runs one BLAS/OpenMP thread."""
  jobs = list(jobs)
  if ncpu is None or ncpu <= 1 or len(jobs) <= 1:
    return [fn(j) for j in jobs]
  import multiprocessing as mp
  ctx = mp.get_context("spawn")
  with ctx.Pool(min(int(ncpu), len(jobs)),
                initializer=_mpi_worker_init) as pool:
    return pool.map(fn, jobs, chunksize=max(1, int(chunksize)))


def _mpi_worker_init():
  for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"


def filtering_experiment_path(path: str,
                              incl_keywords: Union[str, Sequence[str]] = (),
                              excl_keywords: Union[str, Sequence[str]] = (),
                              return_dataset: bool = False,
                              print_log: bool = False):
  """List experiment dirs under ``path`` whose names contain every include
  keyword and no exclude keyword (names are
  '<model>_<dataset>_<hash>')."""
  def _as_list(x):
    if isinstance(x, str):
      return [k for k in x.replace(",", " ").split() if k]
    return list(x)
  incl = _as_list(incl_keywords)
  excl = _as_list(excl_keywords)
  out = []
  for d in sorted(os.listdir(path)):
    full = os.path.join(path, d)
    if not os.path.isdir(full):
      continue
    name = d.lower()
    if all(k.lower() in name for k in incl) and \
        not any(k.lower() in name for k in excl):
      out.append(full)
      if print_log:
        print("[filter]", full)
  if return_dataset:
    datasets = sorted({os.path.basename(p).split("_")[1]
                       for p in out if "_" in os.path.basename(p)})
    return out, datasets
  return out


def dimension_reduction(x, algo: str = "pca", n_components: int = 2,
                        random_state: int = 5218,
                        device="cuda") -> np.ndarray:
  """One-call embedding of the rows of ``x``, float32: 'pca' (the port's
  sklearn-following PCA), 'tsne' (sklearn's Barnes-Hut t-SNE with a PCA
  start, on the first 50 PCs of a wider ``x``) or 'umap' (the port's
  UMAP, as the JAX package computes it without umap-learn), on
  ``device``. The JAX function falls back to t-SNE for 'umap' when
  umap-learn is missing; the port has its UMAP and runs it."""
  algo = str(algo).lower()
  x = np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x,
                 np.float32)
  n_components = min(n_components, x.shape[1])
  if algo == "pca":
    from ..analysis.decomposition import PCA
    return PCA(n_components, random_state=random_state,
               device=device).fit_transform(x).cpu().numpy()
  if algo == "umap":
    from ..data.umap_impl import fit_umap
    return fit_umap(x, n_components=max(2, min(n_components, 3)),
                    random_state=random_state, device=device)
  if algo == "tsne":
    from ..analysis.decomposition import PCA
    from ..analysis.manifold import TSNE
    if x.shape[1] > 50:
      x = PCA(50, random_state=random_state, device=device).fit_transform(x)
    return TSNE(n_components=max(2, min(n_components, 3)),
                random_state=random_state, init="pca",
                device=device).fit_transform(x).cpu().numpy()
  raise ValueError(f"Unknown algo '{algo}' (pca|tsne|umap)")


def anything2image(x: np.ndarray) -> np.ndarray:
  """Reshape a 1-D vector into the smallest zero-padded square image;
  pass 2-D/3-D through."""
  x = np.asarray(x)
  if x.ndim == 1:
    side = int(np.ceil(np.sqrt(x.shape[0])))
    z = np.zeros(side * side, dtype=x.dtype)
    z[:x.shape[0]] = x
    return z.reshape(side, side)
  if x.ndim in (2, 3):
    return x
  raise ValueError(f"No support for image with {x.ndim} dimensions")


def apply_threshold(x: np.ndarray, threshold: float) -> np.ndarray:
  """x<t → 0; t≤x<1 → 1; else x — binarize denoised counts at a threshold
  (the denoised counts' support)."""
  x = np.where(x < threshold, 0, x)
  return np.where(np.logical_and(0 < x, x < 1), 1, x).astype(np.int32)


def thresholding_by_sparsity_matching(T, W, *applying_data):
  """Find the threshold on reconstruction ``W`` whose support matches the
  sparsity of the original counts ``T``, then apply it to every extra array.
  Returns ``(threshold, tuple(new_data))``."""
  T = np.asarray(T)
  W = W[0] if isinstance(W, (tuple, list)) else np.asarray(W)
  if W.ndim == 3:
    W = W[0]
  assert W.ndim == 2
  n_nonzero = int(np.count_nonzero(T))
  best_threshold = 0.0
  for threshold in np.linspace(0, 1, num=100, endpoint=True)[::-1]:
    if int(np.sum(W >= threshold)) >= n_nonzero:
      best_threshold = float(threshold)
      break
  new_data = []
  for data in applying_data:
    if data is None:
      new_data.append(None)
      continue
    if isinstance(data, tuple):
      data = list(data)
    if isinstance(data, list) or np.asarray(data).ndim == 3:
      data[0] = apply_threshold(np.asarray(data[0]), best_threshold)
    else:
      data = apply_threshold(np.asarray(data), best_threshold)
    new_data.append(data)
  return best_threshold, tuple(new_data)


def thresholding_by_sparsity(w: np.ndarray, x_target: np.ndarray
                             ) -> np.ndarray:
  """Zero out the smallest entries of ``w`` until its sparsity matches the
  target count matrix — used to compare denoised
  reconstructions with raw counts at equal support."""
  w = np.array(w, np.float32)
  target_sparsity = float((np.asarray(x_target) == 0).mean())
  k = int(target_sparsity * w.size)
  if k <= 0:
    return w
  cut = np.partition(w.ravel(), k - 1)[k - 1]
  w[w <= cut] = 0.0
  return w


def steady_window_rates(rates, epochs: int, interval: int):
  """Collapse a per-epoch ``cells_per_sec`` history to one rate per steady
  measurement unit, dropping the compile-tainted first unit.

  With multi-epoch window executables (``epochs >= interval > 1``, the
  condition under which the trainer builds a window executable) every epoch
  inside a window shares the window's rate, so take one rate per FULL window
  and drop any trailing partial window (it compiles its own single-epoch
  executable). Below the interval the trainer runs per-epoch executables
  with DISTINCT rates — each epoch is then its own unit, and indexing by
  ``i * interval`` would re-select only the compile epoch.

  Always keeps at least one rate. A truncated history (early stop /
  terminate_on_nan: ``len(rates) < epochs``) degrades to fewer units, never
  an IndexError — and its trailing partial window DOES count as a unit: a
  truncated run reused the already-compiled window executable, so that rate
  is steady, unlike a planned trailing partial (``epochs`` not a multiple of
  ``interval``) which compiles its own single-epoch executable."""
  epochs, interval = int(epochs), int(interval)
  n = min(epochs, len(rates))
  if interval > 1 and epochs >= interval:
    n_full = n // interval
    units = [float(rates[i * interval]) for i in range(n_full)]
    if len(rates) < epochs and n % interval:
      units.append(float(rates[n_full * interval]))
    if not units:
      units = [float(rates[0])]
  else:
    units = [float(r) for r in rates[:max(1, n)]]
  return units[1:] if len(units) > 1 else units


class UnitTimer:
  """Context-manager wall-clock timer."""

  def __init__(self, name: str = "timer", print_log: bool = True):
    self.name = name
    self.print_log = print_log
    self.duration = 0.0

  def __enter__(self):
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    self.duration = time.perf_counter() - self._t0
    if self.print_log:
      print(f"[{self.name}] {self.duration:.4f}s")
