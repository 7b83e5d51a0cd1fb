"""PBMC 8k CITE-seq loader, the paper's flagship ``8k*`` sets (port of
``sisua_tpu/data/loaders/pbmc8k.py``): PBMC-8k cells with transcriptomic
+ proteomic omics, a lymphoid/myeloid split (ly / my / full), and a
binary progenitor label from the lineage.

Acquisition order:

1. The author-preprocessed CITE-seq bundles (npz files on public S3),
   placed under DOWNLOAD_DIR or downloaded. These carry the real
   per-cell ADT table (``y``/``y_col``).
2. Else: rebuild RNA from the public 10x pbmc8k run; the
   proteomic omic is a pre-placed ADT table (``$SISUA_DATA/pbmc8k_adt``) if
   present, else a marker-gene surrogate flagged
   ``uns['proteomic_is_surrogate']``.

Caches built from path 1 carry a ``cell_types.npz`` sidecar: its presence
marks the cached ``y`` table as real ADT rather than the rebuilt
progenitor matrix.
"""

from __future__ import annotations

import os

import numpy as np

from ..const import OMIC, MARKER_ADT_GENE
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR, DOWNLOAD_DIR
from ..utils import (download_file, load_from_dataset, save_to_dataset,
                     validate_data_dir)
from .tenx import read_dataset10x

__all__ = ["read_PBMC8k"]

# lymphoid vs myeloid marker genes that derive the subset and progenitor
# labels
_LYMPHOID_MARKERS = ("CD3D", "CD3E", "CD8A", "CD8B", "IL7R", "CD19", "MS4A1",
                     "NKG7", "GNLY", "CD79A")
_MYELOID_MARKERS = ("LYZ", "CD14", "FCGR3A", "MS4A7", "FCER1A", "CST3",
                    "S100A8")

# the author-preprocessed CITE-seq bundles (public S3)
_AUTHOR_BUNDLES = {
    "ly": "https://s3.amazonaws.com/ai-datasets/pbmc8k_ly.npz",
    "my": "https://s3.amazonaws.com/ai-datasets/pbmc8k_my.npz",
    "full": "https://s3.amazonaws.com/ai-datasets/pbmc8k_full.npz",
}


def _drop_allzero_columns(X, cols, verbose: bool):
  keep = np.asarray((X > 0).sum(0)).ravel() > 0
  if keep.all():
    return X, np.asarray(cols)
  if verbose:
    print(f"Dropped {int((~keep).sum())} all-zero columns")
  return X[:, keep], np.asarray(cols)[keep]


def _fetch_author_bundle(urls, subset: str, filtered_genes: bool,
                         cache: str, verbose: bool) -> bool:
  """Try building `cache` from the author-preprocessed npz (real ADT).

  Returns False when the bundle cannot be downloaded (offline) or a subset
  has no published bundle — callers then fall back to the public-10x
  rebuild. The npz schema: ly/my carry
  ``X_filt``/``X_full`` + ``y`` (protein counts); full carries ``X`` + ``y``.
  """
  url = urls.get(subset)
  if url is None:
    return False
  try:
    path = download_file(url, os.path.join(DOWNLOAD_DIR,
                                           os.path.basename(url)))
  except RuntimeError:
    return False
  data = np.load(path, allow_pickle=True)
  if subset == "full":
    X, X_col = data["X"], np.asarray(data["X_col"], str)
    # lineage labels from membership in the ly bundle's rows; without that
    # second file, from the marker genes
    try:
      ly_path = download_file(urls["ly"], os.path.join(
          DOWNLOAD_DIR, os.path.basename(urls["ly"])))
      ly_rows = set(np.asarray(np.load(ly_path, allow_pickle=True)["X_row"],
                               str).tolist())
      cell_types = np.array(["ly" if r in ly_rows else "my"
                             for r in np.asarray(data["X_row"], str)])
    except RuntimeError:
      gi = {g: i for i, g in enumerate(X_col)}
      ly_s = np.log1p(X[:, [gi[g] for g in _LYMPHOID_MARKERS
                            if g in gi]]).sum(1)
      my_s = np.log1p(X[:, [gi[g] for g in _MYELOID_MARKERS
                            if g in gi]]).sum(1)
      cell_types = np.where(ly_s >= my_s, "ly", "my")
  else:
    X = data["X_filt"] if filtered_genes else data["X_full"]
    X_col = np.asarray(
        data["X_filt_col"] if filtered_genes else data["X_full_col"], str)
    cell_types = np.array([subset] * X.shape[0])
  X = np.asarray(X, np.float32)
  X, X_col = _drop_allzero_columns(X, X_col, verbose)
  y = np.asarray(data["y"], np.float32)
  y_col = np.asarray(data["y_col"], str)
  X_row = np.asarray(data["X_row"], str)
  if not X.shape[0] == y.shape[0] == len(X_row) == len(cell_types):
    raise ValueError(f"{path}: X {X.shape}, y {y.shape}, {len(X_row)} rows "
                     f"and {len(cell_types)} cell types disagree")
  # sidecar BEFORE save_to_dataset so the manifest md5 covers it
  os.makedirs(cache, exist_ok=True)
  np.savez_compressed(os.path.join(cache, "cell_types.npz"), data=cell_types)
  save_to_dataset(cache, X, X_col, y=y, y_col=y_col, rowname=X_row,
                  print_log=verbose)
  return True


def _sco_from_author_cache(cache: str, name: str) -> SingleCellOMIC:
  """Wrap a cache built from an author bundle: y is the real ADT table,
  the progenitor labels come from the cell_types sidecar (one-hot over
  ['myeloid', 'lymphoid'])."""
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name=name)
  sco.add_omic(OMIC.proteomic, np.asarray(y, np.float32),
               np.asarray(y_col, str))
  ct = np.asarray(np.load(os.path.join(cache, "cell_types.npz"))["data"],
                  str)
  prog = np.stack([ct == "my", ct == "ly"], 1).astype(np.float32)
  sco.add_omic(OMIC.progenitor, prog, np.array(["myeloid", "lymphoid"]))
  return sco


def read_PBMC8k(subset: str = "full",
                override: bool = False,
                verbose: bool = True,
                filtered_genes: bool = True) -> SingleCellOMIC:
  subset = str(subset).strip().lower()
  if subset not in ("full", "ly", "my"):
    raise ValueError(f"subset must be 'full'|'ly'|'my', given {subset}")
  cache = os.path.join(
      DATA_DIR,
      f"pbmc8k_{subset}{'' if filtered_genes else 'all'}_preprocessed")
  if not validate_data_dir(cache) or override:
    if _fetch_author_bundle(_AUTHOR_BUNDLES, subset, filtered_genes, cache,
                            verbose):
      return _sco_from_author_cache(cache, f"pbmc8k_{subset}")
    base = read_dataset10x("pbmc8k", filtered_genes=filtered_genes,
                           override=override, verbose=verbose)
    X = base.numpy(OMIC.transcriptomic)
    genes = np.asarray(base.get_var_names(OMIC.transcriptomic), str)
    gene_idx = {g: i for i, g in enumerate(genes)}
    # lineage scores from marker sums (log space)
    ly = np.log1p(X[:, [gene_idx[g] for g in _LYMPHOID_MARKERS
                        if g in gene_idx]]).sum(1)
    my = np.log1p(X[:, [gene_idx[g] for g in _MYELOID_MARKERS
                        if g in gene_idx]]).sum(1)
    is_ly = ly >= my
    if subset == "ly":
      keep = np.nonzero(is_ly)[0]
    elif subset == "my":
      keep = np.nonzero(~is_ly)[0]
    else:
      keep = np.arange(X.shape[0])
    prog = np.stack([is_ly[keep], ~is_ly[keep]], 1).astype(np.float32)
    save_to_dataset(cache, X[keep], genes, y=prog,
                    y_col=np.array(["lymphoid", "myeloid"]),
                    rowname=np.asarray(base.obs_names, str)[keep],
                    print_log=verbose)
  if os.path.isfile(os.path.join(cache, "cell_types.npz")):
    return _sco_from_author_cache(cache, f"pbmc8k_{subset}")
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name=f"pbmc8k_{subset}")
  # proteomic omic: ADT table if pre-placed, else marker-gene surrogate
  adt_path = os.path.join(DATA_DIR, "pbmc8k_adt")
  if os.path.isdir(adt_path):
    adt, adt_col, _, _, _ = load_from_dataset(adt_path)
    sco.add_omic(OMIC.proteomic, adt, adt_col)
  else:
    genes = {g: i for i, g in enumerate(np.asarray(X_col, str))}
    prots = [(p, genes[g]) for p, g in MARKER_ADT_GENE.items() if g in genes]
    if prots:
      import scipy.sparse as sp
      Xd = np.asarray(X.todense()) if sp.issparse(X) else X
      surrogate = np.stack([Xd[:, i] for _, i in prots], 1)
      sco.add_omic(OMIC.proteomic, surrogate.astype(np.float32),
                   np.array([p for p, _ in prots]))
      sco.uns["proteomic_is_surrogate"] = True
  if y is not None:
    sco.add_omic(OMIC.progenitor, y, y_col)
  return sco
