"""The 10x Genomics readers (port of ``sisua_tpu/data/loaders/tenx.py``).

``read_dataset10x`` loads a dataset of the public 10x catalog (cell-exp,
cell-vdj and cell-atac releases) by name: the archive placed (or
downloaded) under DOWNLOAD_DIR is extracted and its matrix-market
triplet (``matrix.mtx``, barcodes, features or genes) parsed into a CSR,
cached under DATA_DIR in the JAX package's format, and wrapped as a
``SingleCellOMIC``; the registry's aliases ('4k', '5k', '10k', '18k',
'neuron10k', 'heart10k', 'vdj1'-'vdj4', …) name them. ``read_10x_mtx``
reads a CellRanger matrix directory and ``read_10x_h5`` a CellRanger
``.h5`` file (h5py, imported there) directly, with no cache. CITE-seq
matrices split their 'Antibody Capture' features into the proteomic
omic; peaks make the atac omic. The counts stay sparse until the
protein columns are cut out.
"""

from __future__ import annotations

import gzip
import os
import tarfile
from typing import Optional

import numpy as np
from scipy import io as sp_io
from scipy import sparse

from ..const import OMIC
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR, DOWNLOAD_DIR
from ..utils import (download_file, load_from_dataset, save_to_dataset,
                     validate_data_dir)

__all__ = ["read_dataset10x", "read_10x_mtx", "read_10x_h5", "TENX_CATALOG"]

_BASE = "http://cf.10xgenomics.com/samples"

# name → (release kind, version, 10x sample id)
TENX_CATALOG = {
    # cell-exp
    "pbmc4k": ("cell-exp", "2.1.0", "pbmc4k"),
    "pbmc8k": ("cell-exp", "2.1.0", "pbmc8k"),
    "pbmc_10k_protein_v3": ("cell-exp", "3.0.0", "pbmc_10k_protein_v3"),
    "5k_pbmc_protein_v3": ("cell-exp", "3.0.0", "5k_pbmc_protein_v3"),
    "pbmc_1k_protein_v3": ("cell-exp", "3.0.0", "pbmc_1k_protein_v3"),
    "malt_10k_protein_v3": ("cell-exp", "3.0.0", "malt_10k_protein_v3"),
    "neuron_10k_v3": ("cell-exp", "3.0.0", "neuron_10k_v3"),
    "heart_10k_v3": ("cell-exp", "3.0.0", "heart_10k_v3"),
    "neurons_900": ("cell-exp", "2.1.0", "neurons_900"),
    "pbmc33k": ("cell-exp", "1.1.0", "pbmc33k"),
    "pbmc3k": ("cell-exp", "1.1.0", "pbmc3k"),
    "pbmc6k": ("cell-exp", "1.1.0", "pbmc6k"),
    "pbmc68k": ("cell-exp", "1.1.0", "fresh_68k_pbmc_donor_a"),
    "t_3k": ("cell-exp", "2.1.0", "t_3k"),
    "t_4k": ("cell-exp", "2.1.0", "t_4k"),
    # the registry's '18k' is the pbmc8k run
    "18k": ("cell-exp", "2.1.0", "pbmc8k"),
    # cell-vdj (5' + feature barcode)
    "vdj_v1_hs_aggregated_donor1": ("cell-vdj", "3.1.0",
                                    "vdj_v1_hs_aggregated_donor1"),
    "vdj_v1_hs_aggregated_donor2": ("cell-vdj", "3.1.0",
                                    "vdj_v1_hs_aggregated_donor2"),
    "vdj_v1_hs_aggregated_donor3": ("cell-vdj", "3.1.0",
                                    "vdj_v1_hs_aggregated_donor3"),
    "vdj_v1_hs_aggregated_donor4": ("cell-vdj", "3.1.0",
                                    "vdj_v1_hs_aggregated_donor4"),
    # cell-atac
    "atac_v1_pbmc_5k": ("cell-atac", "1.1.0", "atac_v1_pbmc_5k"),
    "atac_v1_pbmc_10k": ("cell-atac", "1.1.0", "atac_v1_pbmc_10k"),
}


def _matrix_url(kind: str, version: str, sample: str, filtered: bool) -> str:
  tag = "filtered" if filtered else "raw"
  if kind == "cell-atac":
    fname = f"{sample}_{tag}_peak_bc_matrix.tar.gz"
  elif version.startswith("3"):  # v3 chemistry: *_feature_bc_matrix
    fname = f"{sample}_{tag}_feature_bc_matrix.tar.gz"
  else:  # v2: *_gene_bc_matrices
    fname = f"{sample}_{tag}_gene_bc_matrices.tar.gz"
  return f"{_BASE}/{kind}/{version}/{sample}/{fname}"


def _find(root: str, candidates) -> Optional[str]:
  for dirpath, _, files in os.walk(root):
    for f in files:
      if f in candidates:
        return os.path.join(dirpath, f)
  return None


def _read_text(path: str):
  op = gzip.open if path.endswith(".gz") else open
  with op(path, "rt") as f:
    return [line.rstrip("\n").split("\t") for line in f]


def _parse_10x_dir(dirpath: str, atac: bool = False):
  """Parse a CellRanger matrix directory (matrix.mtx[.gz], barcodes and
  features/genes/peaks) → (X CSR cells × features, cell ids, feature
  names, feature types)."""
  mtx = _find(dirpath, {"matrix.mtx", "matrix.mtx.gz"})
  barcodes = _find(dirpath, {"barcodes.tsv", "barcodes.tsv.gz"})
  feats = _find(dirpath, {"features.tsv", "features.tsv.gz",
                          "genes.tsv", "genes.tsv.gz",
                          "peaks.bed", "peaks.bed.gz"})
  if not (mtx and barcodes and feats):
    raise FileNotFoundError(
        f"Incomplete 10x matrix directory in {dirpath}: need "
        "matrix.mtx[.gz], barcodes.tsv[.gz] and features/genes.tsv[.gz] "
        "(or peaks.bed)")
  X = sp_io.mmread(mtx).T.tocsr().astype(np.float32)  # cells × features
  cell_ids = [r[0] for r in _read_text(barcodes)]
  feat_rows = _read_text(feats)
  if feats.endswith((".bed", ".bed.gz")) or (atac and len(feat_rows[0]) == 3
                                             and feat_rows[0][1].isdigit()):
    feat_names = [f"{r[0]}:{r[1]}:{r[2]}" for r in feat_rows]
    feat_types = ["Peaks"] * len(feat_names)
  else:
    feat_names = [r[1] if len(r) > 1 else r[0] for r in feat_rows]
    feat_types = [r[2] if len(r) > 2 else "Gene Expression"
                  for r in feat_rows]
  return X, cell_ids, np.asarray(feat_names), np.asarray(feat_types)


def _sco_from_parsed(X, cell_ids, feat_names, feat_types, name: str,
                     filtered_genes: bool = False) -> SingleCellOMIC:
  """The 'Antibody Capture' columns as the proteomic omic (dense), the
  rest as the main omic (Peaks → atac, else transcriptomic), without its
  all-zero features when ``filtered_genes``."""
  is_adt = feat_types == "Antibody Capture"
  is_peaks = (feat_types == "Peaks").all() if len(feat_types) else False
  X_main = X[:, ~is_adt] if is_adt.any() else X
  names_main = feat_names[~is_adt] if is_adt.any() else feat_names
  if filtered_genes:
    keep = np.asarray((X_main > 0).sum(0)).ravel() > 0
    X_main, names_main = X_main[:, keep], names_main[keep]
  sco = SingleCellOMIC(X_main, cell_id=cell_ids, gene_id=names_main,
                       omic=OMIC.atac if is_peaks else OMIC.transcriptomic,
                       name=name)
  if is_adt.any():
    adt = X[:, is_adt]
    adt = np.asarray(adt.todense() if sparse.issparse(adt) else adt,
                     np.float32)
    sco.add_omic(OMIC.proteomic, adt, feat_names[is_adt])
  return sco


def read_10x_mtx(path: str, name: Optional[str] = None,
                 filtered_genes: bool = False) -> SingleCellOMIC:
  """A CellRanger matrix directory (``matrix.mtx[.gz]``,
  ``barcodes.tsv[.gz]``, ``features/genes.tsv[.gz]`` or ``peaks.bed``) as
  a ``SingleCellOMIC``, read in place (no cache): CITE-seq features split
  into transcriptomic + proteomic omics, peaks make the atac omic;
  ``filtered_genes`` drops all-zero features."""
  path = os.path.abspath(os.path.expanduser(path))
  if not os.path.isdir(path):
    raise NotADirectoryError(f"Not a directory: {path}")
  X, cell_ids, feat_names, feat_types = _parse_10x_dir(path)
  return _sco_from_parsed(X, cell_ids, feat_names, feat_types,
                          name or os.path.basename(path.rstrip("/")),
                          filtered_genes)


def read_10x_h5(path: str, name: Optional[str] = None,
                filtered_genes: bool = False) -> SingleCellOMIC:
  """A CellRanger ``.h5`` feature-barcode matrix (the v3 ``/matrix``
  group, or the v2 layout of one group per genome) as a
  ``SingleCellOMIC``; needs h5py."""
  try:
    import h5py
  except ImportError as e:
    raise ImportError(f"{path}: reading a CellRanger .h5 file needs h5py "
                      "(pip install h5py)") from e
  path = os.path.abspath(os.path.expanduser(path))
  with h5py.File(path, "r") as f:
    if "matrix" in f:  # CellRanger v3+
      g = f["matrix"]
      feat_names = g["features/name"][:].astype(str)
      feat_types = (g["features/feature_type"][:].astype(str)
                    if "features/feature_type" in g
                    else np.asarray(["Gene Expression"] * len(feat_names)))
    else:  # v2: one group per genome
      genomes = list(f.keys())
      if not genomes:
        raise ValueError(f"Empty 10x h5 file: {path}")
      g = f[genomes[0]]
      feat_names = g["gene_names"][:].astype(str)
      feat_types = np.asarray(["Gene Expression"] * len(feat_names))
    n_feat, n_cells = (int(x) for x in g["shape"][:])
    X = sparse.csc_matrix(
        (g["data"][:].astype(np.float32), g["indices"][:], g["indptr"][:]),
        shape=(n_feat, n_cells)).T.tocsr()
    cell_ids = [b for b in g["barcodes"][:].astype(str)]
  return _sco_from_parsed(X, cell_ids, feat_names, np.asarray(feat_types),
                          name or os.path.splitext(os.path.basename(path))[0],
                          filtered_genes)


def read_dataset10x(name: str,
                    filtered_cells: bool = True,
                    filtered_genes: bool = True,
                    override: bool = False,
                    verbose: bool = True) -> SingleCellOMIC:
  """A 10x catalog dataset by name → ``SingleCellOMIC`` (transcriptomic
  or atac; CITE-seq matrices split into RNA + ADT omics). A valid cache
  is read as is; else the archive
  ``DOWNLOAD_DIR/<sample>_filtered_feature_bc_matrix.tar.gz`` (or its
  v2/ATAC/raw name) is downloaded unless placed, extracted once,
  parsed and cached."""
  if name not in TENX_CATALOG:
    raise KeyError(f"Unknown 10x dataset '{name}'; "
                   f"known: {sorted(TENX_CATALOG)}")
  kind, version, sample = TENX_CATALOG[name]
  cache = os.path.join(
      DATA_DIR, f"10x_{name}_{'filtered' if filtered_cells else 'raw'}"
      f"{'' if filtered_genes else 'all'}_preprocessed")
  if validate_data_dir(cache) and not override:
    return _from_cache(cache, name, kind)

  url = _matrix_url(kind, version, sample, filtered_cells)
  tar_path = os.path.join(DOWNLOAD_DIR, os.path.basename(url))
  download_file(url, tar_path)
  # a directory per variant (filtered and raw archives must not share),
  # and a marker written last, so a crash mid-extraction extracts again
  variant = "filtered" if filtered_cells else "raw"
  extract_dir = os.path.join(DOWNLOAD_DIR, f"10x_{name}_{variant}")
  done_marker = os.path.join(extract_dir, ".extracted")
  if not os.path.isfile(done_marker):
    os.makedirs(extract_dir, exist_ok=True)
    with tarfile.open(tar_path) as t:
      t.extractall(extract_dir, filter="data")
    with open(done_marker, "w") as f:
      f.write(os.path.basename(url))

  X, cell_ids, feat_names, feat_types = _parse_10x_dir(
      extract_dir, atac=(kind == "cell-atac"))
  is_adt = feat_types == "Antibody Capture"
  X_main = X[:, ~is_adt] if is_adt.any() else X
  names_main = feat_names[~is_adt] if is_adt.any() else feat_names
  if filtered_genes:  # drop all-zero features
    keep = np.asarray((X_main > 0).sum(0)).ravel() > 0
    X_main, names_main = X_main[:, keep], names_main[keep]
  y = y_col = None
  if is_adt.any():
    y = np.asarray(X[:, is_adt].todense(), np.float32)
    y_col = feat_names[is_adt]
  save_to_dataset(cache, X_main, names_main, y=y, y_col=y_col,
                  rowname=cell_ids, print_log=verbose)
  return _from_cache(cache, name, kind)


def _from_cache(cache: str, name: str, kind: str) -> SingleCellOMIC:
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  omic = OMIC.atac if kind == "cell-atac" else OMIC.transcriptomic
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col, omic=omic,
                       name=f"10x_{name}")
  if y is not None:
    sco.add_omic(OMIC.proteomic, y, y_col)
  return sco
