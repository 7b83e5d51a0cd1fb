"""scVI-package datasets: cortex, pbmc, retina, hemato (port of
``sisua_tpu/data/loaders/scvi_datasets.py``): the four benchmark datasets
of Lopez et al. 2018 as SingleCellOMIC with one-hot celltype labels. The
cortex loader parses the Linnarsson lab's tab file itself; the other three
need the ``scvi-tools`` package (imported when a cache is to be built) or
a placed cache.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from scipy import sparse

from ..const import OMIC
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR, DOWNLOAD_DIR
from ..utils import (download_file, load_from_dataset, save_to_dataset,
                     validate_data_dir)

__all__ = ["read_Cortex", "read_PBMC", "read_Retina", "read_Hemato"]

_CORTEX_URL = ("https://storage.googleapis.com/linnarsson-lab-www-blobs/"
               "blobs/cortex/expression_mRNA_17-Aug-2014.txt")


def read_Cortex(override: bool = False, verbose: bool = True,
                n_top_genes: Optional[int] = 558) -> SingleCellOMIC:
  """Mouse cortex (Zeisel 2015): 3005 cells, top-558 HVGs, 7 cell types —
  a CPU-sized baseline."""
  cache = os.path.join(DATA_DIR, f"cortex_{n_top_genes or 'all'}_preprocessed")
  if not validate_data_dir(cache) or override:
    raw = os.path.join(DOWNLOAD_DIR, "cortex_expression_mRNA.txt")
    download_file(_CORTEX_URL, raw)
    # parse the Linnarsson tab file: 10 header rows; row 8 = 'group #'
    # (level1class), gene rows follow with [gene, cluster, values...]
    import csv
    rows = []
    with open(raw, newline="") as f:
      for r in csv.reader(f, delimiter="\t"):
        rows.append(r)
    labels = None
    header_n = 0
    for i, r in enumerate(rows[:12]):
      if len(r) > 1 and str(r[0]).strip().lower() in ("", "tissue", "group #",
                                                      "total mrna mol",
                                                      "well", "sex", "age",
                                                      "diameter", "cell_id",
                                                      "level1class",
                                                      "level2class"):
        header_n = i + 1
        if str(r[0]).strip().lower() in ("group #", "level1class"):
          labels = [str(v).strip() for v in r[2:]]
    if labels is None:
      raise ValueError(f"{raw}: could not locate the celltype header row")
    gene_names, data = [], []
    for r in rows[header_n:]:
      if len(r) < 3 or not r[0]:
        continue
      gene_names.append(r[0])
      data.append(np.asarray(r[2:], dtype=np.float32))
    X = np.stack(data, axis=1)  # cells × genes
    gene_names = np.asarray(gene_names, str)
    if n_top_genes is not None and n_top_genes < X.shape[1]:
      order = np.argsort(-X.var(0))[:n_top_genes]
      X, gene_names = X[:, order], gene_names[order]
    classes, y_idx = np.unique(labels, return_inverse=True)
    Y = np.eye(len(classes), dtype=np.float32)[y_idx]
    save_to_dataset(cache, sparse.csr_matrix(X), gene_names, y=Y,
                    y_col=classes, print_log=verbose)
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name="cortex")
  sco.add_omic(OMIC.celltype, y, y_col)
  return sco


def _from_scvi(name: str, loader: str, override: bool,
               verbose: bool) -> SingleCellOMIC:
  cache = os.path.join(DATA_DIR, f"{name}_preprocessed")
  if not validate_data_dir(cache) or override:
    try:
      import scvi  # optional dependency
    except ImportError as e:
      raise RuntimeError(
          f"Dataset '{name}' requires the scvi-tools package or a "
          f"pre-placed cache at {cache}") from e
    data = getattr(scvi.data, loader)(save_path=DOWNLOAD_DIR)
    X = data.X
    gene_names = np.asarray(data.var_names, str)
    labels = np.asarray(data.obs["cell_type"], str)
    classes, y_idx = np.unique(labels, return_inverse=True)
    Y = np.eye(len(classes), dtype=np.float32)[y_idx]
    save_to_dataset(cache, sparse.csr_matrix(X), gene_names, y=Y,
                    y_col=classes, print_log=verbose)
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name=name)
  sco.add_omic(OMIC.celltype, y, y_col)
  return sco


def read_PBMC(override: bool = False, verbose: bool = True) -> SingleCellOMIC:
  return _from_scvi("pbmcscvi", "pbmc_dataset", override, verbose)


def read_Retina(override: bool = False, verbose: bool = True) -> SingleCellOMIC:
  return _from_scvi("retina", "retina", override, verbose)


def read_Hemato(override: bool = False, verbose: bool = True) -> SingleCellOMIC:
  return _from_scvi("hemato", "hemato", override, verbose)
