"""CITE-seq PBMC / CBMC loaders (GSE100866, Stoeckius et al. 2017; port of
``sisua_tpu/data/loaders/citeseq.py``): the paired RNA + ADT count
matrices of the original CITE-seq study, as GEO ships them (CSV, genes ×
cells), read without pandas, kept to the human cells (the study spikes in
mouse cells), cached as (X = RNA, y = ADT).
"""

from __future__ import annotations

import os

import numpy as np
from scipy import sparse

from ..const import OMIC
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR, DOWNLOAD_DIR
from ..utils import (download_file, load_from_dataset, read_csv_table,
                     save_to_dataset, standardize_protein_name,
                     validate_data_dir)

__all__ = ["read_CITEseq_PBMC", "read_CITEseq_CBMC"]

_GEO = "https://www.ncbi.nlm.nih.gov/geo/download/?acc=GSE100866&format=file&file="
_FILES = {
    "cbmc": {
        "rna": "GSE100866%5FCBMC%5F8K%5F13AB%5F10X%2DRNA%5Fumi%2Ecsv%2Egz",
        "adt": "GSE100866%5FCBMC%5F8K%5F13AB%5F10X%2DADT%5Fumi%2Ecsv%2Egz",
    },
    "pbmc": {
        "rna": "GSE100866%5FPBMC%5Fvs%5Fflow%5F10X%2DRNA%5Fumi%2Ecsv%2Egz",
        "adt": "GSE100866%5FPBMC%5Fvs%5Fflow%5F10X%2DADT%5Fumi%2Ecsv%2Egz",
    },
}


def _load_citeseq(which: str, filtered_genes: bool, override: bool,
                  verbose: bool) -> SingleCellOMIC:
  cache = os.path.join(
      DATA_DIR,
      f"{which}_citeseq{'' if filtered_genes else 'all'}_preprocessed")
  if not validate_data_dir(cache) or override:
    files = {}
    for kind, fname in _FILES[which].items():
      out = os.path.join(DOWNLOAD_DIR, f"{which}_{kind}.csv.gz")
      download_file(_GEO + fname, out)
      files[kind] = out
    # genes × cells and proteins × cells, in float64: the integer counts
    # exactly, so the sums and their ratio below are pandas' int64 ones
    rna, genes, cells = read_csv_table(files["rna"])
    adt, prots, adt_cells = read_csv_table(files["adt"])
    # keep human cells: the study prefixes genes HUMAN_/MOUSE_
    human = np.asarray([g.startswith("HUMAN_") for g in genes], bool)
    if human.any():
      with np.errstate(divide="ignore", invalid="ignore"):
        keep_cells = rna[human].sum(axis=0) / rna.sum(axis=0) > 0.9
      # the ADT columns are picked by cell name, as pandas aligns them
      kept = dict(zip(cells, keep_cells))
      missing = [c for c in adt_cells if c not in kept]
      if missing:
        raise ValueError(f"{files['adt']}: cells {missing[:5]} are not in "
                         f"{files['rna']}")
      adt_keep = np.asarray([kept[c] for c in adt_cells], bool)
      rna, cells = rna[human][:, keep_cells], cells[keep_cells]
      adt = adt[:, adt_keep]
      genes = np.asarray([g[len("HUMAN_"):] for g in genes[human]], str)
    X = rna.T.astype(np.float32)  # cells × genes
    Y = adt.T.astype(np.float32)
    prot_names = np.asarray(standardize_protein_name(list(prots)), str)
    if filtered_genes:  # drop near-silent genes
      keep = (X > 0).sum(0) >= max(1, int(0.01 * X.shape[0]))
      X, genes = X[:, keep], genes[keep]
    save_to_dataset(cache, sparse.csr_matrix(X), genes, y=Y,
                    y_col=prot_names, rowname=cells, print_log=verbose)
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name=f"{which}_citeseq")
  sco.add_omic(OMIC.proteomic, y, y_col)
  return sco


def read_CITEseq_PBMC(override: bool = False, verbose: bool = True,
                      filtered_genes: bool = True) -> SingleCellOMIC:
  return _load_citeseq("pbmc", filtered_genes, override, verbose)


def read_CITEseq_CBMC(override: bool = False, verbose: bool = True,
                      filtered_genes: bool = True) -> SingleCellOMIC:
  return _load_citeseq("cbmc", filtered_genes, override, verbose)
