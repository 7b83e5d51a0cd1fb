"""Leukemia datasets: MPAL (Granja 2019) and childhood ALL (GSE132509)
(port of ``sisua_tpu/data/loaders/leukemia.py``): RNA + ADT (or ATAC)
matrices with disease labels. MPAL's upstream files are R ``.rds``
objects: the loader reads a cache converted beforehand
(``tools/convert_rds.R``, then ``loaders/finalize_cache.py``). Childhood
ALL is parsed from GEO's tar of per-sample 10x triplets.
"""

from __future__ import annotations

import os

import numpy as np

from ..const import OMIC
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR, DOWNLOAD_DIR
from ..utils import (download_file, load_from_dataset, save_to_dataset,
                     validate_data_dir)

__all__ = ["read_leukemia_MixedPhenotypes", "read_leukemia_BMMC"]

_MPAL_BASE = ("https://jeffgranja.s3.amazonaws.com/MPAL-10x/Supplementary_Data"
              "/Healthy_Data/")
_MPAL_FILES = {
    "rna": "scRNA-Healthy-Hematopoiesis-191120.rds",
    "adt": "scADT-Healthy-Hematopoiesis-191120.rds",
    "atac": "scATAC-Healthy-Hematopoiesis-191120.rds",
}


def read_leukemia_MixedPhenotypes(filtered_genes: bool = True,
                                  omic: str = "rna",
                                  override: bool = False,
                                  verbose: bool = True) -> SingleCellOMIC:
  """MPAL healthy hematopoiesis: 'rna' → RNA+ADT, 'atac' → ATAC peaks."""
  omic = str(omic).lower()
  if omic not in ("rna", "atac"):
    raise ValueError(f"omic must be 'rna' or 'atac', given {omic}")
  cache = os.path.join(
      DATA_DIR, f"mpal_{omic}{'' if filtered_genes else 'all'}_preprocessed")
  if not validate_data_dir(cache) or override:
    # The upstream supplement ships R .rds SummarizedExperiment objects;
    # converting needs R. Accept a placed cache or a converted npz folder.
    needed = [_MPAL_BASE + _MPAL_FILES[k]
              for k in (("rna", "adt") if omic == "rna" else ("atac",))]
    raise RuntimeError(
        f"MPAL '{omic}' requires a pre-placed cache at {cache}. Upstream "
        f"files ({needed}) are .rds archives needing R for conversion; "
        "convert with tools/convert_rds.R (X, X_col, y, y_col npz folder).")
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  main = OMIC.atac if omic == "atac" else OMIC.transcriptomic
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col, omic=main,
                       name=f"mpal_{omic}")
  if y is not None:
    sco.add_omic(OMIC.proteomic if omic == "rna" else OMIC.celltype, y, y_col)
  return sco


_CALL_GEO = ("https://www.ncbi.nlm.nih.gov/geo/download/"
             "?acc=GSE132509&format=file")


def read_leukemia_BMMC(filtered_genes: bool = True,
                       override: bool = False,
                       verbose: bool = True) -> SingleCellOMIC:
  """Childhood ALL (GSE132509): bone-marrow mononuclear cells, disease
  labels from the sample sheet."""
  cache = os.path.join(
      DATA_DIR, f"call{'' if filtered_genes else 'all'}_preprocessed")
  if not validate_data_dir(cache) or override:
    tar_path = os.path.join(DOWNLOAD_DIR, "GSE132509_RAW.tar")
    download_file(_CALL_GEO, tar_path)
    import tarfile
    from scipy import io as sp_io
    from scipy import sparse
    ex_dir = os.path.join(DOWNLOAD_DIR, "GSE132509")
    os.makedirs(ex_dir, exist_ok=True)
    with tarfile.open(tar_path) as t:
      t.extractall(ex_dir, filter="data")
    # per-sample 10x triplets named GSM*_<sample>.<kind>.gz
    mats, labels, cells, genes = [], [], [], None
    samples = sorted({f.split(".")[0] for f in os.listdir(ex_dir)})
    for s in samples:
      mtx = os.path.join(ex_dir, f"{s}.matrix.mtx.gz")
      if not os.path.isfile(mtx):
        continue
      import gzip
      X = sp_io.mmread(mtx).T.tocsr().astype(np.float32)
      with gzip.open(os.path.join(ex_dir, f"{s}.genes.tsv.gz"), "rt") as f:
        g = np.asarray([l.split("\t")[1].strip() for l in f], str)
      with gzip.open(os.path.join(ex_dir, f"{s}.barcodes.tsv.gz"), "rt") as f:
        b = [f"{s}_{l.strip()}" for l in f]
      if genes is None:
        genes = g
      elif len(g) != len(genes) or not np.array_equal(g, genes):
        # per-sample triplets may ship different references/orderings —
        # align this sample's columns to the first sample's gene list
        # rather than silently vstack-ing misaligned matrices
        idx = {name: j for j, name in enumerate(g)}
        cols = np.asarray([idx.get(name, -1) for name in genes])
        aligned = sparse.lil_matrix((X.shape[0], len(genes)),
                                    dtype=np.float32)
        present = cols >= 0
        aligned[:, np.flatnonzero(present)] = X[:, cols[present]]
        X = aligned.tocsr()
      mats.append(X)
      cells.extend(b)
      disease = "ETV6-RUNX1" if "ETV6" in s else (
          "HHD" if "HHD" in s else ("PRE-T" if "PRE-T" in s else "healthy"))
      labels.extend([disease] * X.shape[0])
    X = sparse.vstack(mats).tocsr()
    classes, yi = np.unique(labels, return_inverse=True)
    Y = np.eye(len(classes), dtype=np.float32)[yi]
    if filtered_genes:
      keep = np.asarray((X > 0).sum(0)).ravel() >= max(
          1, int(0.005 * X.shape[0]))
      X, genes = X[:, keep], genes[keep]
    save_to_dataset(cache, X, genes, y=Y, y_col=classes, rowname=cells,
                    print_log=verbose)
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name="call")
  sco.add_omic(OMIC.disease, y, y_col)
  return sco
