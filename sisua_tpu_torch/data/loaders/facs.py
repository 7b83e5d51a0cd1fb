"""FACS-sorted gene+protein datasets (2/5/7 proteins), GSE75478 (Velten
2017 bone-marrow HSCs).

Port of ``sisua_tpu/data/loaders/facs.py``:

  * ``read_FACS(2|5)`` — the author-bucket AES-encrypted zip (password
    'uef-czi') holding {X, X_row, X_col, y, y_row, y_col} as npz/csv blobs;
    decrypted with the WinZip-AES reader (``utils.unzip_aes``, whose AES
    block comes from ``cryptography``, imported when a member needs it),
    zero-count genes dropped, cached via ``save_to_dataset``.
  * ``read_full_FACS`` (= facs7) — the GEO GSE75478 pipeline: 2 individuals
    × (raw counts + FACS index CSVs), matched on shared cells/genes, the 7
    '_cd*' FACS channels selected, negative FACS intensities shifted to ≥0.
"""

from __future__ import annotations

import gzip
import os
from io import BytesIO, StringIO

import numpy as np

from ..const import OMIC
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR, DOWNLOAD_DIR
from ..utils import (download_file, load_from_dataset, save_to_dataset,
                     unzip_aes, validate_data_dir)

__all__ = ["read_FACS", "read_full_FACS"]

_BUCKET_URL = "https://s3.amazonaws.com/ai-datasets/KI_FACS_%dprotein.zip"
_PASSWORD = "uef-czi"

_GEO = ("https://www.ncbi.nlm.nih.gov/geo/download/?acc=GSE75478&format=file"
        "&file=GSE75478%5Ftranscriptomics%5F{kind}%5F{ind}%2Ecsv%2Egz")
_GEO_FILES = [
    (f"GSE75478_transcriptomics_{kind}_{ind}.csv.gz",
     _GEO.format(kind=kind.replace("_", "%5F"), ind=ind))
    for kind in ("facs_indeces_filtered", "raw_filtered")
    for ind in ("I1", "I2")
]


def _cache_to_sco(cache: str, name: str) -> SingleCellOMIC:
  X, X_col, X_row, y, y_col = load_from_dataset(cache)
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col,
                       omic=OMIC.transcriptomic, name=name)
  if y is not None:
    from scipy import sparse
    sco.add_omic(OMIC.proteomic, np.asarray(
        y.todense() if sparse.issparse(y) else y, np.float32), y_col)
  return sco


def read_FACS(n_protein: int = 5, override: bool = False,
              verbose: bool = True) -> SingleCellOMIC:
  """FACS 2/5-protein variants from the author bucket; 7 = full GEO panel."""
  n_protein = int(n_protein)
  if n_protein == 7:
    return read_full_FACS(override=override, verbose=verbose)
  if n_protein not in (2, 5):
    raise ValueError(f"n_protein must be 2, 5 or 7, given {n_protein}")
  cache = os.path.join(DATA_DIR, f"facs_{n_protein}_preprocessed")
  if override and os.path.isdir(cache):
    import shutil
    shutil.rmtree(cache)
  if not (os.path.isdir(cache) and validate_data_dir(cache)):
    from scipy import sparse
    dl = os.path.join(DOWNLOAD_DIR, "FACS_original")
    os.makedirs(dl, exist_ok=True)
    url = _BUCKET_URL % n_protein
    zip_path = download_file(url, os.path.join(dl, os.path.basename(url)))
    blobs = {}
    for member, data in unzip_aes(zip_path, password=_PASSWORD):
      base = os.path.splitext(os.path.basename(member))[0]
      if member.endswith(".npz"):
        blobs[base] = np.asarray(sparse.load_npz(BytesIO(data)).todense())
      elif member.endswith(".csv"):
        blobs[base] = np.loadtxt(StringIO(str(data, "utf-8")), dtype=str,
                                 delimiter=",")
      else:
        raise RuntimeError(f"Unknown member format: {member}")
    X = blobs["X"].astype(np.float32)
    X_row, X_col = blobs["X_row"], blobs["X_col"]
    y = blobs["y"].astype(np.float32)
    y_col = blobs["y_col"]
    if not np.all(X_row == blobs["y_row"]):
      raise ValueError("Cell order mismatch between gene and protein counts")
    keep = X.sum(0) > 0  # drop all-zero genes
    save_to_dataset(cache, sparse.csr_matrix(X[:, keep]), X_col[keep], y=y,
                    y_col=y_col, rowname=X_row, print_log=verbose)
  return _cache_to_sco(cache, f"facs_{n_protein}")


def _parse_geo_csv(path: str) -> np.ndarray:
  """GSE75478 CSVs ship genes × cells; transpose to cells × genes (with the
  header row and column travelling along)."""
  with gzip.open(path, "rb") as f:
    return np.array([str(line, "utf-8").strip().split(",")
                     for line in f]).T


def _match_rows(a: np.ndarray, b: np.ndarray):
  shared = set(a[1:, 0]) & set(b[1:, 0])
  a = a[[True] + [r in shared for r in a[1:, 0]], :]
  b = b[[True] + [r in shared for r in b[1:, 0]], :]
  if not np.array_equal(a[:, 0], b[:, 0]):
    raise ValueError("the cells of a transcriptome and its FACS table "
                     "are in different orders")
  return a, b


def read_full_FACS(override: bool = False, verbose: bool = True
                   ) -> SingleCellOMIC:
  """Full FACS data: 2 individuals, 7 protein markers (GSE75478)."""
  cache = os.path.join(DATA_DIR, "facs_7_preprocessed")
  if override and os.path.isdir(cache):
    import shutil
    shutil.rmtree(cache)
  if not (os.path.isdir(cache) and validate_data_dir(cache)):
    from scipy import sparse
    dl = os.path.join(DOWNLOAD_DIR, "FACS_full")
    os.makedirs(dl, exist_ok=True)
    tables = {}
    for name, url in _GEO_FILES:
      path = download_file(url, os.path.join(dl, name))
      tables[name.split(".")[0]] = _parse_geo_csv(path)
    i1 = tables["GSE75478_transcriptomics_raw_filtered_I1"]
    f1 = tables["GSE75478_transcriptomics_facs_indeces_filtered_I1"]
    i2 = tables["GSE75478_transcriptomics_raw_filtered_I2"]
    f2 = tables["GSE75478_transcriptomics_facs_indeces_filtered_I2"]
    # match duplicated cells within each individual, then shared genes and
    # '_cd*' FACS channels across individuals
    i1, f1 = _match_rows(i1, f1)
    i2, f2 = _match_rows(i2, f2)
    shared_genes = set(i1[0][1:]) & set(i2[0][1:])
    i1 = i1[:, [True] + [g in shared_genes for g in i1[0][1:]]]
    i2 = i2[:, [True] + [g in shared_genes for g in i2[0][1:]]]
    if not np.array_equal(i1[0], i2[0]):
      raise ValueError("the individuals' shared genes are in different "
                       "orders")
    gene = np.concatenate((i1, i2[1:]), axis=0)
    prot_name = sorted(c for c in set(f1[0][1:]) & set(f2[0][1:])
                       if "_cd" in c)
    f1 = f1[:, [0] + [f1[0].tolist().index(c) for c in prot_name]]
    f2 = f2[:, [0] + [f2[0].tolist().index(c) for c in prot_name]]
    if not np.array_equal(f1[0], f2[0]):
      raise ValueError("the individuals' FACS channels differ")
    prot = np.concatenate((f1, f2[1:]), axis=0)
    X = gene[1:, 1:].astype(np.float32)
    X_row = np.array([r.replace('"', "") for r in gene[1:, 0]])
    X_col = np.array([c.replace('"', "") for c in gene[0, 1:]])
    y = prot[1:, 1:].astype(np.float32)
    y_col = np.array([c.replace('"', "").split("_")[-1].upper()
                      for c in prot[0, 1:]])
    if not np.array_equal(prot[1:, 0], gene[1:, 0]):
      raise ValueError("cells of the FACS and gene tables differ")
    # FACS intensities can be negative — shift each channel to ≥ 0
    mins = np.minimum(y.min(0, keepdims=True), 0.0)
    y = y - mins
    keep = X.sum(0) > 0
    save_to_dataset(cache, sparse.csr_matrix(X[:, keep]), X_col[keep], y=y,
                    y_col=y_col, rowname=X_row, print_log=verbose)
  return _cache_to_sco(cache, "facs_7")
