"""Miscellaneous loaders: human embryos, centenarian, melanoma cisTopic,
SCALE ATAC sets, mouse ATAC atlas.

Port of ``sisua_tpu/data/loaders/misc.py``, without pandas. The parse and
preprocess pipelines:
  * ``read_human_embryos`` — E-MTAB-3929 processed zips → tab matrices
    (counts/rpkm/ercc) → gene filters (RPKM sum ≥ 10, ≥ 5 expressing cells,
    top-2000 HVG, selected on the host) → embryonic-day labels from the
    cell ids.
  * ``read_centenarian`` — RIKEN SC2018 gzipped TSV UMI matrix + barcode
    sample sheet → SC/CT one-hot labels.
  * ``read_scale_dataset`` — SCALE-paper zip of per-dataset npy/npz blobs
    (``<name>_x`` sparse matrix, ``_cell``/``_peak``/``_labels``).
  * ``read_mouse_ATLAS`` — Cusanovich 2018 sci-ATAC binary mtx + cell/peak
    id lists + metadata table (read as pandas reads it, labels included)
    → atac + celltype + tissue omics.

All cache through ``save_to_dataset`` folders under $SISUA_DATA.
``read_melanoma_cisTopicData`` reads a cache converted beforehand: the
source ships R ``.rds`` objects (GSE114557); ``tools/convert_rds.R`` and
``loaders/finalize_cache.py`` make the cache folder.
"""

from __future__ import annotations

import gzip
import os
import zipfile
from typing import Optional

import numpy as np
from scipy import sparse

from ..const import OMIC
from ..dataset import SingleCellOMIC
from ..path import DATA_DIR, DOWNLOAD_DIR
from ..utils import (download_file, load_from_dataset, read_compressed,
                     save_to_dataset, validate_data_dir)

__all__ = [
    "read_human_embryos", "read_centenarian", "read_melanoma_cisTopicData",
    "read_scale_dataset", "read_mouse_ATLAS",
]


def _one_hot(codes: np.ndarray, n: int) -> np.ndarray:
  return np.eye(n, dtype=np.float32)[np.asarray(codes, np.int64)]


def _from_cache(cache: str) -> Optional[tuple]:
  if os.path.isdir(cache) and validate_data_dir(cache):
    return load_from_dataset(cache)
  return None


# ---------------------------------------------------------------------------
# Human preimplantation embryos (Petropoulos 2016, E-MTAB-3929)
# ---------------------------------------------------------------------------
_EMBRYOS_URLS = [
    ("https://www.ebi.ac.uk/arrayexpress/files/E-MTAB-3929/"
     f"E-MTAB-3929.processed.{i}.zip") for i in (1, 2, 3, 4)
]


def _parse_tab_matrix(text: str):
  """E-MTAB-3929 layout: genes × cells tab table with gene rows and a cell
  header; returns (cells × genes sparse, cell_ids, gene_ids)."""
  rows = [ln.split("\t") for ln in text.split("\n") if ln]
  arr = np.asarray(rows).T  # → cells × genes with header row/col
  cell_id = arr[1:, 0]
  gene_id = arr[0, 1:]
  x = sparse.csr_matrix(arr[1:, 1:].astype(np.float32))
  return x, cell_id, gene_id


def read_human_embryos(filtered_genes: bool = True, override: bool = False,
                       verbose: bool = True) -> SingleCellOMIC:
  """Human preimplantation embryos: 1529 cells, counts + RPKM + ERCC omics,
  embryonic-day (E3–E7) one-hot labels."""
  tag = "" if filtered_genes else "all"
  cache = os.path.join(DATA_DIR, f"embryos{tag}_preprocessed")
  if override and os.path.isdir(cache):
    import shutil
    shutil.rmtree(cache)
  got = _from_cache(cache)
  if got is None:
    raw = _load_embryos_raw(verbose=verbose)
    counts, rpkm, ercc, cells, genes, ercc_ids = raw
    # gene filters from the published protocol: expressed (RPKM) mass and
    # a minimum number of expressing cells
    ids = np.asarray(rpkm.sum(axis=0) >= 10).ravel()
    counts, rpkm, genes = counts[:, ids], rpkm[:, ids], genes[ids]
    ids = np.asarray((counts > 0).sum(axis=0) >= 5).ravel()
    counts, rpkm, genes = counts[:, ids], rpkm[:, ids], genes[ids]
    if filtered_genes:
      sco = SingleCellOMIC(counts.copy(), cell_id=cells, gene_id=genes,
                           omic=OMIC.transcriptomic, name="embryos_tmp")
      # host preprocessing of a parsed table, as the rest of the parse
      sco.normalize(omic=OMIC.transcriptomic, log1p=True, device="cpu")
      sco.filter_highly_variable_genes(n_top_genes=min(2000,
                                                       counts.shape[1]),
                                       device="cpu")
      keep = np.isin(genes, np.asarray(sco.var_names))
      counts, rpkm, genes = counts[:, keep], rpkm[:, keep], genes[keep]
    # stack [counts | rpkm | ercc] column blocks into the cache matrix
    X = sparse.hstack([counts, rpkm, sparse.csr_matrix(ercc)]).tocsr()
    X_col = np.concatenate([
        genes, [f"rpkm:{g}" for g in genes], [f"ercc:{e}" for e in ercc_ids]])
    save_to_dataset(cache, X, X_col, rowname=cells, print_log=verbose)
    got = load_from_dataset(cache)
  X, X_col, cells, _, _ = got
  X = X.tocsr() if sparse.issparse(X) else X
  is_rpkm = np.char.startswith(X_col.astype(str), "rpkm:")
  is_ercc = np.char.startswith(X_col.astype(str), "ercc:")
  is_gene = ~(is_rpkm | is_ercc)
  genes = X_col[is_gene]
  sco = SingleCellOMIC(X[:, is_gene], cell_id=cells, gene_id=genes,
                       omic=OMIC.transcriptomic, name="embryos")
  sco.add_omic(OMIC.rpkm, X[:, is_rpkm].toarray(), genes)
  sco.add_omic(OMIC.ercc, X[:, is_ercc].toarray(),
               [c[5:] for c in X_col[is_ercc].astype(str)])
  # embryonic-day labels from cell ids 'E3.1.443' → 'E3' ('E7.4' folds to E7)
  days = [".".join(str(c).split(".")[:-2]) or str(c).split(".")[0]
          for c in cells]
  days = ["E7" if d == "E7.4" else d for d in days]
  names = sorted(set(days))
  codes = np.array([names.index(d) for d in days])
  sco.add_omic(OMIC.celltype, _one_hot(codes, len(names)), names)
  return sco


def _load_embryos_raw(verbose: bool = True):
  """Download + parse the 4 processed zips → (counts, rpkm, ercc, cells,
  genes, ercc_ids)."""
  dl = os.path.join(DOWNLOAD_DIR, "human_embryos")
  os.makedirs(dl, exist_ok=True)
  tables = {}
  for url in _EMBRYOS_URLS:
    path = download_file(url, os.path.join(dl, os.path.basename(url)))
    with zipfile.ZipFile(path) as z:
      for info in z.filelist:
        name = os.path.basename(info.filename)
        if not name:
          continue
        x, cells, cols = _parse_tab_matrix(str(z.read(info), "utf-8"))
        tables[name] = (x, cells, cols)
        if verbose:
          print(f"parsed {name}: {x.shape}")
  counts, cells, genes = tables["counts.txt"]
  rpkm = tables["rpkm.txt"][0]
  ercc, _, ercc_ids = tables["ercc.counts.txt"]
  return counts, rpkm, np.asarray(ercc.todense()), cells, genes, ercc_ids


# ---------------------------------------------------------------------------
# Supercentenarian blood (Hashimoto 2019, RIKEN SC2018)
# ---------------------------------------------------------------------------
_CENTENARIAN_URLS = {
    "umi": "http://gerg.gsc.riken.jp/SC2018/01.UMI.txt.gz",
    "barcodes": "http://gerg.gsc.riken.jp/SC2018/03.Cell.Barcodes.txt.gz",
}


def _read_gzip_tsv_matrix(path: str):
  """Gene-rows × cell-cols gzipped TSV with a cell-id header line →
  (cells × genes float32, cell_ids, gene_ids). Reference
  centenarian.py:59-71."""
  with gzip.open(path, "rt") as f:
    header = f.readline().strip().split("\t")
    gene_id, rows = [], []
    for line in f:
      parts = line.rstrip("\n").split("\t")
      if not parts or not parts[0]:
        continue
      gene_id.append(parts[0])
      rows.append(np.asarray(parts[1:], np.float32))
  X = np.stack(rows).T
  cell_id = np.asarray(header[-X.shape[0]:])
  return X, cell_id, np.asarray(gene_id)


def read_centenarian(override: bool = False, verbose: bool = True
                     ) -> SingleCellOMIC:
  """Supercentenarian blood single cells: raw UMI + SC/CT sample-type
  one-hot labels (disease omic = cohort)."""
  cache = os.path.join(DATA_DIR, "centenarian_preprocessed")
  if override and os.path.isdir(cache):
    import shutil
    shutil.rmtree(cache)
  got = _from_cache(cache)
  if got is None:
    dl = os.path.join(DOWNLOAD_DIR, "SuperCentenarian_original")
    os.makedirs(dl, exist_ok=True)
    bc_path = download_file(
        _CENTENARIAN_URLS["barcodes"],
        os.path.join(dl, os.path.basename(_CENTENARIAN_URLS["barcodes"])))
    rows = []
    with gzip.open(bc_path, "rt") as f:
      for line in f:
        parts = line.strip().split("\t")
        if len(parts) >= 3:
          if parts[1][:2] != parts[2]:
            raise ValueError(f"{bc_path}: sample {parts[1]} is not of "
                             f"type {parts[2]}")
          rows.append(parts)
    labels = np.asarray(rows)  # [barcode, sample_id, sample_type]
    umi_path = download_file(
        _CENTENARIAN_URLS["umi"],
        os.path.join(dl, os.path.basename(_CENTENARIAN_URLS["umi"])))
    X, cell_id, gene_id = _read_gzip_tsv_matrix(umi_path)
    if not np.array_equal(labels[:, 0], cell_id):
      raise ValueError("barcode sheet and UMI matrix disagree on cell ids")
    y_col = sorted(set(labels[:, 1]))
    y = _one_hot([y_col.index(i) for i in labels[:, 1]], len(y_col))
    save_to_dataset(cache, sparse.csr_matrix(X), gene_id, y=y, y_col=y_col,
                    rowname=cell_id, print_log=verbose)
    got = load_from_dataset(cache)
  X, gene_id, cell_id, y, y_col = got
  sco = SingleCellOMIC(X, cell_id=cell_id, gene_id=gene_id,
                       omic=OMIC.transcriptomic, name="centenarian")
  if y is not None:
    sco.add_omic(OMIC.disease, np.asarray(
        y.todense() if sparse.issparse(y) else y, np.float32), y_col)
  return sco


# ---------------------------------------------------------------------------
# SCALE-paper scATAC benchmark sets (Xiong 2019)
# ---------------------------------------------------------------------------
_SCALE_DATASETS = ("breast_tumor", "forebrain", "leukemia", "insilico",
                   "splenocyte")
_SCALE_URL = "https://ai-datasets.s3.amazonaws.com/scale_datasets.zip"


def read_scale_dataset(name: str = "forebrain", override: bool = False,
                       verbose: bool = True) -> SingleCellOMIC:
  """SCALE-paper scATAC benchmark sets (Xiong 2019): 'breast_tumor',
  'forebrain', 'leukemia', 'insilico', 'splenocyte'."""
  name = str(name).lower()
  if name not in _SCALE_DATASETS:
    raise ValueError(f"unknown SCALE dataset '{name}'; available: "
                     f"{_SCALE_DATASETS}")
  cache = os.path.join(DATA_DIR, f"scale_{name}_preprocessed")
  if override and os.path.isdir(cache):
    import shutil
    shutil.rmtree(cache)
  got = _from_cache(cache)
  if got is None:
    dl = os.path.join(DOWNLOAD_DIR, "scale_dataset")
    os.makedirs(dl, exist_ok=True)
    path = download_file(_SCALE_URL, os.path.join(dl, "scale_datasets.zip"))
    extract = os.path.join(dl, "extracted")
    if not os.path.isdir(extract) or not os.listdir(extract):
      read_compressed(path, extract)
    # the zip may nest a folder — index extracted files by basename
    blobs = {}
    for root, _, names in os.walk(extract):
      for n in names:
        blobs[n] = os.path.join(root, n)
    x = sparse.load_npz(blobs[f"{name}_x"]).tocsr()
    cell = np.load(blobs[f"{name}_cell"], allow_pickle=True)
    peak = np.load(blobs[f"{name}_peak"], allow_pickle=True)
    labels = np.load(blobs[f"{name}_labels"], allow_pickle=True)
    ids = sorted(set(labels))
    y = _one_hot([ids.index(i) for i in labels], len(ids))
    save_to_dataset(cache, x, peak, y=y, y_col=ids, rowname=cell,
                    print_log=verbose)
    got = load_from_dataset(cache)
  X, peak, cell, y, y_col = got
  sco = SingleCellOMIC(X, cell_id=cell, gene_id=peak, omic=OMIC.atac,
                       name=f"scale_{name}")
  if y is not None:
    sco.add_omic(OMIC.celltype, np.asarray(
        y.todense() if sparse.issparse(y) else y, np.float32), y_col)
  return sco


# ---------------------------------------------------------------------------
# Mouse sci-ATAC atlas (Cusanovich 2018)
# ---------------------------------------------------------------------------
def _pandas_strings(values):
  """``str`` of each value of one column as ``pandas.read_csv`` types it:
  NA strings are NaN ('nan'); a column of integers is int64 ('3'), or
  float64 ('3.0') when it holds a NaN; a column of numbers float64
  ('0.5'); 'True'/'False' alone bool; else the strings as they are."""
  from ..utils import _NA_STRINGS
  na = [v in _NA_STRINGS for v in values]
  rest = [v for v, n in zip(values, na) if not n]
  if not rest:
    return ["nan"] * len(values)

  def _all(cast):
    try:
      return [cast(v) for v in rest]
    except ValueError:
      return None
  ints = _all(int)
  if ints is not None and not any(na):
    return [str(int(v)) for v in values]
  floats = ints if ints is not None else _all(float)
  if floats is not None:
    return ["nan" if n else str(float(v)) for v, n in zip(values, na)]
  if not any(na) and set(rest) <= {"True", "False", "TRUE", "FALSE",
                                   "true", "false"}:
    return [str(v.lower() == "true") for v in values]
  return ["nan" if n else v for v, n in zip(values, na)]


def _read_tsv_labels(path: str):
  """{column: label strings} of a tab-separated table with a header row,
  as ``str`` of each value of ``pandas.read_csv(path, sep='\\t')``."""
  import csv
  with open(path, newline="") as f:
    rows = [r for r in csv.reader(f, delimiter="\t") if r]
  header, body = rows[0], rows[1:]
  for lineno, r in enumerate(body, start=2):
    if len(r) != len(header):
      raise ValueError(f"{path}:{lineno}: {len(r)} fields, the header has "
                       f"{len(header)}")
  from ..utils import dedup_names
  return {name: _pandas_strings([r[j] for r in body])
          for j, name in enumerate(dedup_names(header))}


_ATLAS_BASE = ("http://krishna.gs.washington.edu/content/members/ajh24/"
               "mouse_atlas_data_release")
_ATLAS_URLS = {
    "counts": f"{_ATLAS_BASE}/matrices/"
              "atac_matrix.binary.qc_filtered.mtx.gz",
    "cellids": f"{_ATLAS_BASE}/matrices/"
               "atac_matrix.binary.qc_filtered.cells.txt",
    "peakids": f"{_ATLAS_BASE}/matrices/"
               "atac_matrix.binary.qc_filtered.peaks.txt",
    "metadata": f"{_ATLAS_BASE}/metadata/cell_metadata.txt",
}


def read_mouse_ATLAS(filtered_genes: bool = True, override: bool = False,
                     verbose: bool = True) -> SingleCellOMIC:
  """Mouse sci-ATAC atlas (~100k cells, 13 tissues): binary peak matrix +
  celltype + tissue one-hot omics."""
  cache = os.path.join(DATA_DIR, "mouse_atlas_preprocessed")
  if override and os.path.isdir(cache):
    import shutil
    shutil.rmtree(cache)
  got = _from_cache(cache)
  if got is None:
    from scipy.io import mmread
    dl = os.path.join(DOWNLOAD_DIR, "mouse_atac")
    os.makedirs(dl, exist_ok=True)
    files = {k: download_file(url, os.path.join(dl, os.path.basename(url)))
             for k, url in _ATLAS_URLS.items()}
    counts = mmread(files["counts"]).astype(np.uint8)
    with open(files["cellids"]) as f:
      cell = np.asarray([i for i in f.read().split("\n") if i])
    with open(files["peakids"]) as f:
      peak = np.asarray([i for i in f.read().split("\n") if i])
    meta = _read_tsv_labels(files["metadata"])
    if len(meta["cell_label"]) != len(cell):
      raise ValueError(f"{files['metadata']}: {len(meta['cell_label'])} "
                       f"rows for {len(cell)} cells")
    celltype, tissue = meta["cell_label"], meta["tissue"]
    ct_ids = sorted(set(map(str, celltype)))
    ti_ids = sorted(set(map(str, tissue)))
    # encode celltype + tissue side by side in the y block
    y = np.concatenate([
        _one_hot([ct_ids.index(str(i)) for i in celltype], len(ct_ids)),
        _one_hot([ti_ids.index(str(i)) for i in tissue], len(ti_ids))], 1)
    y_col = [f"ct:{c}" for c in ct_ids] + [f"ti:{t}" for t in ti_ids]
    # matrix ships peaks × cells — transpose to cells × peaks
    save_to_dataset(cache, counts.T.tocsr(), peak, y=y, y_col=y_col,
                    rowname=cell, print_log=verbose)
    got = load_from_dataset(cache)
  X, peak, cell, y, y_col = got
  sco = SingleCellOMIC(X, cell_id=cell, gene_id=peak, omic=OMIC.atac,
                       name="mouse_atlas")
  if y is not None:
    y = np.asarray(y.todense() if sparse.issparse(y) else y, np.float32)
    y_col = y_col.astype(str)
    is_ct = np.char.startswith(y_col, "ct:")
    sco.add_omic(OMIC.celltype, y[:, is_ct],
                 [c[3:] for c in y_col[is_ct]])
    sco.add_omic(OMIC.tissue, y[:, ~is_ct],
                 [t[3:] for t in y_col[~is_ct]])
  return sco


# ---------------------------------------------------------------------------
# Melanoma cisTopic (R-gated: source ships .rds objects)
# ---------------------------------------------------------------------------
def read_melanoma_cisTopicData(filtered_genes: bool = True,
                               override: bool = False,
                               verbose: bool = True) -> SingleCellOMIC:
  """Melanoma scATAC from the cisTopic study (Bravo González-Blas 2019).

  The upstream distribution is an R ``.rds`` matrix (GSE114557); this image
  needs R to convert, so the loader reads a converted cache. Make it with
  ``Rscript tools/convert_rds.R <counts.rds> <out_dir>`` and place ``out_dir``
  at ``$SISUA_DATA/melanoma_atac_preprocessed``."""
  tag = "" if filtered_genes else "all"
  cache = os.path.join(DATA_DIR, f"melanoma_atac{tag}_preprocessed")
  got = _from_cache(cache)
  if got is None:
    raise RuntimeError(
        f"Dataset 'melanoma_atac' requires a pre-converted cache at {cache} "
        "(source GSE114557 ships R .rds objects; this environment has no R)."
        " Convert with: Rscript tools/convert_rds.R counts.rds "
        f"{cache}")
  X, X_col, X_row, y, y_col = got
  sco = SingleCellOMIC(X, cell_id=X_row, gene_id=X_col, omic=OMIC.atac,
                       name="melanoma_atac")
  if y is not None:
    sco.add_omic(OMIC.celltype, np.asarray(
        y.todense() if sparse.issparse(y) else y, np.float32), y_col)
  return sco
