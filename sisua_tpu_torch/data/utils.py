"""Host data helpers (port of ``sisua_tpu/data/utils.py``), with no
pandas: ``get_library_size`` for numpy arrays, scipy sparse matrices and
torch tensors; ``apply_artificial_corruption``, the scVI count dropout
behind every imputation score, bitwise the JAX package's for the same
input and seed; ``standardize_protein_name``; ``read_csv_table`` and
``read_csv_matrix``, a CSV as ``pandas.read_csv(path, index_col=0)``
reads it; and the loaders' helpers: MD5 checksums, ``download_file``
(which returns at once when the file is in place), archives (WinZip-AES
members through ``cryptography``, imported when one is met), and the
dataset cache, a folder of npz files with a ``manifest.json`` holding
their MD5, in the JAX package's format: a cache either package writes is
a cache hit for the other."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tarfile
import urllib.request
import warnings
import zipfile
from typing import List, Optional, Sequence

import numpy as np
import torch
from scipy import sparse

__all__ = ["get_library_size", "int16_exact", "apply_artificial_corruption",
           "read_csv_matrix", "read_csv_table", "dedup_names",
           "standardize_protein_name", "download_file", "md5_checksum",
           "md5_folder", "read_compressed", "save_to_dataset",
           "load_from_dataset", "validate_data_dir", "validating_dataset",
           "unzip_aes", "remove_allzeros_columns", "get_gene_id2name",
           "read_r_matrix", "is_binary_dtype", "is_categorical_dtype"]

# rows per float64 row-sum pass over a tensor: at most 2^25 elements, so the
# float64 copy a pass makes stays ≤ 256 MiB whatever the matrix's size
_SUM_ELEMENTS = 1 << 25


def get_library_size(X, return_log_count: bool = False):
  """Per-cell library statistics in log space (scVI convention).

  Returns ``(local_mean, local_var)``, each (n_cells, 1) float32: the
  dataset-level mean and (population) variance of log total counts,
  broadcast per cell; with ``return_log_count``, ``(log_counts,
  local_mean, local_var)``, the per-cell log total counts first. A torch
  tensor stays on its device."""
  if X.ndim != 2:
    raise ValueError("Only support 2-D matrix")
  n = X.shape[0]
  if isinstance(X, torch.Tensor):
    step = max(1, _SUM_ELEMENTS // max(1, X.shape[1]))
    totals = torch.cat([X[i:i + step].sum(dim=1, dtype=torch.float64)
                        for i in range(0, n, step)])
    log_counts = torch.log(totals + 1e-8)
    mean = log_counts.mean().to(torch.float32)
    var = log_counts.var(correction=0).to(torch.float32)
    mean, var = mean.expand(n, 1).clone(), var.expand(n, 1).clone()
    if return_log_count:
      return log_counts[:, None].to(torch.float32), mean, var
    return mean, var
  total_counts = np.asarray(X.sum(axis=1)).ravel()
  if not np.all(total_counts >= 0):
    warnings.warn(f"Some cell in matrix {X.shape} contains negative counts; "
                  "this yields NaN log counts!")
  log_counts = np.log(total_counts + 1e-8)
  local_mean = np.full((n, 1), np.mean(log_counts), dtype=np.float32)
  local_var = np.full((n, 1), np.var(log_counts), dtype=np.float32)
  if return_log_count:
    return log_counts[:, None].astype(np.float32), local_mean, local_var
  return local_mean, local_var


def int16_exact(values) -> bool:
  """True when every value is an integer with |v| < 32767, the condition
  for an exact int16 upload (port of ``sisua_tpu/ops/sparse.py``
  ``int16_exact``): a full scan in chunks, never a sampled prefix. A torch
  tensor is scanned where it lies."""
  if isinstance(values, torch.Tensor):
    flat = values.reshape(-1)
    for lo in range(0, flat.numel(), 1 << 24):
      chunk = flat[lo:lo + (1 << 24)]
      if not chunk.is_floating_point():
        chunk = chunk.to(torch.float64)
      if not bool(((chunk == torch.round(chunk))
                   & (chunk < 32767) & (chunk > -32767)).all()):
        return False
    return True
  flat = np.asarray(values).reshape(-1)
  for lo in range(0, flat.size, 1 << 24):
    chunk = flat[lo:lo + (1 << 24)]
    # two-sided compare: abs() of the most negative integer overflows
    if (chunk.max() >= 32767 or chunk.min() <= -32767
        or np.any(chunk != np.round(chunk))):
      return False
  return True


def apply_artificial_corruption(x,
                                dropout: float = 0.0,
                                distribution: str = "binomial",
                                retain_rate: float = 0.2,
                                copy: bool = False,
                                seed: int = 8):
  """Corrupt ``dropout`` of the nonzero counts of ``x`` (n_cells, n_genes),
  a numpy array or scipy sparse matrix (scVI protocol): each picked count
  n becomes Binomial(n, retain_rate) ('binomial'), or n·Bernoulli(
  retain_rate) ('uniform'). numpy's ``RandomState(seed)`` draws in the JAX
  package's order (``choice`` over the nonzeros, then ``binomial``), so
  the result is bitwise its. A sparse result is CSR without explicit
  zeros."""
  distribution = str(distribution).lower()
  dropout = float(dropout)
  if not 0.0 <= dropout < 1.0:
    raise ValueError(f"dropout must be in [0, 1), given: {dropout}")
  rand = np.random.RandomState(seed=seed)
  if dropout <= 0.0:
    return x.copy() if copy else x
  corrupted_x = x.copy() if copy else x
  is_sparse = sparse.issparse(x)
  if is_sparse:
    xcoo = x.tocoo()
    i, j, vals = xcoo.row, xcoo.col, xcoo.data
  else:
    i, j = np.nonzero(x)
    vals = np.asarray(x[i, j]).ravel()
  n_pick = int(np.floor(dropout * len(i)))
  ix = rand.choice(len(i), size=n_pick, replace=False)
  i, j, vals = i[ix], j[ix], vals[ix]
  if distribution == "uniform":
    corrupted = vals * rand.binomial(n=np.ones(n_pick, np.int32),
                                     p=retain_rate)
  elif distribution == "binomial":
    corrupted = rand.binomial(n=vals.astype(np.int64), p=retain_rate)
  else:
    raise ValueError("Only support 'uniform' and 'binomial' corruption, "
                     f"given: '{distribution}'")
  if is_sparse:
    corrupted_x = corrupted_x.tolil()
    corrupted_x[i, j] = corrupted
    corrupted_x = corrupted_x.tocsr()
    corrupted_x.eliminate_zeros()
  else:
    corrupted_x[i, j] = corrupted
  return corrupted_x


_PROTEIN_ALIASES = {
    "PD-L1;CD274": "CD274", "PECAM;CD31": "CD31", "CD26;Adenosine": "CD26",
    "CD366;tim3": "CD366", "MHCII;HLA-DR": "MHCII",
    "IL7Ralpha;CD127": "CD127", "PD-1": "PD-1", "PD1": "PD1",
    "B220;CD45R": "CD45R", "Ox40;CD134": "CD134", "CD8a": "CD8",
    "CD8A": "CD8", "CD4 T cells": "CD4", "CD8 T cells": "CD8",
}


def standardize_protein_name(name):
  """Strip TotalSeq suffixes and map known aliases; a sequence gives a
  list."""
  if isinstance(name, (tuple, list, np.ndarray)):
    return [standardize_protein_name(i) for i in name]
  if not isinstance(name, str):
    raise TypeError("Protein name must be a string")
  for sep in ("-", "_"):
    for suffix in ("TotalSeqB", "control", "TotalSeqC", "TotalSeqA"):
      name = name.replace(f"{sep}{suffix}", "")
  name = name.strip()
  return _PROTEIN_ALIASES.get(name, name)


# the strings ``pandas.read_csv`` reads as NaN by default
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def dedup_names(names: Sequence[str]) -> List[str]:
  """Suffix repeated names '.1', '.2', … in order, as pandas does to a
  CSV's header and the JAX container to repeated var names."""
  names = list(names)
  counts: dict = {}
  for i, col in enumerate(names):
    cur = counts.get(col, 0)
    while cur > 0:
      counts[col] = cur + 1
      col = f"{col}.{cur}"
      cur = counts.get(col, 0)
    names[i] = col
    counts[col] = cur + 1
  return names


def read_csv_table(path: str, dtype=np.float64, delimiter: str = ","):
  """``(values, index, columns)`` of a table of numbers (``.gz`` or not)
  with a header row and an index column, as ``pandas.read_csv(path,
  index_col=0)`` reads it: the header names the columns (its first field
  names the index; repeated names get pandas' '.1', '.2' suffixes), every
  other row is a label then its numbers, and pandas' NA strings ('', 'NA',
  'nan', …) are NaN. ``values`` is (rows, columns) of ``dtype``; float64
  holds pandas' int64 columns exactly below 2^53, so their sums and
  ratios are pandas' too."""
  import csv
  import gzip
  opener = gzip.open if str(path).endswith(".gz") else open
  with opener(path, "rt", newline="") as f:
    rows = [r for r in csv.reader(f, delimiter=delimiter) if r]
  if not rows:
    raise ValueError(f"{path} is empty")
  width = len(rows[0])
  values, index = [], []
  for lineno, r in enumerate(rows[1:], start=2):
    if len(r) != width:
      raise ValueError(f"{path}:{lineno}: {len(r)} fields, the header has "
                       f"{width}")
    index.append(r[0])
    values.append([np.nan if v.strip() in _NA_STRINGS else float(v)
                   for v in r[1:]])
  values = np.asarray(values, np.float64).reshape(len(values), width - 1)
  return (values.astype(dtype, copy=False), np.asarray(index, str),
          np.asarray(dedup_names(rows[0][1:]), str))


def read_csv_matrix(path: str) -> np.ndarray:
  """The (rows, columns) float32 values of a CSV, as
  ``pandas.read_csv(path, index_col=0).to_numpy(np.float32)`` reads them
  (``read_csv_table``)."""
  return read_csv_table(path, np.float32)[0]


# ---------------------------------------------------------------------------
# Download and archives
# ---------------------------------------------------------------------------
def md5_checksum(path: str, chunk: int = 1 << 20) -> str:
  h = hashlib.md5()
  with open(path, "rb") as f:
    while True:
      b = f.read(chunk)
      if not b:
        break
      h.update(b)
  return h.hexdigest()


def md5_folder(path: str,
               exclude: Sequence[str] = ("manifest.json",)) -> str:
  """MD5 over the files of a folder in sorted order, for cache
  validation. ``manifest.json`` is left out by default: it stores this
  very hash."""
  h = hashlib.md5()
  for name in sorted(os.listdir(path)):
    if name in exclude:
      continue
    fp = os.path.join(path, name)
    if os.path.isfile(fp):
      with open(fp, "rb") as f:
        while True:
          b = f.read(1 << 20)
          if not b:
            break
          h.update(b)
  return h.hexdigest()


def download_file(url: str, outpath: str, md5: Optional[str] = None,
                  override: bool = False) -> str:
  """``outpath``, downloaded from ``url`` unless it is already there
  (with the right MD5 when one is given). A failed download raises a
  ``RuntimeError`` that names the file to place by hand."""
  if os.path.isfile(outpath) and not override:
    if md5 is None or md5_checksum(outpath) == md5:
      return outpath
    os.remove(outpath)
  os.makedirs(os.path.dirname(outpath) or ".", exist_ok=True)
  try:
    print(f"Downloading {url} -> {outpath}")
    urllib.request.urlretrieve(url, outpath)
  except Exception as e:  # noqa: BLE001 — map to an actionable message
    raise RuntimeError(
        f"Cannot download '{url}' (offline environment?). Place the file at "
        f"'{outpath}' manually, or use a synthetic dataset "
        f"(get_dataset('synthetic')).") from e
  if md5 is not None:
    got = md5_checksum(outpath)
    if got != md5:
      raise RuntimeError(f"MD5 mismatch for {outpath}: {got} != {md5}")
  return outpath


def _winzip_aes_keys(password: bytes, salt: bytes, strength: int):
  """WinZip AES key derivation: PBKDF2-HMAC-SHA1, 1000 iterations →
  (aes_key, hmac_key, password_verifier)."""
  key_len = {1: 16, 2: 24, 3: 32}[strength]
  dk = hashlib.pbkdf2_hmac("sha1", password, salt, 1000, 2 * key_len + 2)
  return dk[:key_len], dk[key_len:2 * key_len], dk[2 * key_len:]


def _winzip_aes_ctr(key: bytes, data: bytes) -> bytes:
  """WinZip AES-CTR keystream: a 16-byte little-endian counter from 1 (not
  the big-endian counter of standard AES-CTR), through ``cryptography``'s
  AES block."""
  from cryptography.hazmat.primitives.ciphers import (Cipher, algorithms,
                                                      modes)
  enc = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
  out = bytearray(len(data))
  for off in range(0, len(data), 16):
    counter = ((off >> 4) + 1).to_bytes(16, "little")
    ks = enc.update(counter)
    chunk = data[off:off + 16]
    out[off:off + len(chunk)] = bytes(a ^ b for a, b in zip(chunk, ks))
  return bytes(out)


def _raw_member_bytes(zf: zipfile.ZipFile, info: zipfile.ZipInfo) -> bytes:
  """A member's raw (compressed, encrypted) payload, read past its local
  file header: ``zipfile`` cannot decode compress_type 99 itself."""
  import struct
  fp = zf.fp
  fp.seek(info.header_offset)
  hdr = fp.read(30)
  magic, = struct.unpack_from("<I", hdr, 0)
  if magic != 0x04034b50:
    raise RuntimeError("corrupt local file header")
  name_len, extra_len = struct.unpack_from("<HH", hdr, 26)
  fp.seek(info.header_offset + 30 + name_len + extra_len)
  return fp.read(info.compress_size)


def unzip_aes(path: str, password: str):
  """Iterate (name, bytes) over a zip archive, WinZip-AES members (AE-1 or
  AE-2, compression type 99) included; plain and ZipCrypto members go
  through ``zipfile``."""
  import hmac as hmac_mod
  import struct
  import zlib
  pwd = password.encode() if isinstance(password, str) else password
  with zipfile.ZipFile(path) as zf:
    for info in zf.infolist():
      if info.is_dir():
        continue
      if info.compress_type != 99:
        yield info.filename, zf.read(info, pwd=pwd)
        continue
      # the 0x9901 extra field: vendor version, 'AE', strength, method
      extra, strength, method = info.extra, 3, zipfile.ZIP_DEFLATED
      off = 0
      while off + 4 <= len(extra):
        tag, size = struct.unpack_from("<HH", extra, off)
        if tag == 0x9901:
          _ver, _ae, strength, method = struct.unpack_from(
              "<H2sBH", extra, off + 4)
        off += 4 + size
      # payload: salt | 2-byte verifier | ciphertext | 10-byte mac
      raw = _raw_member_bytes(zf, info)
      salt_len = {1: 8, 2: 12, 3: 16}[strength]
      salt = raw[:salt_len]
      verifier = raw[salt_len:salt_len + 2]
      mac = raw[-10:]
      ct = raw[salt_len + 2:-10]
      aes_key, mac_key, pv = _winzip_aes_keys(pwd, salt, strength)
      if pv != verifier:
        raise RuntimeError(f"Bad password for member '{info.filename}'")
      if hmac_mod.new(mac_key, ct, hashlib.sha1).digest()[:10] != mac:
        raise RuntimeError(f"HMAC mismatch for member '{info.filename}'")
      data = _winzip_aes_ctr(aes_key, ct)
      if method == zipfile.ZIP_DEFLATED:
        data = zlib.decompress(data, -15)
      yield info.filename, data


def read_compressed(path: str, outdir: str) -> List[str]:
  """Extract a tar, zip or gz archive into ``outdir``; the extracted
  paths."""
  os.makedirs(outdir, exist_ok=True)
  if tarfile.is_tarfile(path):
    with tarfile.open(path) as t:
      t.extractall(outdir, filter="data")
      return [os.path.join(outdir, n) for n in t.getnames()]
  if zipfile.is_zipfile(path):
    with zipfile.ZipFile(path) as z:
      z.extractall(outdir)
      return [os.path.join(outdir, n) for n in z.namelist()]
  if path.endswith(".gz"):
    import gzip
    dst = os.path.join(outdir, os.path.basename(path)[:-3])
    with gzip.open(path, "rb") as fin, open(dst, "wb") as fout:
      shutil.copyfileobj(fin, fout)
    return [dst]
  raise ValueError(f"Unsupported archive: {path}")


def read_r_matrix(path: str):
  """An R ``dgCMatrix`` (as CSR) or matrix from an ``.rds`` file, through
  rpy2 and R, imported here; without them a ``RuntimeError`` says how to
  convert the file instead."""
  try:
    import rpy2.robjects as ro
    from rpy2.robjects import numpy2ri
  except ImportError as e:
    raise RuntimeError(
        "Reading .rds matrices requires rpy2 + R (not in this image). "
        "Convert the file to .mtx/.npz externally instead: in R, "
        "Matrix::writeMM(obj, 'out.mtx').") from e
  obj = ro.r["readRDS"](path)
  classes = list(ro.r["class"](obj))
  if "dgCMatrix" in classes:
    i = np.asarray(obj.slots["i"])
    p = np.asarray(obj.slots["p"])
    x = np.asarray(obj.slots["x"])
    dims = tuple(np.asarray(obj.slots["Dim"]))
    return sparse.csc_matrix((x, i, p), shape=dims).tocsr()
  with (ro.default_converter + numpy2ri.converter).context():
    return np.asarray(obj)


# ---------------------------------------------------------------------------
# The dataset cache: a folder of npz files and a JSON manifest with the MD5
# ---------------------------------------------------------------------------
def _save_matrix(path: str, m) -> None:
  if sparse.issparse(m):
    sparse.save_npz(path + ".sparse.npz", m.tocsr())
  else:
    np.savez_compressed(path + ".npz", data=np.asarray(m))


def _load_matrix(path: str, mmap: bool = False):
  if os.path.isfile(path + ".sparse.npz"):
    return sparse.load_npz(path + ".sparse.npz")
  if mmap and os.path.isfile(path + ".npy"):
    return np.load(path + ".npy", mmap_mode="r")
  return np.load(path + ".npz", allow_pickle=False)["data"]


def save_to_dataset(path: str,
                    X,
                    X_col: Sequence[str],
                    y=None,
                    y_col: Optional[Sequence[str]] = None,
                    rowname: Optional[Sequence[str]] = None,
                    print_log: bool = True) -> str:
  """Write an (X, y) dataset folder: ``X`` (CSR or dense), its column
  and row names, ``y`` and its column names, then ``manifest.json`` with
  the folder's MD5."""
  os.makedirs(path, exist_ok=True)
  if X.ndim != 2 or len(X_col) != X.shape[1]:
    raise ValueError(f"X {X.shape} with {len(X_col)} column names")
  _save_matrix(os.path.join(path, "X"), X)
  np.savez_compressed(os.path.join(path, "X_col.npz"),
                      data=np.asarray(X_col, dtype=str))
  if rowname is None:
    rowname = [f"Cell#{i}" for i in range(X.shape[0])]
  np.savez_compressed(os.path.join(path, "X_row.npz"),
                      data=np.asarray(rowname, dtype=str))
  if y is not None:
    if y_col is None or len(y_col) != y.shape[1] or y.shape[0] != X.shape[0]:
      raise ValueError(f"y {y.shape} with "
                       f"{None if y_col is None else len(y_col)} column "
                       f"names for X {X.shape}")
    _save_matrix(os.path.join(path, "y"), y)
    np.savez_compressed(os.path.join(path, "y_col.npz"),
                        data=np.asarray(y_col, dtype=str))
  with open(os.path.join(path, "manifest.json"), "w") as f:
    json.dump({"md5": md5_folder(path)}, f)
  if print_log:
    print(f"Saved dataset to {path} (X: {X.shape})")
  return path


def load_from_dataset(path: str):
  """The inverse of ``save_to_dataset``: ``(X, X_col, X_row, y, y_col)``,
  y and y_col None when the folder has none."""
  X = _load_matrix(os.path.join(path, "X"))
  X_col = np.load(os.path.join(path, "X_col.npz"))["data"]
  X_row = np.load(os.path.join(path, "X_row.npz"))["data"]
  y = y_col = None
  if (os.path.isfile(os.path.join(path, "y.npz"))
      or os.path.isfile(os.path.join(path, "y.sparse.npz"))):
    y = _load_matrix(os.path.join(path, "y"))
    y_col = np.load(os.path.join(path, "y_col.npz"))["data"]
  return X, X_col, X_row, y, y_col


def validating_dataset(path) -> None:
  """Assert that a dataset folder (or a dict of its arrays) carries X,
  X_col and X_row of matching sizes, and y with y_col as a pair."""
  if isinstance(path, dict):
    ds = dict(path)
  else:
    X, X_col, X_row, y, y_col = load_from_dataset(path)
    ds = {"X": X, "X_col": X_col, "X_row": X_row}
    if y is not None:
      ds["y"], ds["y_col"] = y, y_col
  def need(cond, msg):
    if not cond:  # AssertionError, as the JAX function raises, under -O too
      raise AssertionError(msg)
  for key in ("X", "X_col", "X_row"):
    need(ds.get(key) is not None, f"`{key}` must be stored at path: {path}")
  need(ds["X"].shape[1] == len(ds["X_col"]), "X_col mismatches X columns")
  need(ds["X"].shape[0] == len(ds["X_row"]), "X_row mismatches X rows")
  if ds.get("y") is not None:
    need(ds.get("y_col") is not None, f"`y_col` must pair `y` at: {path}")
    need(ds["y"].shape[0] == ds["X"].shape[0], "y rows mismatch X rows")
    need(ds["y"].shape[1] == len(ds["y_col"]), "y_col mismatches y columns")


def validate_data_dir(path: str) -> bool:
  """True when the folder's ``manifest.json`` holds its MD5."""
  mf = os.path.join(path, "manifest.json")
  if not os.path.isfile(mf):
    return False
  with open(mf) as f:
    expect = json.load(f).get("md5")
  return md5_folder(path) == expect


def remove_allzeros_columns(matrix, colname, print_log: bool = True):
  """Drop the columns whose total count is ≤ 1 from a matrix and its
  names (the floor keeps every kept gene after a train/test split)."""
  if matrix.ndim != 2:
    raise ValueError(f"expected a 2-D matrix, got {matrix.ndim}-D")
  orig_shape = matrix.shape
  colname = np.asarray(colname)
  nonzero_col = np.asarray(matrix.sum(axis=0)).ravel() > 1
  matrix = matrix[:, nonzero_col]
  colname = colname[nonzero_col]
  if print_log:
    print(f"Filtering {int(len(nonzero_col) - nonzero_col.sum())} all-zero "
          f"columns from data: {orig_shape} -> {matrix.shape} ...")
  return matrix, colname


def get_gene_id2name(cache_only: bool = False) -> dict:
  """Gene identifier (ENSG…) → gene symbol, from the id and symbol
  columns of every 10x ``features``/``genes`` table under DOWNLOAD_DIR,
  kept in ``DOWNLOAD_DIR/gene_id2name.pkl``."""
  import gzip
  import pickle
  from .path import DOWNLOAD_DIR
  cache = os.path.join(DOWNLOAD_DIR, "gene_id2name.pkl")
  if os.path.isfile(cache):
    with open(cache, "rb") as f:
      return pickle.load(f)
  mapping: dict = {}
  for root, _, files in os.walk(DOWNLOAD_DIR):
    for fn in files:
      base = fn.lower()
      if not (("features" in base or "genes" in base)
              and (base.endswith(".tsv") or base.endswith(".tsv.gz"))):
        continue
      fp = os.path.join(root, fn)
      opener = gzip.open if base.endswith(".gz") else open
      try:
        with opener(fp, "rt") as f:
          for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0] and parts[1]:
              mapping.setdefault(parts[0], parts[1])
      except (OSError, UnicodeDecodeError):
        continue
  if not mapping and cache_only:
    raise RuntimeError(
        f"No gene id→name table found under {DOWNLOAD_DIR}; download any "
        f"10x dataset first (e.g. get_dataset('pbmc8k'))")
  if mapping:
    with open(cache, "wb") as f:
      pickle.dump(mapping, f)
  return mapping


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------
def is_binary_dtype(x) -> bool:
  """True when every stored value is 0 or 1 (a full scan in chunks)."""
  if sparse.issparse(x):
    x = x.data
  flat = np.asarray(x).reshape(-1)
  for lo in range(0, flat.size, 16_777_216):
    chunk = flat[lo:lo + 16_777_216]
    if not np.all((chunk == 0) | (chunk == 1)):
      return False
  return True


def is_categorical_dtype(x) -> bool:
  """One-hot or probability-simplex rows (labels)."""
  x = np.asarray(x.todense()) if sparse.issparse(x) else np.asarray(x)
  if x.ndim != 2:
    return False
  return bool(np.allclose(x.sum(-1), 1.0, atol=1e-3))
