"""Export of an omic for analysis in R, without pandas (port of
``sisua_tpu/utils/io_utils.py``): a CSV in pandas' ``to_csv`` layout (a
header of the index name and the var names, then a row per cell: its id
and its values), or a feather file through pyarrow when it is installed.
``load_data_from_csv`` reads such a CSV back as ``{column: array}`` with
the row labels under ``'index'`` (the JAX function's DataFrame)."""

from __future__ import annotations

import csv
import gzip
import os
from typing import Dict, Optional

import numpy as np

__all__ = ["save_data", "save_data_to_csv", "save_data_to_R",
           "load_data_from_csv"]


def save_data(sco, outpath: str, omic=None) -> str:
  """Feather when pyarrow is importable, a gzipped CSV otherwise."""
  try:
    import pyarrow  # noqa: F401
  except ImportError:
    return save_data_to_csv(sco, outpath + ".csv.gz", omic=omic)
  return save_data_to_R(sco, outpath, omic=omic)


def _write_csv(path: str, header, labels, x: np.ndarray,
               compression: Optional[str]):
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  opener = gzip.open if compression == "gzip" else open
  with opener(path, "wt", newline="") as f:
    w = csv.writer(f, lineterminator="\n")
    w.writerow(header)
    for label, row in zip(labels, x):
      w.writerow([label] + [str(v) for v in row])


def save_data_to_csv(sco, outpath: str, omic=None,
                     compression: Optional[str] = "gzip") -> str:
  """The omic's matrix as a CSV: ``cell_id`` and the var names, then a
  row per cell (gzipped unless ``compression`` is None)."""
  _write_csv(outpath, ["cell_id"] + [str(v) for v in
                                     sco.get_var_names(omic)],
             sco.obs_names, sco.numpy(omic), compression)
  return outpath


def save_data_to_R(sco, outpath: str, omic=None) -> str:
  """A feather file (``arrow::read_feather`` in R) of ``cell_id`` and
  the omic's columns; without pyarrow, a gzipped CSV of the same columns
  at ``outpath + '.csv.gz'``."""
  os.makedirs(os.path.dirname(outpath) or ".", exist_ok=True)
  x = sco.numpy(omic)
  names = [str(v) for v in sco.get_var_names(omic)]
  try:
    import pyarrow as pa
    from pyarrow import feather
  except ImportError as e:
    alt = outpath + ".csv.gz"
    _write_csv(alt, ["cell_id"] + names, sco.obs_names, x, "gzip")
    print(f"[io] feather unavailable ({e}); wrote {alt}")
    return alt
  cols = {"cell_id": pa.array([str(c) for c in sco.obs_names])}
  cols.update({n: pa.array(x[:, i]) for i, n in enumerate(names)})
  feather.write_feather(pa.table(cols), outpath)
  return outpath


def load_data_from_csv(path: str) -> Dict[str, np.ndarray]:
  """A CSV with a header and an index column (``.csv`` or ``.csv.gz``):
  ``{'index': row labels, <column>: float64 values}`` (an empty field is
  NaN), as ``pandas.read_csv(path, index_col=0)`` reads numbers."""
  opener = gzip.open if str(path).endswith(".gz") else open
  with opener(path, "rt", newline="") as f:
    rows = [r for r in csv.reader(f) if r]
  if not rows:
    raise ValueError(f"{path} is empty")
  values = np.asarray([[float(v) if v.strip() else np.nan for v in r[1:]]
                       for r in rows[1:]], np.float64)
  values = values.reshape(len(rows) - 1, len(rows[0]) - 1)
  out: Dict[str, np.ndarray] = {"index": np.asarray([r[0] for r in rows[1:]],
                                                    str)}
  for i, name in enumerate(rows[0][1:]):
    out[name] = values[:, i]
  return out
