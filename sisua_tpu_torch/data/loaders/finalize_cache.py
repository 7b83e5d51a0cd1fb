"""Finalize an R-converted cache folder (tools/convert_rds.R output) into
the ``save_to_dataset`` npz + MD5-manifest format every loader consumes.

  Rscript tools/convert_rds.R counts.rds /tmp/mpal [labels.rds]
  python -m sisua_tpu_torch.data.loaders.finalize_cache /tmp/mpal \
      [$SISUA_DATA/mpal_rna_preprocessed]

With one argument the folder is finalized in place (npz files written next
to the .mtx sources); with two, the finalized dataset lands at the second
path (e.g. directly into $SISUA_DATA)."""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy import io as sp_io
from scipy import sparse

from ..utils import save_to_dataset


def _lines(path):
  with open(path) as f:
    return np.asarray([ln.rstrip("\n") for ln in f if ln.strip()])


def finalize(src: str, dst: str | None = None) -> str:
  dst = dst or src
  X = sparse.csr_matrix(sp_io.mmread(os.path.join(src, "X.mtx")))
  X_col = _lines(os.path.join(src, "X_col.txt"))
  X_row = _lines(os.path.join(src, "X_row.txt"))
  y = y_col = None
  if os.path.isfile(os.path.join(src, "y.mtx")):
    y = np.asarray(sp_io.mmread(os.path.join(src, "y.mtx")).todense(),
                   dtype=np.float32)
    y_col = _lines(os.path.join(src, "y_col.txt"))
  return save_to_dataset(dst, X, X_col, y=y, y_col=y_col, rowname=X_row)


if __name__ == "__main__":
  if not 2 <= len(sys.argv) <= 3:
    sys.exit("usage: python -m sisua_tpu_torch.data.loaders.finalize_cache "
             "<converted_dir> [dest_dir]")
  print(finalize(*sys.argv[1:]))
