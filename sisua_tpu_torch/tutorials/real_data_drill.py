"""Real-data drill: the whole pipeline on YOUR data, one command per
stage (port of ``tutorials/real_data_drill.py``). Real data arrives as a
CellRanger directory (or the registry's raw files pre-placed under
$SISUA_DOWNLOAD) or as a ``.h5ad`` file:

    python -m sisua_tpu_torch.cli.train model.name=sisua \\
        dataset.name=/data/filtered_feature_bc_matrix train.epochs=200
    python -m sisua_tpu_torch.cli.evaluate -model sisua \\
        -ds /data/filtered_feature_bc_matrix -path /tmp/figs

(``dataset.name=/data/my_cite_seq.h5ad`` the same; ``.h5ad`` needs h5py.)
The evaluate step writes the scoreboard tables, the ResultsSheet scores
and, with ``--summary-plots``, the figures. This script runs both stages
on a synthetic CITE-seq stand-in written as a 10x directory
(``format='10x'``, the default) or as ``.h5ad`` (``format='h5ad'``), one
stage after the other in a process of their own, whose $SISUA_EXP is set
before its first import (the experiment store binds at import).

  python -m sisua_tpu_torch.tutorials.real_data_drill [--format h5ad]
  python -m sisua_tpu_torch.tutorials.real_data_drill --device cpu
"""

from __future__ import annotations

import gzip
import os
import subprocess
import sys

import numpy as np

from ._common import at_depth, device_of, out_dir_of, parser

EPOCHS = 10
FORMATS = ("10x", "h5ad")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def user_data():
  """Stand-in for YOUR data: a CITE-seq-style container."""
  from ..data import generate_citeseq
  return generate_citeseq(n_cells=2000, n_genes=300, n_proteins=8, seed=1)


def _write_10x(sco, path: str) -> str:
  """A CellRanger v3 ``filtered_feature_bc_matrix`` directory of the
  container's RNA ("Gene Expression") and proteins ("Antibody Capture"):
  ``matrix.mtx.gz`` (features × cells, integer counts),
  ``barcodes.tsv.gz`` and ``features.tsv.gz``."""
  from scipy import io as sp_io
  from scipy import sparse
  rna = sparse.csr_matrix(sco.get_omic("transcriptomic"))
  adt = sparse.csr_matrix(sco.get_omic("proteomic"))
  counts = sparse.hstack([rna, adt]).T.tocoo()
  os.makedirs(path)
  with gzip.open(os.path.join(path, "matrix.mtx.gz"), "wb") as f:
    sp_io.mmwrite(f, sparse.coo_matrix(
        (np.rint(counts.data).astype(np.int64), (counts.row, counts.col)),
        shape=counts.shape))
  with gzip.open(os.path.join(path, "barcodes.tsv.gz"), "wt") as f:
    f.write("".join(f"{b}\n" for b in sco.obs_names))
  names = [(n, "Gene Expression")
           for n in sco.get_var_names("transcriptomic")]
  names += [(n, "Antibody Capture") for n in sco.get_var_names("proteomic")]
  with gzip.open(os.path.join(path, "features.tsv.gz"), "wt") as f:
    f.write("".join(f"F{j:07d}\t{n}\t{kind}\n"
                    for j, (n, kind) in enumerate(names)))
  return path


def make_user_file(work: str, format: str) -> str:
  """Write the stand-in in ``format``; returns the path a user passes."""
  sco = user_data()
  if format == "10x":
    path = _write_10x(sco, os.path.join(work, "filtered_feature_bc_matrix"))
  elif format == "h5ad":
    from ..data.h5ad import write_h5ad   # raises naming h5py without it
    path = write_h5ad(sco, os.path.join(work, "my_cite_seq.h5ad"))
  else:
    raise ValueError(f"format must be one of {FORMATS}, given {format!r}")
  print("user file:", path)
  return path


def _run_stages(stages, env):
  """The stages, each the command a user would type
  (``python -m sisua_tpu_torch.cli.<module> ARGS``), run as the JAX drill
  runs them: one after the other in one process, here a process of its
  own, whose $SISUA_EXP is set before its first import."""
  code = ["from sisua_tpu_torch.cli import evaluate, train"]
  for module, args in stages:
    print(f"$ python -m sisua_tpu_torch.cli.{module} {' '.join(args)}",
          flush=True)
    code.append(f"{module}.main({list(args)!r})")
  subprocess.run([sys.executable, "-c", "\n".join(code)], env=env,
                 check=True)


def main(device=None, out_dir=None, depth=None, figures=False,
         format="10x"):
  dev = device_of(device)
  work = out_dir_of(out_dir, "real_data_drill")
  exp, figs = os.path.join(work, "exp"), os.path.join(work, "figs")
  # the experiment store binds at import: set before each stage's start
  env = dict(os.environ, SISUA_EXP=exp, PYTHONPATH=os.pathsep.join(
      p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
  path = make_user_file(work, format)

  _run_stages([
      # == python -m sisua_tpu_torch.cli.train model.name=sisua
      #        dataset.name=<path>
      ("train", [f"dataset.name={path}", "model.name=sisua",
                 f"train.epochs={at_depth(EPOCHS, depth)}",
                 "dataset.batch_size=128", "--device", dev]),
      # == python -m sisua_tpu_torch.cli.evaluate -model sisua -ds <path>
      ("evaluate", ["-model", "sisua", "-ds", path, "-path", figs,
                    "--device", dev]
       + (["--summary-plots"] if figures else ["--no-plots"]))], env)
  files = sorted(f for f in os.listdir(figs) if f.startswith("scores"))
  from ..train.scoreboard import ScoreBoard
  board = ScoreBoard(os.path.join(exp, "scoreboard.db"))
  tables = {t: board.read_scores(t) for t in board.tables}
  errors = board.read_errors()
  board.close()
  if errors:
    raise RuntimeError(f"the stages wrote errors: {errors}")
  print(f"{sum(len(v) for v in tables.values())} model score row(s) in "
        f"{sorted(tables)} → {figs}")
  print("scores files:", files)
  return {"format": format, "scores_files": files,
          "tables": {t: len(v) for t, v in tables.items()}}


if __name__ == "__main__":
  p = parser(__doc__)
  p.add_argument("--format", default="10x", choices=FORMATS)
  a = p.parse_args()
  main(device=a.device, out_dir=a.out, depth=a.depth, figures=a.figures,
       format=a.format)
