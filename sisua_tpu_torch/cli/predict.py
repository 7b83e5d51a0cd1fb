"""sisua-predict for the port: batch scoring with a trained checkpoint.

Loads a ``save_weights`` directory of either package on ``--device``
(default 'cuda') and scores a registry dataset, an ``.h5ad`` (AnnData,
read with h5py), an ``.npz`` (a dense 'X', a single array, or a
``scipy.sparse.save_npz`` file) or a ``.csv`` (cells × genes, a header
row and an index column), writing the posterior means of the outputs
(``imputed.npz``), of the latents (``latents.npz``), TotalVI's denoised
proteins for a registry dataset or an ``.h5ad``, and ``manifest.json``,
with the JAX command's keys. A container (a registry dataset or an
``.h5ad``) gives the model the omics it was trained on. ``--mesh all|N``
scores over a data mesh of that many ranks (``cli/_world.py``); rank 0
writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_counts(path: str):
  import numpy as np
  if path.endswith(".h5ad"):
    from ..data import read_h5ad
    return read_h5ad(path)
  if path.endswith(".npz"):
    f = np.load(path)
    keys = set(f.keys())
    if "format" in keys:  # scipy.sparse.save_npz, any sparse layout
      from scipy import sparse
      return sparse.load_npz(path).tocsr()
    if "X" in keys:
      return np.asarray(f["X"], np.float32)
    if len(keys) == 1:
      return np.asarray(f[next(iter(keys))], np.float32)
    raise ValueError(
        f"{path} carries arrays {sorted(keys)}; expected an 'X' array, a "
        "single array, or a scipy.sparse.save_npz file")
  if path.endswith((".csv", ".csv.gz")):
    from ..data.utils import read_csv_matrix
    return read_csv_matrix(path)
  raise ValueError(f"unsupported input file: {path}")


def main(argv=None):
  p = argparse.ArgumentParser("sisua-predict")
  p.add_argument("model", help="checkpoint dir written by save_weights")
  p.add_argument("input",
                 help="dataset name, .h5ad, .npz, or .csv of counts")
  p.add_argument("-o", "--outpath", default="/tmp/sisua_predict")
  p.add_argument("--batch", type=int, default=256)
  p.add_argument("--sample-shape", type=int, default=10,
                 help="MC samples averaged on the device")
  p.add_argument("--fetch-dtype", default="float32",
                 choices=("float32", "bfloat16"),
                 help="bfloat16 halves the device→host fetch (~0.4%% "
                      "relative error)")
  p.add_argument("--mesh", default=None,
                 help="score data-parallel over a mesh: 'all' (a rank per "
                      "card) or N ranks (gloo ranks with --device cpu)")
  p.add_argument("--device", default="cuda",
                 help="where the model scores: 'cuda' (default) or 'cpu'")
  argv = list(sys.argv[1:] if argv is None else argv)
  args = p.parse_args(argv)
  mesh = None
  if args.mesh is not None:
    from . import _world
    if not _world.joined():
      return _world.start(main, argv, _world.world_size(
          args.mesh, args.device), args.device)
    from ..parallel import create_mesh
    mesh = create_mesh()

  import numpy as np

  from ..data import get_dataset, get_dataset_meta
  from ..models import load_model
  from ..data.adapters import sco_matrices
  from ..parallel import is_main_rank

  model = load_model(args.model, device=args.device)
  sco = None
  if args.input in get_dataset_meta():
    sco = get_dataset(args.input)
    data, n = sco_matrices(model, sco), sco.n_obs
  else:
    data = _load_counts(args.input)
    if hasattr(data, "omics"):  # an .h5ad's container
      sco = data
      data = sco_matrices(model, sco)
    n = data.shape[0] if sco is None else sco.n_obs
  x_means, z_means = model.predict_mean(
      data, sample_shape=(args.sample_shape,), batch_size=args.batch,
      fetch_dtype=args.fetch_dtype, mesh=mesh)
  if not is_main_rank():
    return None

  os.makedirs(args.outpath, exist_ok=True)
  np.savez_compressed(os.path.join(args.outpath, "imputed.npz"),
                      **{f"output{i}": m for i, m in enumerate(x_means)})
  np.savez_compressed(os.path.join(args.outpath, "latents.npz"),
                      **{f"latent{i}": m for i, m in enumerate(z_means)})
  extra = {}
  if hasattr(model, "denoised_proteins") and sco is not None:
    fg = model.denoised_proteins(data, batch_size=args.batch)
    np.savez_compressed(os.path.join(args.outpath, "denoised_proteins.npz"),
                        fg=fg)
    extra["denoised_proteins"] = "denoised_proteins.npz"
  manifest = {
      "model": type(model).__name__,
      "n_cells": int(n),
      "outputs": [list(m.shape) for m in x_means],
      "latents": [list(m.shape) for m in z_means],
      "files": {"imputed": "imputed.npz", "latents": "latents.npz", **extra},
  }
  with open(os.path.join(args.outpath, "manifest.json"), "w") as f:
    json.dump(manifest, f, indent=2)
  print(f"scored {n} cells on {model.device} → {args.outpath}")
  return manifest


if __name__ == "__main__":
  main()
