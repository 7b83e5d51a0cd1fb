"""sisua-predict for the port: batch scoring with a trained checkpoint.

Loads a ``save_weights`` directory of either package on ``--device``
(default 'cuda') and scores a registry dataset (the synthetic family), an
``.npz`` (a dense 'X', a single array, or a ``scipy.sparse.save_npz``
file) or a ``.csv`` (cells × genes, a header row and an index column),
writing the posterior means of the outputs (``imputed.npz``), of the
latents (``latents.npz``), TotalVI's denoised proteins for a registry
dataset, and ``manifest.json``, with the JAX command's keys. ``.h5ad``
needs h5py and ``--mesh`` the port's mesh (ROADMAP A21): both raise.
"""

from __future__ import annotations

import argparse
import json
import os


def _load_counts(path: str):
  import numpy as np
  if path.endswith(".h5ad"):
    raise NotImplementedError(
        f"{path}: reading AnnData needs h5py, which the port does not use; "
        "write the counts as .npz or .csv")
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
  p.add_argument("input", help="dataset name, .npz, or .csv of counts")
  p.add_argument("-o", "--outpath", default="/tmp/sisua_predict")
  p.add_argument("--batch", type=int, default=256)
  p.add_argument("--sample-shape", type=int, default=10,
                 help="MC samples averaged on the device")
  p.add_argument("--fetch-dtype", default="float32",
                 choices=("float32", "bfloat16"),
                 help="bfloat16 halves the device→host fetch (~0.4%% "
                      "relative error)")
  p.add_argument("--mesh", default=None,
                 help="not ported (ROADMAP A21): raises")
  p.add_argument("--device", default="cuda",
                 help="where the model scores: 'cuda' (default) or 'cpu'")
  args = p.parse_args(argv)
  if args.mesh is not None:
    raise NotImplementedError("--mesh: scoring over a device mesh is not "
                              "ported yet (ROADMAP A21)")

  import numpy as np

  from ..data import get_dataset, get_dataset_meta
  from ..models import load_model
  from ..data.adapters import sco_matrices

  model = load_model(args.model, device=args.device)
  sco = None
  if args.input in get_dataset_meta():
    sco = get_dataset(args.input)
    data, n = sco_matrices(model, sco), sco.n_obs
  else:
    data = _load_counts(args.input)
    n = data.shape[0]
  x_means, z_means = model.predict_mean(
      data, sample_shape=(args.sample_shape,), batch_size=args.batch,
      fetch_dtype=args.fetch_dtype)

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
