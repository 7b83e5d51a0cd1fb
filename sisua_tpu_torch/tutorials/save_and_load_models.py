"""Save / load: a directory of weights (msgpack, the flax layout) plus a
JSON "metamodel" describing the architecture, so ``load_model(path)``
rebuilds the class without a pickle (port of
``tutorials/save_and_load_models.py``).

  python -m sisua_tpu_torch.tutorials.save_and_load_models
  python -m sisua_tpu_torch.tutorials.save_and_load_models --device cpu
"""

from __future__ import annotations

import os

import numpy as np

from ._common import at_depth, device_of, first, host, out_dir_of, run_cli

EPOCHS = 10
RTOL = 1e-6


def build(sco, device):
  from ..models import SCVI, NetConf, RVmeta
  return SCVI(outputs=RVmeta(sco.n_vars, "zinbd", name="rna"),
              latents=RVmeta(10, "diag", name="latents"),
              encoder=NetConf((64, 64), batchnorm=True), device=device)


def _max_rel(a, b) -> float:
  return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data import get_dataset
  from ..data.adapters import fit_sco, sco_matrices
  from ..models import load_model
  dev = device_of(device)
  path = os.path.join(out_dir_of(out_dir, "save_and_load_models"), "model")

  # --- 1. train ---------------------------------------------------------------
  sco = get_dataset("synthetic")
  train, test = sco.split(train_percent=0.8)
  scvi = build(sco, dev)
  fit_sco(scvi, train, valid=test, epochs=at_depth(EPOCHS, depth),
          batch_size=64, verbose=True,
          checkpoint_path=path)  # also checkpoints on every best val_loss

  # --- 2. save: weights + metamodel (+ training history) ----------------------
  scvi.save_weights(path)
  saved = sorted(os.listdir(path))
  print("saved:", saved)

  # --- 3. load: rebuild the class from the metamodel ----------------------------
  loaded = load_model(path, device=dev)
  epochs = len(loaded.history.get("loss", []))
  print("loaded:", type(loaded).__name__, "| history epochs:", epochs)

  # --- 4. the same posterior statistics ------------------------------------------
  # decoding draws a reparameterized z: pin both models' generators so the
  # stochastic forward matches draw for draw
  counts = sco_matrices(scvi, test)
  scvi.generator.manual_seed(0)
  loaded.generator.manual_seed(0)
  pX1, qZ1 = scvi.predict(counts, sample_shape=(), batch_size=128)
  pX2, qZ2 = loaded.predict(counts, sample_shape=(), batch_size=128)
  z1, z2 = host(first(qZ1).mean()), host(first(qZ2).mean())
  x1, x2 = host(first(pX1).mean()), host(first(pX2).mean())
  np.testing.assert_allclose(z1, z2, rtol=RTOL)
  np.testing.assert_allclose(x1, x2, rtol=RTOL)
  print("saved and loaded models agree (latent + output means allclose)")
  return {"saved": saved, "history_epochs": epochs,
          "latent_mean_max_rel": _max_rel(z1, z2),
          "output_mean_max_rel": _max_rel(x1, x2)}


if __name__ == "__main__":
  run_cli(main, __doc__)
