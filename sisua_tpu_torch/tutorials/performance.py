"""The card's fast paths (port of ``tutorials/tpu_performance.py``):
device-resident window training, bf16 compute, the vmapped hyper-search,
``predict_mean``, checkpoints, and out-of-core training on int16 CSR under
a forced device budget. At these small sizes it shows the paths, not
their speed; the numbers it prints are this run's own.

  python -m sisua_tpu_torch.tutorials.performance
  python -m sisua_tpu_torch.tutorials.performance --device cpu
"""

from __future__ import annotations

import os

import numpy as np

from ._common import at_depth, device_of, out_dir_of, run_cli

EPOCHS = 8
BF16_EPOCHS = 2
HYPER_EPOCHS = 4
OOC_EPOCHS = 4
DRAWS = 8


def data():
  from ..data import generate_synthetic
  sco = generate_synthetic(n_cells=2048, n_genes=100, n_proteins=8, seed=0)
  return sco, sco.split(0.8, seed=1)


def train_csr(train):
  """The training counts as a CSR matrix (the out-of-core input)."""
  import scipy.sparse as sp
  X = train.X
  return sp.csr_matrix(np.asarray(X.todense() if sp.issparse(X) else X))


def build_scvi(device):
  from ..models import SCVI, RVmeta
  return SCVI(RVmeta(100, "zinbd", name="rna"),
              latents=RVmeta(16, "diag", name="latents"), device=device)


def build_bf16(device):
  from ..models import VAE, RVmeta
  return VAE(RVmeta(100, "zinb", name="rna"), compute_dtype="bfloat16",
             device=device)


def build_member(seed, device):
  from ..models import VAE, RVmeta
  return VAE(RVmeta(100, "zinb", name="rna"), seed=seed,
             encoder={"units": [32]}, decoder={"units": [32]},
             device=device)


def build_out_of_core(n_vars, device):
  from ..models import VAE, NetConf, RVmeta
  return VAE(RVmeta(n_vars, "zinb", name="rna"), encoder=NetConf((64,)),
             decoder=NetConf((64,)), device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data.adapters import fit_sco, sco_matrices
  from ..models.hyper_params import fit_hyper_vmap
  dev, out = device_of(device), out_dir_of(out_dir, "performance")
  sco, (train, test) = data()

  # --- 1. device-resident window training ---------------------------------------
  # the dataset lives on the card; each ``metrics_interval`` window of
  # epochs (shuffle, masks, every step) ends in one metric fetch
  model = build_scvi(dev)
  fit_sco(model, train, epochs=at_depth(EPOCHS, depth), batch_size=128,
          device_cache=True, metrics_interval=4, valid_freq=0, patience=0)
  losses = [round(v, 1) for v in model.history["loss"]]
  rates = list(model.history["cells_per_sec"])
  print("window losses:", losses)
  print("cells/sec:", [f"{r:,.0f}" for r in rates])

  # --- 2. bf16 compute (for wide-gene-head models) --------------------------------
  # the MLPs and the heads' matmuls in bf16; parameters, BatchNorm
  # statistics and every log-prob stay float32
  bf16 = build_bf16(dev)
  fit_sco(bf16, train, epochs=at_depth(BF16_EPOCHS, depth), batch_size=128,
          valid_freq=0, patience=0)
  dtype = str(next(bf16.module.parameters()).dtype)
  print("bf16 loss:", round(bf16.history["loss"][-1], 1),
        "| params stay float32:", dtype)

  # --- 3. several cards: fit(mesh=create_mesh()) over torch.distributed ----------
  #   from sisua_tpu_torch.parallel import create_mesh
  #   model.fit(..., mesh=create_mesh(), device_cache=True)

  # --- 4. the vmapped hyper-search: every lr × seed trial in one fleet ------------
  res = fit_hyper_vmap(
      lambda seed: build_member(seed, dev), sco_matrices(model, train),
      learning_rates=(3e-4, 3e-3), seeds_per_rate=2,
      epochs=at_depth(HYPER_EPOCHS, depth), batch_size=128)
  print("hyper-vmap best:", res["best"], "loss:", round(res["loss"], 1))

  # --- 5. low-traffic inference: averaged on the card, (n, d) fetched -------------
  x_means, z_means = model.predict_mean(sco_matrices(model, test),
                                        sample_shape=(DRAWS,),
                                        batch_size=256)
  print("imputed means:", x_means[0].shape, "| latents:", z_means[0].shape)

  # --- 6. checkpoint + batch scoring -----------------------------------------------
  ckpt = os.path.join(out, "checkpoint")
  model.save_weights(ckpt)                  # msgpack, the flax layout
  print("checkpoint at", ckpt)
  try:
    model.save_weights(os.path.join(out, "orbax"), backend="orbax")
    orbax = "saved"
  except NotImplementedError as e:          # the port writes msgpack only
    orbax = str(e)
  print("orbax:", orbax)
  # CLI:  python -m sisua_tpu_torch.cli.predict <ckpt> counts.npz -o scored/

  # --- 7. datasets larger than the card (out of core) -------------------------------
  # When the dense dataset exceeds the device budget, device_cache=True
  # trains out of core: rows in device-sized random chunks, as many as fit
  # pinned on the card, the rest streamed each epoch, CSR shipped as
  # triplets and densified on the card. A budget of 8 batch-sized int16
  # chunks (below the dataset) forces it here.
  Xs = train_csr(train)
  oc = build_out_of_core(train.n_vars, dev)
  oc.fit(Xs, epochs=at_depth(OOC_EPOCHS, depth), batch_size=128,
         device_cache=True, device_dtype="int16",
         hbm_budget_bytes=8 * 128 * 2 * Xs.shape[1], verbose=True)
  # serving chunks too when the dataset exceeds the budget
  return {"window_losses": losses, "cells_per_sec": rates,
          "bf16_loss": bf16.history["loss"][-1], "param_dtype": dtype,
          "hyper_best": res["best"], "hyper_loss": res["loss"],
          "imputed_means": list(x_means[0].shape),
          "latents": list(z_means[0].shape), "orbax": orbax,
          "out_of_core_losses": list(oc.history["loss"])}


if __name__ == "__main__":
  run_cli(main, __doc__)
