"""Hyper-parameter search (port of ``tutorials/bayes_search.py``), two
searchers:

* ``fit_hyper``: discrete TPE (or random) over nlayers × hdim × zdim, one
  trial at a time (or in spawned processes with ``n_processes``);
* ``fit_hyper_vmap``: every lr × seed trial of one architecture trains at
  once in a vmapped fleet on the card.

  python -m sisua_tpu_torch.tutorials.bayes_search
  python -m sisua_tpu_torch.tutorials.bayes_search --device cpu
"""

from __future__ import annotations

from ._common import at_depth, device_of, run_cli

SPACE = {"nlayers": [1, 2], "hdim": [32, 64], "zdim": [6, 10]}
MAX_EVALS = 6
EPOCHS = 3
VMAP_EPOCHS = 5
LEARNING_RATES = (3e-4, 1e-3, 3e-3)
SEEDS_PER_RATE = 2


def build(n_vars, seed, device):
  from ..models import VAE, RVmeta
  return VAE(RVmeta(n_vars, "zinb", name="rna"),
             latents=RVmeta(10, "diag", name="latents"), seed=seed,
             device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data import get_dataset
  from ..data.adapters import sco_matrices
  from ..models.hyper_params import fit_hyper, fit_hyper_vmap
  dev = device_of(device)
  sco = get_dataset("synthetic")
  train, _ = sco.split(0.8)

  # --- 1. discrete TPE over the architecture ----------------------------------------
  result = fit_hyper(model="vae", dataset="synthetic", space=SPACE,
                     algorithm="tpe",
                     max_evals=at_depth(MAX_EVALS, depth, least=2),
                     epochs=at_depth(EPOCHS, depth), verbose=True,
                     device=dev)
  print("best architecture:", result["best"], "| loss:",
        round(result["loss"], 2))

  # --- 2. the vmapped search over lr × seed on the card ------------------------------
  def make(seed: int):
    return build(sco.n_vars, seed, dev)

  counts = sco_matrices(make(0), train)
  vm = fit_hyper_vmap(make, counts, learning_rates=LEARNING_RATES,
                      seeds_per_rate=SEEDS_PER_RATE,   # 6 trials, one fleet
                      epochs=at_depth(VMAP_EPOCHS, depth), verbose=True)
  print("best lr/seed:", vm["best"], "| loss:", round(vm["loss"], 2))
  best_i = min(range(len(vm["trials"])), key=lambda i: vm["trials"][i]["loss"])
  best_model = vm["ensemble"].extract(best_i)
  print("extracted standalone model:", type(best_model).__name__)
  return {"tpe_best": result["best"], "tpe_loss": result["loss"],
          "tpe_trials": len(result["trials"]), "vmap_best": vm["best"],
          "vmap_loss": vm["loss"], "extracted": type(best_model).__name__}


if __name__ == "__main__":
  run_cli(main, __doc__)
