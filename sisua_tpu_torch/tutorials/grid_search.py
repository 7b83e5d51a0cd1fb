"""Grid search (port of ``tutorials/grid_search.py``): the experimenter
fans a dot-override grid out into one experiment per combination (``-m``;
``--ncpu`` adds processes). Every run lands in a config-hashed directory
with its weights and scores, and all scores gather in one sqlite
scoreboard.

  python -m sisua_tpu_torch.tutorials.grid_search
  python -m sisua_tpu_torch.tutorials.grid_search --device cpu
"""

from __future__ import annotations

import math
import os

from ._common import at_depth, device_of, out_dir_of, run_cli

MODELS = ("vae", "dca", "sisua")
BETAS = (0.5, 1.0)
EPOCHS = 3


def grid_args(depth=None):
  """The command line of the grid: 3 models × 2 betas = 6 runs at
  ``depth=None``; a depth keeps the first models and betas (2 runs at
  depth 1)."""
  models = MODELS[:at_depth(len(MODELS), depth, least=2)]
  betas = BETAS[:at_depth(len(BETAS), depth)]
  return [f"model.name={','.join(models)}",
          f"model.beta={','.join(str(b) for b in betas)}",
          "dataset.name=synthetic",
          f"train.epochs={at_depth(EPOCHS, depth)}",
          "train.valid_freq=0",
          "-m"]          # multirun over the grid


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..train.experimenter import SisuaExperimenter
  dev = device_of(device)
  exp = SisuaExperimenter(
      save_path=os.path.join(out_dir_of(out_dir, "grid_search"), "exp"),
      device=dev)

  # --- 1. the grid ---------------------------------------------------------------
  exp.run(grid_args(depth))

  # --- 2. the scoreboard gathers every run: its columns picked by name ----------
  # (a run without a metric reads NaN there, the table's empty cell: left
  # out, as pandas prints NaN)
  table = exp.scoreboard.read_scores("scores_synthetic")
  scores = {uid: {k: round(v, 3) for k, v in row.items()
                  if k.startswith(("llk", "imputation_med"))
                  and not math.isnan(v)}
            for uid, row in table.items()}
  for uid, row in scores.items():
    print(uid, row)

  # --- 3. reload any trained model by query ---------------------------------------
  reloaded = []
  for cfg, model in exp.get_models("model.name=dca", load_models=True):
    print("reloaded:", type(model).__name__, "beta =", cfg["model"]["beta"])
    reloaded.append({"class": type(model).__name__,
                     "beta": cfg["model"]["beta"]})
  return {"scores": scores, "reloaded": reloaded}


if __name__ == "__main__":
  run_cli(main, __doc__)
