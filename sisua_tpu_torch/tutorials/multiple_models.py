"""Multi-model comparison: several model families trained on the same
data and compared in one ``ResultsSheet`` (port of
``tutorials/multiple_models.py``). On the card the same comparison can
run as one vmapped ensemble (``train/ensemble.py``) when the
architectures are identical.

  python -m sisua_tpu_torch.tutorials.multiple_models
  python -m sisua_tpu_torch.tutorials.multiple_models --device cpu
"""

from __future__ import annotations

import re

from ._common import at_depth, device_of, draw, out_dir_of, run_cli

EPOCHS = 8
FAMILIES = ("vae", "dca", "scvi", "sisua")


def build(name, sco, device):
  """The family's model: the semi-supervised family with the labeled
  protein head, the others on the transcriptome alone."""
  from ..data import OMIC
  from ..models import RVmeta, get_model
  cls = get_model(name)
  latents = RVmeta(10, "diag", name="latents")
  if cls.mask_outputs:
    return cls(outputs=[RVmeta(sco.n_vars, "zinb", name="rna"),
                        RVmeta(sco.get_dim(OMIC.proteomic), "nb",
                               name="adt")],
               latents=latents, device=device)
  return cls(outputs=RVmeta(sco.n_vars, "zinbd" if name == "scvi" else "zinb",
                            name="rna"),
             latents=latents, device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..analysis import ResultsSheet
  from ..data import get_dataset
  from ..data.adapters import fit_sco, sco_posterior
  dev, out = device_of(device), out_dir_of(out_dir, "multiple_models")
  epochs = at_depth(EPOCHS, depth)

  sco = get_dataset("synthetic")  # real runs: '8kly', 'vdj4', …
  train, test = sco.split(0.8)

  # --- 1. train the families ------------------------------------------------------
  posteriors, losses = [], {}
  for name in FAMILIES:
    model = build(name, sco, dev)
    fit_sco(model, train, valid=test, epochs=epochs, batch_size=64,
            labels_percent=0.5 if model.mask_outputs else 0.0)
    losses[name] = model.history["loss"][-1]
    print(f"{name}: final loss {losses[name]:.1f}")
    posteriors.append(sco_posterior(model, test))

  # --- 2. one sheet, all models: columns picked by key, rounded as pandas ----------
  sheet = ResultsSheet(*posteriors, verbose=True)
  pick = re.compile("imputation|spearman_mean")
  scores = {p: {k: round(v, 3) for k, v in row.items() if pick.search(k)}
            for p, row in sheet.get_scores().items()}
  for p, row in scores.items():
    print(p, row)
  n_fig = draw(sheet, sheet.plot_all, out, figures)
  print("figures" if figures else "figure data", "in", out)
  return {"final_loss": losses, "sheet": scores, "figures": n_fig}


if __name__ == "__main__":
  run_cli(main, __doc__)
