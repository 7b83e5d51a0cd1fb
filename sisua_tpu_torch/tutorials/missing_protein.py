"""Missing-protein ablation: train the semi-supervised model without some
protein channels, then ask whether its latent space still predicts them
(port of ``tutorials/missing_protein.py``).

  python -m sisua_tpu_torch.tutorials.missing_protein
  python -m sisua_tpu_torch.tutorials.missing_protein --device cpu
"""

from __future__ import annotations

import numpy as np

from ._common import at_depth, device_of, first, host, run_cli

REMOVED = [0, 1]  # the first two proteins leave the training labels
EPOCHS = 10


def ablate(sco):
  """(ablated copy, full protein matrix, protein names, kept columns): the
  container with the REMOVED proteins taken out of its panel."""
  from ..data import OMIC
  full_y = sco.numpy(OMIC.proteomic)
  names = np.asarray(sco.get_var_names(OMIC.proteomic))
  keep = np.setdiff1d(np.arange(len(names)), REMOVED)
  ablated = sco.copy()
  ablated.add_omic(OMIC.proteomic, full_y[:, keep], list(names[keep]))
  return ablated, full_y, names, keep


def held_out_labels(sco, full_y, device):
  """The REMOVED proteins binarized once on the full matrix, then sliced
  by each half of the same deterministic split: (y_train, y_test).
  ProbabilisticEmbedding's log-norm rescales by the column sums of the
  array it is given, so a fit per split half would threshold each at a
  different scale."""
  from ..label_threshold import ProbabilisticEmbedding
  train_full, test_full = sco.split(0.8)
  pe = ProbabilisticEmbedding(device=device).fit(full_y[:, REMOVED])
  y_full = pe.predict(full_y[:, REMOVED])
  pos = {n: i for i, n in enumerate(sco.obs_names)}
  return (y_full[[pos[n] for n in train_full.obs_names]],
          y_full[[pos[n] for n in test_full.obs_names]])


def build(sco, keep, device):
  from ..models import SISUA, RVmeta
  return SISUA(outputs=[RVmeta(sco.n_vars, "zinb", name="rna"),
                        RVmeta(len(keep), "nb", name="adt")],
               latents=RVmeta(10, "diag", name="latents"), device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..analysis.latent import streamline_classifier
  from ..data import get_dataset
  from ..data.adapters import fit_sco, sco_matrices
  dev = device_of(device)

  # --- 1. dataset with an ablated protein panel -------------------------------
  sco = get_dataset("synthetic")
  ablated, full_y, names, keep = ablate(sco)
  print("training panel:", list(names[keep]))
  print("held-out proteins:", list(names[REMOVED]))

  # --- 2. train on the ablated panel ------------------------------------------
  train, test = ablated.split(0.8)           # deterministic, seed-shared
  model = build(sco, keep, dev)
  fit_sco(model, train, valid=test, epochs=at_depth(EPOCHS, depth),
          batch_size=64, labels_percent=0.5, verbose=True)

  # --- 3. do the latents still encode the REMOVED proteins? --------------------
  def latents_of(data):
    _, qZ = model.predict(sco_matrices(model, data), batch_size=128)
    return host(first(qZ).mean())

  y_train, y_test = held_out_labels(sco, full_y, dev)
  _, test_scores = streamline_classifier(
      latents_of(train), y_train, latents_of(test), y_test,
      labels_name=list(names[REMOVED]), device=dev)
  print("F1 on held-out proteins (never seen in training):")
  for k, v in test_scores.items():
    print(f"  {k}: {v:.3f}")
  return {"training_panel": [str(n) for n in names[keep]],
          "held_out": [str(n) for n in names[REMOVED]],
          "f1": dict(test_scores)}


if __name__ == "__main__":
  run_cli(main, __doc__)
