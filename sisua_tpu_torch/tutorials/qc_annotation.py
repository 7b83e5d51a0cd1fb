"""QC and annotation: AUTOZI → SOLO → CellAssign, the pre-analysis
pipeline run before any model verdict: which genes are really
zero-inflated (AUTOZI), which barcodes are doublets (SOLO), and what cell
type each remaining cell is (CellAssign) (port of
``tutorials/qc_annotation.py``).

  python -m sisua_tpu_torch.tutorials.qc_annotation
  python -m sisua_tpu_torch.tutorials.qc_annotation --device cpu
"""

from __future__ import annotations

import numpy as np

from ._common import at_depth, device_of, run_cli

AUTOZI_EPOCHS = 20
SCVI_EPOCHS = 15
SOLO_EPOCHS = 25
CA_EPOCHS = 80
MARKERS_PER_TYPE = 5


def build_autozi(G, device):
  from ..models import AUTOZI, NetConf, RVmeta
  return AUTOZI(RVmeta(G, "zinbd", name="rna"), encoder=NetConf((64,)),
                decoder=NetConf((64,)), seed=0, device=device)


def build_scvi(G, device):
  from ..models import SCVI, NetConf, RVmeta
  return SCVI(RVmeta(G, "zinbd", name="rna"), encoder=NetConf((64,)),
              decoder=NetConf((64,)), seed=0, device=device)


def pair_sums(x):
  """Synthetic doublets: the first 50 cells plus the next 50."""
  return x[:50] + x[50:100]


def marker_panel(x, types, n_types):
  """(panel, rho): the top differential genes of each true type on the
  first half of the cells, and the panel × type marker matrix."""
  half = x.shape[0] // 2
  marker_idx = []
  for c in range(n_types):
    mu_c = x[:half][types[:half] == c].mean(0)
    mu_rest = x[:half][types[:half] != c].mean(0)
    fold = (mu_c + 1e-3) / (mu_rest + 1e-3)
    marker_idx.append(np.argsort(-fold)[:MARKERS_PER_TYPE])
  panel = np.unique(np.concatenate(marker_idx))
  rho = np.zeros((len(panel), n_types), np.float32)
  for c, idx in enumerate(marker_idx):
    rho[np.searchsorted(panel, idx), c] = 1.0
  return panel, rho


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data import OMIC, get_dataset
  from ..models import SOLO, CellAssign
  dev = device_of(device)
  sco = get_dataset("synthetic")
  x = sco.numpy()
  G = sco.n_vars
  print(sco)

  # --- 1. AUTOZI: is each gene's excess-zero signal real zero inflation? ------
  autozi = build_autozi(G, dev)
  autozi.fit(x, epochs=at_depth(AUTOZI_EPOCHS, depth), batch_size=64,
             verbose=False)
  q_zi = autozi.get_zi_probabilities()
  print(f"\n[autozi] P(zero-inflated): min {q_zi.min():.3f} "
        f"median {np.median(q_zi):.3f} max {q_zi.max():.3f}")
  n_zi = int((q_zi > 0.5).sum())
  print(f"[autozi] genes leaning ZI (q > 0.5): {n_zi}/{G}")
  # q_zi feeds the likelihood choice: 'zinb' heads for ZI genes, 'nb' else.

  # --- 2. SOLO: doublet scores from an SCVI latent ------------------------------
  scvi = build_scvi(G, dev)
  scvi.fit(x, epochs=at_depth(SCVI_EPOCHS, depth), batch_size=64,
           verbose=False)
  solo = SOLO.from_scvi_model(scvi, seed=0).fit(
      x, epochs=at_depth(SOLO_EPOCHS, depth), verbose=False)
  p_doublet = solo.predict_doublet_proba(x)
  keep = p_doublet < 0.5
  print(f"\n[solo] doublet probability: median {np.median(p_doublet):.3f}; "
        f"keeping {keep.sum()}/{len(keep)} cells at the 0.5 call")
  # sanity: synthetic pair sums should score high
  pair = float(solo.predict_doublet_proba(pair_sums(x)).mean())
  print(f"[solo] simulated doublets score {pair:.3f} "
        f"vs observed {p_doublet.mean():.3f}")

  # --- 3. CellAssign: marker-table annotation of the kept cells -----------------
  # a marker table built from the data itself (in practice a curated panel,
  # such as data.const's MARKER_GENES)
  y = sco.numpy(OMIC.celltype)
  types = np.argmax(y, -1)
  C = y.shape[1]
  half = x.shape[0] // 2
  panel, rho = marker_panel(x, types, C)
  ca = CellAssign(rho, seed=0, device=dev)
  # size factors from the whole transcriptome (panel totals are
  # contaminated by the markers themselves: see models/cellassign.py)
  sf = x.sum(-1) / x.sum(-1).mean()
  first_half = keep & (np.arange(x.shape[0]) < half)
  eval_cells = keep & (np.arange(x.shape[0]) >= half)
  ca.fit(x[:, panel][first_half], size_factors=sf[first_half],
         epochs=at_depth(CA_EPOCHS, depth), batch_size=256)
  gamma = ca.predict(x[:, panel][eval_cells], size_factors=sf[eval_cells])
  acc = float((gamma.argmax(-1) == types[eval_cells]).mean())
  print(f"\n[cellassign] held-out annotation accuracy from a "
        f"{len(panel)}-gene panel: {acc:.3f}")
  lfc = float(ca.get_fold_changes()[rho > 0].mean())
  print("[cellassign] fitted marker log fold-changes (mean over markers): "
        f"{lfc:.2f}")
  return {"autozi": {"min": float(q_zi.min()),
                     "median": float(np.median(q_zi)),
                     "max": float(q_zi.max()), "genes_leaning_zi": n_zi},
          "solo": {"median": float(np.median(p_doublet)),
                   "kept": int(keep.sum()), "pair_sums": pair,
                   "observed": float(p_doublet.mean())},
          "cellassign": {"panel": len(panel), "accuracy": acc,
                         "mean_marker_lfc": lfc}}


if __name__ == "__main__":
  run_cli(main, __doc__)
