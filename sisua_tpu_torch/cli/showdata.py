"""sisua-showdata for the port: a dataset's statistics and figures (port of
``sisua_tpu/cli/showdata.py``).

Prints the container and each omic's shape, sparsity and mean library
size, computes the QC metrics on ``--device`` (default 'cuda') and writes
``obs_stats.csv``, the summary of the numeric ``obs`` columns (count,
mean, std, min, quartiles, max: the layout of the JAX command's pandas
``describe``). With ``--figures`` it also writes the container's figures
(histograms, series, and for a labelled dataset the PCA scatter, dot
plot, heatmap and violins), which need matplotlib and seaborn: without
them it stops before any work. ``--list`` lists the registry's names
with their availability tags. ``-ds`` takes a registry name, a CellRanger
matrix directory, a CellRanger ``.h5`` or an ``.h5ad``.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

__all__ = ["main"]


def _describe(obs, path: str):
  """The numeric obs columns' summary as pandas ``describe().to_csv``
  writes it."""
  cols = [k for k, v in obs.items()
          if np.asarray(v).ndim == 1 and np.issubdtype(np.asarray(v).dtype,
                                                       np.number)]
  rows = {"count": [], "mean": [], "std": [], "min": [], "25%": [],
          "50%": [], "75%": [], "max": []}
  for k in cols:
    v = np.asarray(obs[k], np.float64)
    q = np.percentile(v, [25, 50, 75])
    for name, x in (("count", float(v.size)), ("mean", v.mean()),
                    ("std", v.std(ddof=1) if v.size > 1 else np.nan),
                    ("min", v.min()), ("25%", q[0]), ("50%", q[1]),
                    ("75%", q[2]), ("max", v.max())):
      rows[name].append(repr(float(x)))
  with open(path, "w", newline="") as f:
    w = csv.writer(f)
    w.writerow([""] + cols)
    for name, values in rows.items():
      w.writerow([name] + values)


def main(argv=None):
  p = argparse.ArgumentParser("sisua-showdata")
  p.add_argument("-ds", default=None,
                 help="dataset registry name, 10x directory or file")
  p.add_argument("-path", default="/tmp/sisua_showdata")
  p.add_argument("--figures", action="store_true",
                 help="also render the full figure battery")
  p.add_argument("--list", action="store_true", dest="list_datasets",
                 help="list all registry names with availability")
  p.add_argument("--device", default="cuda",
                 help="where the statistics and figures' data are "
                      "computed: 'cuda' (default) or 'cpu'")
  args = p.parse_args(argv)

  if args.list_datasets:
    from ..data import get_dataset_availability
    avail = get_dataset_availability()
    width = max(map(len, avail))
    for name in sorted(avail):
      print(f"{name:<{width}}  {avail[name]}")
    print(f"\n{len(avail)} datasets | tags: always = in-memory synthetic; "
          "public-download = native download+preprocess pipeline; "
          "optional-dep = needs scvi-tools; R-required = convert upstream "
          ".rds with tools/convert_rds.R")
    return None
  if args.ds is None:
    p.error("-ds is required (or use --list)")
  if args.figures:
    from ..utils.visualization import _seaborn
    _seaborn()  # no matplotlib or seaborn: stop before any work

  from scipy import sparse
  from ..data import get_dataset
  sco = get_dataset(args.ds, verbose=True)
  print(sco)
  for om in sco.omics:
    x = sco.get_omic(om)
    # from the sparse structure: a large CSR is never densified
    if sparse.issparse(x):
      nnz_frac = x.nnz / float(x.shape[0] * x.shape[1])
      total_mean = float(np.asarray(x.sum(1)).mean())
    else:
      nnz_frac = float((x > 0).mean())
      total_mean = float(x.sum(1).mean())
    print(f"  {om}: shape={x.shape} sparsity={1.0 - nnz_frac:.3f} "
          f"total_mean={total_mean:.1f}")
  dev = args.device
  sco.calculate_quality_metrics(device=dev)
  os.makedirs(args.path, exist_ok=True)
  _describe(sco.obs, os.path.join(args.path, "obs_stats.csv"))
  if args.figures:
    label = None
    for cand in ("celltype", "disease", "progenitor"):
      if cand in sco.omics:
        label = cand
        break
    sco.plot_histogram(device=dev).plot_percentile_histogram(
        device=dev).plot_series(device=dev)
    if label is not None:
      sco.plot_scatter(color_by=label, algo="pca", device=dev)
      sco.plot_dotplot(group_by=label, device=dev)
      sco.plot_heatmap(group_by=label, device=dev)
      sco.plot_stacked_violins(group_by=label, device=dev)
    sco.save_figures(args.path)
  print("stats →", args.path)
  return sco


if __name__ == "__main__":
  main()
