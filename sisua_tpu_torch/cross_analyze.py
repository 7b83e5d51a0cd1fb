"""Cross-dataset analysis: evaluate trained models across cohorts (port of
``sisua_tpu/cross_analyze.py``).

For each (model, train-dataset) pair of the experiment store, each
checkpoint keyed ``name:train_dataset:confighash``, its posterior is
built on the test split of every requested dataset, the proteins cut to
the panel all the datasets share; the scores go to the scoreboard's
``cross_<dataset>`` tables and one ``ResultsSheet`` writes the table and
its comparison figures to ``outpath``. The models score on ``device``
(default 'cuda'). ``n_processes`` > 1 evaluates in a thread pool. The
figures need matplotlib and seaborn: without them it stops before any
model is scored.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Sequence, Tuple

__all__ = ["cross_analyze", "main"]


def _shared_protein_panel(scos) -> List[str]:
  shared = None
  for sco in scos:
    if "proteomic" not in sco.omics:
      continue
    names = set(map(str, sco.get_var_names("proteomic")))
    shared = names if shared is None else (shared & names)
  return sorted(shared or [])


def cross_analyze(model_names: Sequence[str],
                  dataset_names: Sequence[str],
                  outpath: str = "/tmp/sisua_cross",
                  n_processes: int = 1,
                  verbose: bool = False,
                  device="cuda"):
  """Evaluate each trained checkpoint on each dataset; returns
  ``{('name:train_ds:hash', eval_ds): scores}``."""
  from .analysis import ResultsSheet
  from .data import get_dataset
  from .data.adapters import sco_posterior
  from .train.experimenter import SisuaExperimenter, config_hash
  from .utils.visualization import _seaborn
  _seaborn()

  exp = SisuaExperimenter(device=device)
  datasets = {}
  for ds in dataset_names:
    sco = get_dataset(ds)
    _, test = sco.split(0.8)
    datasets[ds] = test
  panel = _shared_protein_panel(list(datasets.values()))
  if verbose:
    print(f"[cross] shared protein panel ({len(panel)}): {panel}")

  tasks = []
  for mname in model_names:
    for cfg, model in exp.get_models(f"model.name={mname}",
                                     load_models=True):
      if model is None:
        continue
      train_ds = cfg.get("dataset", {}).get("name", "data")
      mid = f"{mname}:{train_ds}:" \
            f"{config_hash(cfg, exp.exclude_keys, exp.hash_length)}"
      for ds, test in datasets.items():
        tasks.append((mid, model, ds, test))

  def _eval_one(task):
    mid, model, ds, test = task
    sco = test.copy()
    if panel and "proteomic" in sco.omics:
      pidx = sco.get_var_indices("proteomic")
      keep = [pidx[p] for p in panel if p in pidx]
      sco.set_omic("proteomic")
      sco.apply_indices(keep, observation=False)
      sco.set_omic("transcriptomic")
    if sco.n_vars != model.outputs[0].dim:
      if verbose:
        print(f"[cross] skip {mid} on {ds}: gene dim "
              f"{sco.n_vars} != {model.outputs[0].dim}")
      return None
    post = sco_posterior(model, sco)
    post.name = f"{mid}_{ds}"
    return mid, ds, post, post.save_scores()

  if n_processes > 1 and len(tasks) > 1:
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=int(n_processes)) as pool:
      results = list(pool.map(_eval_one, tasks))
  else:
    results = [_eval_one(t) for t in tasks]

  posteriors = []
  scores: Dict[Tuple[str, str], Dict[str, float]] = {}
  for r in results:
    if r is None:
      continue
    mid, ds, post, s = r
    scores[(mid, ds)] = s
    posteriors.append(post)
    exp.scoreboard.write_scores(table=f"cross_{ds}",
                                unique=f"{mid}_{ds}", scores=s)
  if posteriors:
    rs = ResultsSheet(*posteriors, verbose=verbose)
    os.makedirs(outpath, exist_ok=True)
    rs.save_scores(os.path.join(outpath, "cross_scores"))
    rs.plot_all()
    rs.save_figures(outpath)
  return scores


def main(argv=None):
  p = argparse.ArgumentParser(
      "sisua-cross-analyze",
      description="evaluate trained models across datasets on the shared "
      "protein panel")
  p.add_argument("-model", required=True, help="comma-separated model names")
  p.add_argument("-ds", required=True, help="comma-separated dataset names")
  p.add_argument("-path", default="/tmp/sisua_cross")
  p.add_argument("-ncpu", type=int, default=1)
  p.add_argument("--verbose", action="store_true")
  p.add_argument("--device", default="cuda",
                 help="where the models score: 'cuda' (default) or 'cpu'")
  args = p.parse_args(argv)
  return cross_analyze(args.model.split(","), args.ds.split(","),
                       outpath=args.path, n_processes=args.ncpu,
                       verbose=args.verbose, device=args.device)


if __name__ == "__main__":
  main()
