"""sisua-evaluate for the port: score trained models of the experiment
store.

Finds the experiment directories that match ``-model`` and ``-ds``,
rebuilds each model on ``--device`` (default 'cuda'), builds its
posterior on the test split of its dataset (or of ``-ds2``), writes each
model's scores to the scoreboard's ``eval_<dataset>`` table and the
``ResultsSheet`` table to ``<path>/scores.csv`` and ``.html``, then the
figures into ``<path>``: each posterior's battery (``plot_all(full=True)``,
the 10-figure summary with ``--summary-plots``) and the sheet's
comparison grid, unless ``--no-plots``. A step that fails is recorded on
the scoreboard and the sweep goes on; the command then exits non-zero.
The figures need matplotlib and seaborn: without them the command stops
before any model is scored. ``--mesh all|N``: the posteriors' predictions
run over a data mesh of that many ranks (``cli/_world.py``); rank 0
writes the scoreboard, the tables, the figures and the output, and the
command then returns the posteriors' names.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

__all__ = ["robust_run", "scoring", "plotting", "main"]


def robust_run(method_name, log_text, fn, *args, scoreboard=None, **kwargs):
  """Run one evaluation step, recording (not raising) its exception, so
  one failing model does not end a sweep. Returns the result, or None on
  failure."""
  if not callable(fn):
    raise TypeError(f"{fn!r} is not callable")
  try:
    return fn(*args, **kwargs)
  except Exception:
    text = traceback.format_exc().strip()
    if scoreboard is not None:
      scoreboard.write_error(unique=f"{method_name}:{log_text}", message=text)
    print(f"[evaluate] {method_name} failed ({log_text}):\n{text}",
          file=sys.stderr)
    return None


def scoring(post, scoreboard=None, table: str = "scores",
            uid: str = None) -> dict:
  """Every score family of one posterior, written to the scoreboard when
  one is given."""
  uid = uid or post.name
  scores = post.save_scores()
  if scoreboard is not None:
    scoreboard.write_scores(table=table, unique=uid, scores=scores)
  return scores


def plotting(post, path: str, full: bool = True) -> int:
  """Render one posterior's figure battery into ``path``; returns the
  number of figures."""
  post.plot_all(full=full)
  n = len(post.figures)
  post.save_figures(path)
  return n


def main(argv=None):
  p = argparse.ArgumentParser("sisua-evaluate")
  p.add_argument("-model", default="", help="model name filter (e.g. vae)")
  p.add_argument("-ds", default="", help="dataset name filter")
  p.add_argument("-ds2", default="",
                 help="cross-dataset: evaluate on this dataset instead")
  p.add_argument("-path", default="/tmp/sisua_evaluate",
                 help="output folder for figures")
  p.add_argument("--no-plots", action="store_true")
  p.add_argument("--summary-plots", action="store_true",
                 help="render only the 10-figure summary instead of the "
                      "full per-factor grid")
  p.add_argument("--mesh", default=None,
                 help="run the posteriors' predictions over a data mesh: "
                      "'all' (a rank per card) or N ranks (gloo ranks "
                      "with --device cpu)")
  p.add_argument("--device", default="cuda",
                 help="where the models score: 'cuda' (default) or 'cpu'")
  argv = list(sys.argv[1:] if argv is None else argv)
  args = p.parse_args(argv)
  if not args.no_plots:
    from ..utils.visualization import _seaborn
    _seaborn()  # no matplotlib or seaborn: stop before any model is scored
  mesh = None
  if args.mesh is not None:
    from . import _world
    if not _world.joined():
      return _world.start(main, argv, _world.world_size(
          args.mesh, args.device), args.device)
    from ..parallel import create_mesh
    mesh = create_mesh()

  from ..analysis import ResultsSheet
  from ..data import get_dataset
  from ..data.adapters import sco_posterior
  from ..parallel import is_main_rank
  from ..train.experimenter import SisuaExperimenter

  exp = SisuaExperimenter(device=args.device)
  main_rank = is_main_rank()
  board = exp.scoreboard if main_rank else None
  query = []
  if args.model:
    query.append(f"model.name={args.model}")
  if args.ds:
    query.append(f"dataset.name={args.ds}")
  found = exp.get_models(" ".join(query), load_models=True)
  found = [(cfg, m) for cfg, m in found if m is not None]
  if not found:
    print("No trained models matched", query)
    return []

  posteriors, failures = [], 0
  for cfg, model in found:
    ds_name = args.ds2 or cfg["dataset"]["name"]
    uid = f"{model.id}_{ds_name}"

    def _make_posterior(cfg=cfg, model=model, ds_name=ds_name):
      sco = get_dataset(ds_name)
      _, test = sco.split(float(cfg["dataset"].get("train_percent", 0.8)))
      if test.n_vars != model.outputs[0].dim:
        raise ValueError(f"gene dim {test.n_vars} != model "
                         f"{model.outputs[0].dim} — skipped")
      return sco_posterior(
          model, test,
          dropout_rate=float(cfg["dataset"].get("dropout_rate", 0.2)),
          retain_rate=float(cfg["dataset"].get("retain_rate", 0.2)),
          mesh=mesh)

    post = robust_run("posterior", uid, _make_posterior, scoreboard=board)
    if post is None:
      failures += 1
      continue
    scores = robust_run("scoring", uid, scoring, post, board,
                        table=f"eval_{ds_name}", uid=uid, scoreboard=board)
    if scores is None:
      failures += 1
    elif main_rank:
      print(f"[{uid}] " + " ".join(
          f"{k}={v:.4f}" for k, v in list(scores.items())[:5]))
    for family, err in post.failures.items():
      if main_rank:
        exp.scoreboard.write_error(f"scoring:{uid}",
                                   f"posterior.{family} failed: {err}")
      failures += 1
    posteriors.append(post)

  if not main_rank:
    return [post.name for post in posteriors]
  if posteriors:
    rs = ResultsSheet(*posteriors)
    print("scores →", rs.save_scores(os.path.join(args.path, "scores")))
    if not args.no_plots:
      n_figs = 0
      for post in posteriors:
        n = robust_run("plotting", post.name, plotting, post, args.path,
                       full=not args.summary_plots,
                       scoreboard=exp.scoreboard)
        failures += n is None
        n_figs += n or 0
      n = robust_run("comparison-plots", "results_sheet", rs.plot_all,
                     scoreboard=exp.scoreboard)
      failures += n is None
      n_figs += len(rs.figures)
      rs.save_figures(args.path)
      print(f"{n_figs} figures →", args.path)
  if failures:
    raise SystemExit(f"sisua-evaluate: {failures} step(s) failed (see the "
                     f"errors of {exp.scoreboard.path})")
  return posteriors if mesh is None else [post.name for post in posteriors]


if __name__ == "__main__":
  main()
