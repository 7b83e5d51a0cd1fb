"""sisua-evaluate for the port: score trained models of the experiment
store.

Finds the experiment directories that match ``-model`` and ``-ds``,
rebuilds each model on ``--device`` (default 'cuda'), builds its
posterior on the test split of its dataset (or of ``-ds2``), writes each
model's scores to the scoreboard's ``eval_<dataset>`` table and the
``ResultsSheet`` table to ``<path>/scores.csv`` and ``.html``. A step that
fails is recorded on the scoreboard and the sweep goes on; the command
then exits non-zero.

The figures are not ported (ROADMAP A12c): without ``--no-plots`` the
command exits at once, before any work. ``--mesh`` raises (ROADMAP A21).
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

__all__ = ["robust_run", "scoring", "main"]


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


def main(argv=None):
  p = argparse.ArgumentParser("sisua-evaluate")
  p.add_argument("-model", default="", help="model name filter (e.g. vae)")
  p.add_argument("-ds", default="", help="dataset name filter")
  p.add_argument("-ds2", default="",
                 help="cross-dataset: evaluate on this dataset instead")
  p.add_argument("-path", default="/tmp/sisua_evaluate",
                 help="output folder of the score table")
  p.add_argument("--no-plots", action="store_true",
                 help="required: the figures are not ported (ROADMAP A12c)")
  p.add_argument("--mesh", default=None,
                 help="not ported (ROADMAP A21): raises")
  p.add_argument("--device", default="cuda",
                 help="where the models score: 'cuda' (default) or 'cpu'")
  args = p.parse_args(argv)
  if not args.no_plots:
    raise SystemExit(
        "sisua-evaluate: the figures are not ported yet (ROADMAP A12c); "
        "pass --no-plots to compute and save the scores only")
  if args.mesh is not None:
    raise NotImplementedError("--mesh: posteriors over a device mesh are "
                              "not ported yet (ROADMAP A21)")

  from ..analysis import ResultsSheet
  from ..data import get_dataset
  from ..data.adapters import sco_posterior
  from ..train.experimenter import SisuaExperimenter

  exp = SisuaExperimenter(device=args.device)
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
          retain_rate=float(cfg["dataset"].get("retain_rate", 0.2)))

    post = robust_run("posterior", uid, _make_posterior,
                      scoreboard=exp.scoreboard)
    if post is None:
      failures += 1
      continue
    scores = robust_run("scoring", uid, scoring, post, exp.scoreboard,
                        table=f"eval_{ds_name}", uid=uid,
                        scoreboard=exp.scoreboard)
    if scores is None:
      failures += 1
    else:
      print(f"[{uid}] " + " ".join(
          f"{k}={v:.4f}" for k, v in list(scores.items())[:5]))
    for family, err in post.failures.items():
      exp.scoreboard.write_error(f"scoring:{uid}",
                                 f"posterior.{family} failed: {err}")
      failures += 1
    posteriors.append(post)

  if posteriors:
    rs = ResultsSheet(*posteriors)
    print("scores →", rs.save_scores(os.path.join(args.path, "scores")))
  if failures:
    raise SystemExit(f"sisua-evaluate: {failures} step(s) failed (see the "
                     f"errors of {exp.scoreboard.path})")
  return posteriors


if __name__ == "__main__":
  main()
