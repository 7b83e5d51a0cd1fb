"""ResultsSheet: the score table over many posteriors (port of the table
part of ``sisua_tpu/analysis/results_sheet.py``, without pandas).

``get_scores()`` gives ``{posterior name: {metric: value}}``, each
posterior's ``save_scores()``; ``save_scores(path)`` writes it as
``<base>.csv`` (parsing to the JAX sheet's table: a row per posterior, the
union of the metrics as columns, an empty field where a posterior lacks
one) and ``<base>.html``. Two posteriors of one name are renamed
``name_1``, ``name_2``, … as the JAX sheet does. The comparison figures
wait for the port's plotting layer (ROADMAP A12c).
"""

from __future__ import annotations

import csv
import html
import math
import os
from typing import Dict, List, Optional

from .posterior import Posterior

__all__ = ["ResultsSheet"]


class ResultsSheet:
  """The score table of several fitted models' posteriors."""

  def __init__(self, *posteriors: Posterior, verbose: bool = False):
    flat: List[Posterior] = []
    for p in posteriors:
      flat.extend(p if isinstance(p, (list, tuple)) else [p])
    if not flat or not all(isinstance(p, Posterior) for p in flat):
      raise ValueError("ResultsSheet needs one or more Posterior objects")
    seen: Dict[str, int] = {}
    for p in flat:
      n = p.name
      if n in seen:
        seen[n] += 1
        p.name = f"{n}_{seen[n]}"
      else:
        seen[n] = 0
    self.posteriors = flat
    self.verbose = bool(verbose)
    self._scores: Optional[Dict[str, Dict[str, float]]] = None

  @property
  def names(self) -> List[str]:
    return [p.name for p in self.posteriors]

  def get_scores(self, recompute: bool = False) -> Dict[str, Dict[str, float]]:
    """``{posterior name: {metric: value}}``."""
    if self._scores is None or recompute:
      scores = {}
      for p in self.posteriors:
        if self.verbose:
          print(f"[results] scoring {p.name}")
        scores[p.name] = p.save_scores()
      self._scores = scores
    return self._scores

  def save_scores(self, path: str) -> str:
    """Write the table as ``<base>.csv`` and ``<base>.html``; returns the
    CSV's path."""
    scores = self.get_scores()
    metrics = list({m: None for row in scores.values() for m in row})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base, _ = os.path.splitext(path)

    def cell(row, m, fmt):
      v = row.get(m)
      return "" if v is None or math.isnan(float(v)) else fmt(float(v))

    with open(base + ".csv", "w", newline="") as f:
      w = csv.writer(f)
      w.writerow([""] + metrics)
      for name, row in scores.items():
        w.writerow([name] + [cell(row, m, repr) for m in metrics])
    head = "".join(f"<th>{html.escape(m)}</th>" for m in metrics)
    body = "".join(
        f"<tr><th>{html.escape(name)}</th>"
        + "".join(f"<td>{cell(row, m, lambda v: f'{v:.4f}') or 'NaN'}</td>"
                  for m in metrics) + "</tr>\n"
        for name, row in scores.items())
    with open(base + ".html", "w") as f:
      f.write(f'<table border="1" class="dataframe">\n<thead><tr><th></th>'
              f"{head}</tr></thead>\n<tbody>\n{body}</tbody>\n</table>\n")
    return base + ".csv"
