"""ScoreBoard — sqlite-backed experiment score tables (port of
``sisua_tpu/train/scoreboard.py``, without pandas).

One sqlite file per experiment root, with the JAX package's schema:
``scores(tab, uid, metric, value, ts)`` keyed on (tab, uid, metric), and
``errors(uid, message, ts)``. ``read_scores`` returns what the JAX
method's pivoted DataFrame holds, as nested dicts: ``{uid: {metric:
value}}`` for one table, ``{(tab, uid): {…}}`` for all, NaN where a row
lacks a metric another row has, rows and metrics that are NaN throughout
left out (``pivot_table``'s ``dropna``).
"""

from __future__ import annotations

import math
import os
import sqlite3
import time
from typing import Dict, List, Optional

__all__ = ["ScoreBoard"]


class ScoreBoard:

  def __init__(self, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    self.path = path
    self._conn = sqlite3.connect(path)
    self._conn.execute(
        "CREATE TABLE IF NOT EXISTS scores ("
        "  tab TEXT, uid TEXT, metric TEXT, value REAL, ts REAL,"
        "  PRIMARY KEY (tab, uid, metric))")
    self._conn.execute(
        "CREATE TABLE IF NOT EXISTS errors ("
        "  uid TEXT, message TEXT, ts REAL)")
    self._conn.commit()

  def write_scores(self, table: str, unique: str,
                   scores: Dict[str, float], replace: bool = True) -> None:
    now = time.time()
    op = "INSERT OR REPLACE" if replace else "INSERT OR IGNORE"
    rows = []
    for k, v in scores.items():
      try:
        rows.append((table, unique, str(k), float(v), now))
      except (TypeError, ValueError):
        rows.append((table, unique, str(k), float("nan"), now))
    self._conn.executemany(
        f"{op} INTO scores (tab, uid, metric, value, ts) "
        "VALUES (?, ?, ?, ?, ?)", rows)
    self._conn.commit()

  def write_error(self, unique: str, message: str) -> None:
    self._conn.execute("INSERT INTO errors (uid, message, ts) VALUES (?,?,?)",
                       (unique, message, time.time()))
    self._conn.commit()

  def read_scores(self, table: Optional[str] = None) -> Dict:
    """``{uid: {metric: value}}`` of one table; with ``table=None``
    ``{(tab, uid): {metric: value}}``, so same-named metrics of different
    dataset tables stay apart."""
    q = "SELECT tab, uid, metric, value FROM scores"
    params: tuple = ()
    if table is not None:
      q += " WHERE tab = ?"
      params = (table,)
    cells: Dict = {}
    for tab, uid, metric, value in self._conn.execute(q, params):
      key = uid if table is not None else (tab, uid)
      # sqlite stores a NaN REAL as NULL
      cells.setdefault(key, {})[metric] = (math.nan if value is None
                                           else float(value))
    rows = {k: v for k, v in cells.items()
            if any(not math.isnan(x) for x in v.values())}
    metrics = sorted({m for v in rows.values() for m, x in v.items()
                      if not math.isnan(x)})
    return {k: {m: rows[k].get(m, math.nan) for m in metrics}
            for k in sorted(rows)}

  def read_errors(self) -> List[Dict]:
    """Every error row as ``{'uid', 'message', 'ts'}``."""
    cur = self._conn.execute("SELECT uid, message, ts FROM errors")
    return [dict(uid=u, message=m, ts=t) for u, m, t in cur.fetchall()]

  @property
  def tables(self) -> List[str]:
    cur = self._conn.execute("SELECT DISTINCT tab FROM scores")
    return [r[0] for r in cur.fetchall()]

  def close(self):
    self._conn.close()
