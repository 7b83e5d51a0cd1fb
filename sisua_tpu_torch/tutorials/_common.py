"""What the tutorials share: the device, the output folder, the depth
constants, the figures' two steps and the command line."""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Optional


def device_of(device) -> str:
  """The card unless the caller names another device."""
  return "cuda" if device is None else str(device)


def out_dir_of(out_dir: Optional[str], name: str) -> str:
  """``<out_dir>/<name>``, or a new temporary folder."""
  if out_dir is None:
    return tempfile.mkdtemp(prefix=f"sisua_tutorial_{name}_")
  path = os.path.join(out_dir, name)
  os.makedirs(path, exist_ok=True)
  return path


def at_depth(value: int, depth: Optional[int], least: int = 1) -> int:
  """A depth constant (epochs, evaluations, draws, runs): the tutorial's
  own ``value`` at ``depth=None``, else ``value`` cut to ``depth`` and
  never below ``least``. Widths are never depth constants."""
  if depth is None:
    return value
  return max(least, min(value, int(depth)))


def draw(sink, battery: Callable[[], object], path: str,
         figures: bool) -> int:
  """Run ``battery``, figure methods of ``sink``. With ``figures`` they
  render with matplotlib into ``path`` (the port raises an ImportError
  naming matplotlib where it is absent); else only their data steps run
  (``figure_data``). Returns the number of figures."""
  if figures:
    battery()
    n = len(sink.figures)
    sink.save_figures(path)
    return n
  with sink.figure_data() as data:
    battery()
  return len(data)


def parser(doc: str) -> argparse.ArgumentParser:
  """The tutorials' command line: ``--device`` (default 'cuda'),
  ``--out``, ``--depth`` and ``--figures``."""
  p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default) or 'cpu'")
  p.add_argument("--out", default=None,
                 help="folder for what the tutorial writes (default: a new "
                      "temporary folder)")
  p.add_argument("--depth", type=int, default=None,
                 help="cut the tutorial's epochs, evaluations, draws and "
                      "runs to this many (default: the tutorial's own)")
  p.add_argument("--figures", action="store_true",
                 help="render the figures (needs matplotlib)")
  return p


def run_cli(main: Callable, doc: str):
  a = parser(doc).parse_args()
  main(device=a.device, out_dir=a.out, depth=a.depth, figures=a.figures)


def first(d):
  """The first entry of a list of outputs or latents, or the one given."""
  return d[0] if isinstance(d, (list, tuple)) else d


def host(t):
  """A tensor (or array) as a numpy array on the host."""
  import numpy as np
  if hasattr(t, "detach"):
    t = t.detach().cpu()
    return (t.float() if t.dtype.is_floating_point else t).numpy()
  return np.asarray(t)
