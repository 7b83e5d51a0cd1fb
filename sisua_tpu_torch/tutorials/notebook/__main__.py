"""Run the notebook's code cells in order (see the package docstring)."""

from .._common import run_cli
from . import __doc__ as doc, main

if __name__ == "__main__":
  run_cli(main, doc)
