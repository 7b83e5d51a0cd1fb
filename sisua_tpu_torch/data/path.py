"""Filesystem layout, overridable by environment variables (copy of
``sisua_tpu/data/path.py``):

  SISUA_DATA     → DATA_DIR     (default ~/bio_data)   preprocessed datasets
  SISUA_DOWNLOAD → DOWNLOAD_DIR (default DATA_DIR/downloads)
  SISUA_EXP      → EXP_DIR      (default ~/bio_exp)    experiment results
  SISUA_CFG      → CONFIG_PATH  (default configs/base.yaml in the repo)

Unlike the JAX module, importing this one creates no directory: the
experimenter makes its ``save_path`` when it is built.
"""

from __future__ import annotations

import os
from os.path import abspath, dirname, expanduser, isfile, join

__all__ = ["DATA_DIR", "DOWNLOAD_DIR", "EXP_DIR", "CONFIG_PATH"]


def _dir_from_env(var: str, default: str) -> str:
  path = os.environ.get(var, default)
  if isfile(path):
    raise RuntimeError(f"Path at '{path}' ({var}) must be a folder")
  return path


DATA_DIR = _dir_from_env("SISUA_DATA", join(expanduser("~"), "bio_data"))
DOWNLOAD_DIR = _dir_from_env("SISUA_DOWNLOAD", join(DATA_DIR, "downloads"))
EXP_DIR = _dir_from_env("SISUA_EXP", join(expanduser("~"), "bio_exp"))

if "SISUA_CFG" in os.environ:
  CONFIG_PATH = abspath(os.environ["SISUA_CFG"])
else:
  CONFIG_PATH = abspath(join(dirname(__file__), "..", "..", "configs",
                             "base.yaml"))
