"""SingleCellOMIC: the port's multi-omic container (port of
``sisua_tpu/data/dataset.py``), the last class of the chain that
``data/core.py`` starts: it adds the deterministic ``split``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .const import UNIVERSAL_RANDOM_SEED
from .visualizer import _OMICvisualizer

__all__ = ["SingleCellOMIC"]


class SingleCellOMIC(_OMICvisualizer):
  """Multi-omic single-cell dataset (see ``data/core.py``)."""

  def split(self, train_percent: float = 0.8,
            seed: int = UNIVERSAL_RANDOM_SEED
            ) -> Tuple["SingleCellOMIC", "SingleCellOMIC"]:
    """Train/test split by a seeded permutation (the JAX container's)."""
    if not 0.0 < train_percent < 1.0:
      raise ValueError(f"train_percent must be in (0, 1), given "
                       f"{train_percent}")
    n = self.n_obs
    ids = np.random.RandomState(seed).permutation(n)
    n_train = int(np.ceil(train_percent * n))
    train = self[ids[:n_train]]
    test = self[ids[n_train:]]
    train._name = f"{self._name}_train"
    test._name = f"{self._name}_test"
    return train, test
