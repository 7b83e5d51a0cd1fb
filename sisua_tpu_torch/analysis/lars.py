"""The LARS-Lasso path on a Gram matrix: sklearn's ``lars_path_gram`` in
'lasso' mode, which ``LassoLars`` runs inside ``sparse_encode`` (and so
inside ``SparsePCA``'s dictionary learning), one small path per target.

The paths run in C++ on the host (``native/lars.cpp``, OpenMP over the
targets), not batched on the card. A path is a sequence of data-dependent
branches: which variable enters, whether a coefficient crosses zero and
leaves (a Cholesky downdate and a recomputed correlation), whether a
regressor is degenerate and dropped for good, when alpha stops falling;
sklearn also swaps the Gram's rows and columns as variables enter and
leave and keeps the permutation's quirks. Batched over targets with
per-row active masks, every step would run every branch for every row
and its permuted Gram, and paths that branch differently would need
separate factor updates: the batch would be as long as its longest path
and mostly masked work, for paths of at most ``n_components`` (≤ ~10)
variables. One sequential path per target in C++ follows sklearn step by
step instead; the Gram and the correlations come from the card, and the
codes go back to it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["lars_path_gram", "lasso_lars_gram"]

_EPS = float(np.finfo(float).eps)


def lasso_lars_gram(gram, xy, n_samples: int, alpha_min: float,
                    max_iter: int = 500, eps: float = _EPS,
                    num_threads: Optional[int] = None) -> np.ndarray:
  """The final coefficients (n_targets, k) of sklearn's LARS-Lasso path of
  each row of ``xy`` (n_targets, k) on ``gram`` (k, k), stopped at
  ``alpha_min``, in their dtype: what ``LassoLars(alpha_min,
  fit_intercept=False, precompute=gram, fit_path=False)`` fits."""
  from ..native import lars_lasso_gram as native_lars
  return native_lars(gram, xy, n_samples, alpha_min, max_iter, eps,
                     num_threads)[0]


def lars_path_gram(Xy, Gram, *, n_samples: int, max_iter: int = 500,
                   alpha_min: float = 0.0, method: str = "lasso",
                   eps: float = _EPS, num_threads: Optional[int] = 1):
  """sklearn's ``lars_path_gram(Xy, Gram, n_samples, method='lasso',
  return_path=False, return_n_iter=True)`` of one target: ``(alpha,
  active, coef, n_iter)``, alpha as a 1-element array, ``active`` the
  list of the variables in the final active set."""
  if method != "lasso":
    raise ValueError(f"method={method!r}: only 'lasso' is ported")
  from ..native import lars_lasso_gram as native_lars
  Xy = np.asarray(Xy)
  coef, alpha, n_iter, active = native_lars(Gram, Xy[None, :], n_samples,
                                            alpha_min, max_iter, eps,
                                            num_threads)
  return (alpha[:1], [int(a) for a in active[0] if a >= 0], coef[0],
          int(n_iter[0]))
