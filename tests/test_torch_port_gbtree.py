"""The boosted trees' and the forest's tree builder in C++
(``native/gbtree.cpp``, through ``analysis.estimators._build_tree``)
against its plain reference, the numpy ``_TreeBuilder``: every node's
feature, threshold, children, impurity, weight and value, and every row's
leaf, bit for bit. The inputs cover continuous values, ties (sklearn's
restarted sums), constant features, bootstrap weights (zero-weight rows)
and depths 1 to unbounded; ``test_torch_port_estimators`` holds both
estimators to sklearn.
"""

import numpy as np
import pytest

from sisua_tpu_torch.analysis import estimators as E

from torch_port_threads import _one_thread  # noqa: F401

KINDS = ("normal", "ties", "rounded", "constant")
DEPTHS = (1, 3, 6, int(np.iinfo(np.int32).max))


def _case(kind, seed):
  rng = np.random.default_rng(seed)
  n, d = int(rng.integers(2, 260)), int(rng.integers(1, 11))
  if kind == "normal":
    X = rng.normal(size=(n, d))
  elif kind == "ties":
    X = rng.integers(0, 3, size=(n, d)).astype(float)
  elif kind == "rounded":
    X = np.round(rng.normal(size=(n, d)), 1)
  else:
    X = rng.normal(size=(n, d))
    X[:, :d // 2 + 1] = 1.0
  y = rng.normal(size=n) if seed % 2 else (rng.random(n) > 0.5) * 1.0
  return X.astype(np.float32), y, rng


def _fields(tree):
  return [np.asarray(getattr(tree, k)) for k in (
      "feature", "threshold", "left", "right", "impurity", "n_samples",
      "value")]


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "bootstrap"])
@pytest.mark.parametrize("depth", DEPTHS, ids=lambda d: f"depth{min(d, 99)}")
@pytest.mark.parametrize("kind", KINDS)
def test_native_tree_is_the_reference_bit_for_bit(kind, depth, weighted):
  for seed in range(12):
    X32, y, rng = _case(kind, seed)
    n = len(y)
    w = (np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
         if weighted else None)
    order = np.argsort(X32, axis=0, kind="stable").T.copy()
    split_seed = int(rng.integers(0, E._RAND_R_MAX))
    ref, ref_leaf = E._TreeBuilder(X32, order, depth, split_seed,
                                   weights=w).build(y)
    got, got_leaf = E._build_tree(X32, order, depth, split_seed, y,
                                  weights=w)
    np.testing.assert_array_equal(got_leaf, ref_leaf)
    for a, b in zip(_fields(got), _fields(ref)):
      assert a.shape == b.shape
      np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_boosted_trees_fit_as_the_reference(monkeypatch):
  """A whole boosted fit (5 classes, 30 stages at depth 3, the DCI's
  configuration): the same importances and predictions as the reference
  builder's."""
  rng = np.random.default_rng(7)
  X = rng.normal(size=(400, 10)).astype(np.float32)
  y = rng.integers(0, 5, 400)
  fast = E.GradientBoostingClassifier(30, 3, random_state=8).fit(X, y)
  monkeypatch.setattr(E, "_build_tree", lambda X32, order, depth, seed, y,
                      weights=None: E._TreeBuilder(
                          X32, order, depth, seed, weights=weights).build(y))
  ref = E.GradientBoostingClassifier(30, 3, random_state=8).fit(X, y)
  np.testing.assert_array_equal(fast.feature_importances_,
                                ref.feature_importances_)
  np.testing.assert_array_equal(fast.decision_function(X),
                                ref.decision_function(X))


def test_native_tree_refuses_mismatched_buffers():
  """The library reads through raw pointers: a wrong shape or row index
  raises before the call."""
  X32, y, _ = _case("normal", 1)
  order = np.argsort(X32, axis=0, kind="stable").T.copy()
  with pytest.raises(ValueError):
    E._build_tree(X32, order[:, :-1], 3, 0, y)
  with pytest.raises(ValueError):
    E._build_tree(X32, order, 3, 0, y[:-1])
  bad = order.copy()
  bad[0, 0] = len(y)
  with pytest.raises(IndexError):
    E._build_tree(X32, bad, 3, 0, y)
