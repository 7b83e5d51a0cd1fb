"""The classical baselines (``sisua_tpu_torch/baselines.py``) and the
sklearn decompositions behind them (``analysis/decomposition.py``,
``analysis/lars.py``, ``native/lars.cpp``) against sklearn and the JAX
package, on the CPU (``device='cpu'``), at 200 × 40 log counts.

Tolerances, each of a column's range unless said otherwise:

  * ``randomized_svd`` and ``PCA(svd_solver='full')``: float64 1e-10,
    float32 1e-4 (LAPACK's and torch's float32 SVDs);
  * ``FactorAnalysis``: float64 rtol 1e-8 (it computes in float64 for a
    float32 input too, so both dtypes);
  * ``NMF``: float64 1e-6 and float32 1e-3 (each sweep is one tensor
    operation over rows, its violation summed in another order);
  * ``SparsePCA``: float64 1e-8. In float32, one iteration of dictionary
    learning (``tol=0``) within 1e-4 (measured 3.3e-5). Later the float32
    LARS paths take rounding-level different steps (BLAS's sums against
    the C++ loop's), and a variable that enters at its threshold in one
    and not the other moves a component's entry by 1.1e-3 at the third
    iteration. The default fit stops when the cost drops by less than
    1e-8 of itself, compared in float32, a test that rounding decides: on
    the first 120 rows here sklearn stops after 115 iterations, the port
    after 126 (latents 7.8e-3 apart), sklearn on the same rows reordered
    after 116; on ``run_baseline``'s set sklearn stops after 171, after
    192 reordered (its own latents 1.4e-2 apart), the port after 190
    (1.3e-2 from sklearn). The default is held at 2e-2 (ROADMAP A24);
  * the LARS-Lasso path against ``lars_path_gram``: float64 rtol 1e-10,
    with variables dropping out of the active set on the way;
  * ``run_baseline`` against the JAX ``run_baseline`` on one
    ``SingleCellOMIC`` pair from one seed: the score keys equal; the
    latents as above (PCA/PPCA float32 1e-4, NMF 1e-3, FA 1e-8, SPPCA
    2e-2); the scores within 1e-4 for PCA, PPCA and NMF (NMF's ASW
    measured 1.2e-6 apart) and 1e-12 for FA, whose latents agree to
    float64 rounding.
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn import decomposition as SD
from sklearn.linear_model import lars_path_gram as sk_lars_path_gram
from sklearn.utils.extmath import randomized_svd as sk_randomized_svd

from sisua_tpu_torch import native
from sisua_tpu_torch.analysis import decomposition as TD
from sisua_tpu_torch.analysis.lars import lars_path_gram

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  """One torch and one BLAS thread: the tier runs several test processes
  on the machine's cores."""
  from threadpoolctl import threadpool_limits
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(1), warnings.catch_warnings():
    warnings.simplefilter("ignore")   # sklearn's ConvergenceWarnings
    yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def counts():
  rng = np.random.RandomState(0)
  lam = rng.gamma(0.5, 2.0, (200, 40)) * rng.uniform(0.2, 2, (200, 1))
  return np.log1p(rng.poisson(lam)).astype(np.float64)


def _cols(got, want, tol):
  """|got − want| ≤ tol · each column's largest |want|."""
  got = np.asarray(got.detach().cpu() if hasattr(got, "detach") else got,
                   np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape
  bound = tol * np.abs(want).max(0, keepdims=True)
  worst = np.max(np.abs(got - want) / np.maximum(bound, 1e-300)) * tol
  assert np.all(np.abs(got - want) <= bound), f"worst {worst:.3e} > {tol}"


def _tol(dtype, f64, f32):
  return f64 if dtype == np.float64 else f32


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kw", [
    {}, {"n_iter": 2}, {"power_iteration_normalizer": "QR"},
    {"transpose": True}, {"n_oversamples": 4}])
def test_randomized_svd_as_sklearn(counts, dtype, kw):
  X = counts.astype(dtype)
  U, s, Vt = sk_randomized_svd(X, 5, random_state=3, **kw)
  u, s2, vt = TD.randomized_svd(torch.as_tensor(X), 5, random_state=3, **kw)
  assert u.dtype == torch.as_tensor(X).dtype
  tol = _tol(dtype, 1e-10, 1e-4)
  _cols(u, U, tol)
  _cols(vt.T, Vt.T, tol)
  np.testing.assert_allclose(s2.numpy(), s, rtol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pca_full_solver_as_sklearn(counts, dtype):
  X = counts.astype(dtype)
  sk = SD.PCA(10, svd_solver="full", random_state=8).fit(X)
  port = TD.PCA(10, svd_solver="full", random_state=8, device=CPU).fit(X)
  assert port.svd_solver_ == "full"
  tol = _tol(dtype, 1e-10, 1e-4)
  _cols(port.components_.T, sk.components_.T, tol)
  _cols(port.transform(X), sk.transform(X), tol)
  np.testing.assert_allclose(port.explained_variance_.numpy(),
                             sk.explained_variance_, rtol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_components", [10, 3])
def test_factor_analysis_as_sklearn(counts, dtype, n_components):
  X = counts.astype(dtype)
  sk = SD.FactorAnalysis(n_components, random_state=8).fit(X)
  port = TD.FactorAnalysis(n_components, random_state=8, device=CPU).fit(X)
  assert port.components_.dtype == torch.float64
  assert port.n_iter_ == sk.n_iter_
  np.testing.assert_allclose(port.loglike_, sk.loglike_, rtol=1e-8)
  _cols(port.components_.T, sk.components_.T, 1e-8)
  np.testing.assert_allclose(port.noise_variance_.numpy(),
                             sk.noise_variance_, rtol=1e-8)
  np.testing.assert_allclose(port.mean_.numpy(), sk.mean_, rtol=1e-8)
  _cols(port.transform(X), sk.transform(X), 1e-8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nmf_as_sklearn(counts, dtype):
  X = counts.astype(dtype)
  sk = SD.NMF(10, init="nndsvda", max_iter=400, random_state=8).fit(X)
  port = TD.NMF(10, init="nndsvda", max_iter=400, random_state=8,
                device=CPU).fit(X)
  tol = _tol(dtype, 1e-6, 1e-3)
  assert port.components_.dtype == torch.as_tensor(X).dtype
  assert port.n_iter_ == sk.n_iter_
  _cols(port.components_.T, sk.components_.T, tol)
  _cols(port.transform(X), sk.transform(X), tol)
  np.testing.assert_allclose(port.reconstruction_err_,
                             sk.reconstruction_err_, rtol=tol)
  with pytest.raises(ValueError, match="Negative"):
    TD.NMF(3, device=CPU).fit(X - 1.0)


@pytest.mark.parametrize("dtype,max_iter,tol", [
    (np.float64, 1000, 1e-8),   # the defaults, to convergence
    (np.float32, 1, 1e-4),      # one iteration, tol 0
    (np.float32, 1000, 2e-2),   # the defaults: see the module docstring
])
def test_sparse_pca_as_sklearn(counts, dtype, max_iter, tol):
  X = counts[:120].astype(dtype)
  kw = dict(random_state=8, max_iter=max_iter,
            tol=0.0 if max_iter == 1 else 1e-8)
  sk = SD.SparsePCA(10, **kw).fit(X)
  port = TD.SparsePCA(10, device=CPU, num_threads=1, **kw).fit(X)
  assert port.components_.dtype == torch.as_tensor(X).dtype
  if dtype == np.float64:
    assert port.n_iter_ == sk.n_iter_
    np.testing.assert_allclose(port.error_, sk.error_, rtol=1e-8)
  _cols(port.components_.T, sk.components_.T, tol)
  _cols(port.transform(X), sk.transform(X), tol)


def _lars_problem(seed):
  rng = np.random.RandomState(seed)
  n, k = 50, 10
  D = rng.normal(size=(n, k)) @ (np.eye(k) + 0.6 * rng.normal(size=(k, k)))
  y = rng.normal(size=n)
  return D.T @ y, D.T @ D, n, 1e-3 * rng.uniform()


@pytest.mark.parametrize("seed", range(8))
def test_lars_path_as_sklearn(seed):
  Xy, G, n, alpha_min = _lars_problem(seed)
  alpha, active, coef, n_iter = sk_lars_path_gram(
      Xy, G, n_samples=n, alpha_min=alpha_min, method="lasso",
      return_path=False, return_n_iter=True)
  a2, act2, c2, it2 = lars_path_gram(Xy, G, n_samples=n,
                                     alpha_min=alpha_min)
  # more steps than active variables: some variables dropped out
  assert it2 == n_iter > len(active)
  assert act2 == list(active)
  np.testing.assert_allclose(a2, alpha, rtol=1e-10)
  np.testing.assert_allclose(c2, coef, rtol=0,
                             atol=1e-10 * np.abs(coef).max())


def test_sparse_encode_is_lasso_lars_per_row(counts):
  """``sparse_encode`` codes each row with sklearn's LassoLars (alpha
  over the features), batched on the host with OpenMP."""
  X = counts[:60] - counts[:60].mean(0)
  D = np.linalg.svd(X, full_matrices=False)[2][:6] * 3.0
  want = SD.sparse_encode(X, D, algorithm="lasso_lars", alpha=1.0)
  got = TD.sparse_encode(torch.as_tensor(X), torch.as_tensor(D), 1.0,
                         num_threads=3)
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=1e-10 * np.abs(want).max())


@pytest.fixture(scope="module")
def sco_pair():
  from sisua_tpu.data import generate_synthetic as jgen
  from sisua_tpu_torch.data import generate_synthetic as tgen
  kw = dict(n_cells=200, n_genes=40, n_proteins=4, n_celltypes=3,
            seed=5218)
  return jgen(**kw), tgen(**kw)


_LATENT_TOL = {"pca": 1e-4, "ppca": 1e-4, "nmf": 1e-3, "fa": 1e-8,
               "sppca": 2e-2}


@pytest.mark.parametrize("model", ["pca", "ppca", "sppca", "nmf", "fa"])
def test_run_baseline_as_jax(sco_pair, model):
  import sisua_tpu.baselines as JB
  import sisua_tpu_torch.baselines as TB
  assert TB.BASELINE_MODELS == JB.BASELINE_MODELS
  j, t = sco_pair
  np.testing.assert_array_equal(t.numpy(), j.numpy())
  want = JB.run_baseline(j, model)
  got = TB.run_baseline(t, model, device=CPU)
  assert list(got) == list(want)
  assert {"ARI_celltype", "f1_F1micro"} <= set(got)
  x = np.log1p(t.numpy())
  zj = JB._fit_latent(x, model, 10, 8).transform(x)
  zt = TB._fit_latent(x, model, 10, 8, device=CPU).transform(x)
  _cols(zt, zj, _LATENT_TOL[model])
  if model != "sppca":
    tol = 1e-12 if model == "fa" else 1e-4
    for k in want:
      assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_baselines_main_runs_on_the_cpu(capsys):
  import sisua_tpu_torch.baselines as TB
  out = TB.main(["-ds", "synthetic200", "-model", "pca,fa", "-zdim", "4",
                 "--device", CPU])
  assert set(out) == {"pca", "fa"}
  assert all(np.isfinite(list(v.values())).all() for v in out.values())
  with pytest.raises(ValueError, match="unknown baseline"):
    TB.run_baseline(_small_sco(), "ica", device=CPU)


def _small_sco():
  from sisua_tpu_torch.data import generate_synthetic
  return generate_synthetic(n_cells=50, n_genes=10, n_proteins=2,
                            n_celltypes=2)


@pytest.mark.parametrize("make", [
    lambda: TD.FactorAnalysis(2), lambda: TD.NMF(2),
    lambda: TD.SparsePCA(2), lambda: TD.PCA(2, svd_solver="full")])
def test_estimators_default_to_cuda(counts, make):
  if torch.cuda.is_available():
    pytest.skip("a card is present: 'cuda' is a valid default")
  with pytest.raises(RuntimeError, match="device='cuda'"):
    make().fit(counts)


def test_failed_native_build_raises(tmp_path, monkeypatch):
  bad = tmp_path / "broken.cpp"
  bad.write_text("this is not C++\n")
  monkeypatch.setitem(native._LIBRARIES, "broken",
                      (str(bad), native._FLAGS, "libsisua_broken"))
  monkeypatch.setitem(native._SIGNATURES, "broken", {})
  with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
    native.load("broken")
  assert not native.library_path("broken").exists()
