"""The port's training-time metric callbacks and imputation scores
(``sisua_tpu_torch.analysis``) against the JAX package's
(``sisua_tpu.analysis``).

* Each callback's ``call`` on JAX and torch distributions built from the
  same parameter arrays, with S = 2 MC draws: the scores within rtol 1e-5
  (float32 log-likelihoods and means summed in another order).
* The NLL through the fused op with the draws as its member axis equals
  the distribution math (rtol 1e-5), and reaches the plain version once,
  with the member axis.
* The imputation and correlation scores, on numpy arrays and on tensors
  (``np.median``'s even-count rule): rtol 1e-6.
* A small CPU fit with the three callbacks writes the same log keys at
  the same epochs as the JAX fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.analysis as JA
import sisua_tpu.dist as JD
import sisua_tpu.models as J
from sisua_tpu.data import generate_synthetic
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainingCallback as JCallback
import sisua_tpu_torch.analysis as TA
import sisua_tpu_torch.dist as TD
from sisua_tpu_torch import models as T
from sisua_tpu_torch.models.objective import mc_row_log_prob
from sisua_tpu_torch.ops import zinb as tz
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import TrainingCallback as TCallback
from torch_port_threads import _one_thread  # noqa: F401


RTOL = 1e-5
S, N, G, P = 2, 40, 24, 6


@pytest.fixture(scope="module")
def sco():
  return generate_synthetic(n_cells=N, n_genes=G, n_proteins=P,
                            n_celltypes=2, seed=3)


def _params(seed, rows, cols, kind):
  """Parameter arrays of one output's distribution: (S, rows, cols) MC
  fields, and a per-gene (1, cols) θ for 'zinbd_gene'."""
  rng = np.random.default_rng(seed)
  f = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)  # noqa
  if kind == "zinbd_gene":
    return dict(log_loc=f(S, rows, cols),
                disp=np.exp(f(1, cols)).astype(np.float32),
                gate=f(S, rows, cols))
  out = dict(total_count=np.exp(f(S, rows, cols)).astype(np.float32),
             logits=f(S, rows, cols))
  if kind == "zinb":
    out["gate"] = f(S, rows, cols)
  return out


def _dist(pkg, p):
  """The same distribution in either package (D = sisua_tpu.dist or
  sisua_tpu_torch.dist)."""
  a = jnp.asarray if pkg is JD else torch.tensor
  if "log_loc" in p:
    count = pkg.NegativeBinomialDispLog(a(p["log_loc"]), a(p["disp"]))
  else:
    count = pkg.NegativeBinomial(a(p["total_count"]), a(p["logits"]))
  if "gate" in p:
    count = pkg.ZeroInflated(count, a(p["gate"]))
  return pkg.Independent(count, 1)


def _outputs(kind):
  """(JAX pX, port pX): a count head over the genes and an 'nb' head over
  the proteins."""
  ps = [_params(0, N, G, kind), _params(1, N, P, "nb")]
  return (tuple(_dist(JD, p) for p in ps), tuple(_dist(TD, p) for p in ps))


def _truth(sco):
  return [np.asarray(sco.numpy(), np.float32),
          np.asarray(sco.numpy("proteomic"), np.float32)]


def _var_names(sco):
  return [list(np.asarray(sco.var_names, str)),
          list(np.asarray(sco.get_var_names("proteomic"), str))]


def _close(got, want):
  assert list(got) == list(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


KINDS = ["zinb", "zinbd_gene", "nb"]


@pytest.mark.parametrize("kind", KINDS)
def test_nll_call_matches_jax(sco, kind):
  jx, tx = _outputs(kind)
  y = _truth(sco)
  want = JA.NegativeLogLikelihood(sco=sco).call(y, jx, None)
  got = TA.NegativeLogLikelihood(data=y).call(y, tx, None)
  assert list(got) == ["nllk", "nllk1"]
  _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_member_axis_nll_equals_distribution_math(sco, kind, monkeypatch):
  """The draws reach the fused op's plain version once, as members: x
  shared (a leading axis of 1), the MC fields with S, a per-gene θ
  shared."""
  _, (dist, _) = _outputs(kind)
  x = torch.tensor(_truth(sco)[0])
  calls = []
  plain = tz._rowsum_ref

  def spy(x, count_raw, logits, gate, constrained):
    calls.append((tuple(x.shape), tuple(count_raw.shape),
                  tuple(logits.shape)))
    return plain(x, count_raw, logits, gate, constrained)
  monkeypatch.setattr(tz, "_rowsum_ref", spy)
  got = mc_row_log_prob(dist, x)
  want = dist.log_prob(x)
  assert got.shape == want.shape == (S, N)
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)
  theta = (1, 1, G) if kind == "zinbd_gene" else (S, N, G)
  assert calls == [((1, N, G), theta, (S, N, G))]


def test_member_axis_nll_without_sample_dims(sco):
  _, (dist, _) = _outputs("zinb")
  one = TD.tree_map(lambda t: t[0], dist)
  x = torch.tensor(_truth(sco)[0])
  np.testing.assert_allclose(mc_row_log_prob(one, x).numpy(),
                             one.log_prob(x).numpy(), rtol=RTOL)
  normal = TD.Independent(TD.Normal(torch.zeros(S, N, G),
                                    torch.ones(S, N, G)), 1)
  np.testing.assert_array_equal(mc_row_log_prob(normal, x).numpy(),
                                normal.log_prob(x).numpy())


@pytest.mark.parametrize("kind", ["zinb", "zinbd_gene"])
def test_imputation_error_call_matches_jax(sco, kind):
  jx, tx = _outputs(kind)
  y = _truth(sco)
  jcb = JA.ImputationError(sco=sco)
  want = jcb.call(y, jx, None)
  tcb = TA.ImputationError(data=y)
  got = tcb.call(y, tx, None)
  assert list(got) == ["med", "mean"]
  _close(got, want)
  # the corrupted matrix is the JAX callback's, bitwise
  np.testing.assert_array_equal(tcb._prepare()[0], jcb._prepare().numpy())
  assert tcb.imputed.shape == (N, G)


def test_correlation_scores_call_matches_jax(sco):
  jx, tx = _outputs("zinb")
  y = _truth(sco)
  want = JA.CorrelationScores(sco=sco).call(y, jx, None)
  got = TA.CorrelationScores(data=y, var_names=_var_names(sco)).call(
      y, tx, None)
  assert list(got) == ["spearman", "pearson"]
  _close(got, want)
  with pytest.raises(ValueError, match="var_names"):
    TA.CorrelationScores(data=y).call(y, tx, None)


@pytest.mark.parametrize("shape", [(30, 24), (31, 23)],
                         ids=["even", "odd"])
def test_imputation_scores_on_arrays_and_tensors(shape):
  """numpy arrays go through numpy, tensors through the sort-based median,
  which must be ``np.median`` for even counts too."""
  from sisua_tpu.analysis import imputation as ji
  rng = np.random.default_rng(shape[1])
  org = rng.poisson(2.0, shape).astype(np.float32)
  cor = org.copy()
  cor[::3, :4] = 0.0
  imp = rng.gamma(2.0, 1.0, shape).astype(np.float32)
  cases = {"imputation_score": (org, imp),
           "imputation_mean_score": (org, cor, imp),
           "imputation_std_score": (org, cor, imp)}
  for name, args in cases.items():
    want = getattr(ji, name)(*args)
    np.testing.assert_allclose(getattr(TA, name)(*args), want, rtol=1e-6,
                               err_msg=name)
    mixed = args[:-1] + (torch.tensor(args[-1]),)
    np.testing.assert_allclose(getattr(TA, name)(*mixed), want, rtol=1e-6,
                               err_msg=name)
  with pytest.raises(ValueError, match="shapes"):
    TA.imputation_score(org, imp[:, :-1])
  assert TA.imputation_mean_score(org, org, imp) == 0.0
  assert TA.imputation_mean_score(org, org, torch.tensor(imp)) == 0.0
  np.testing.assert_array_equal(TA.get_imputed_indices(org, cor),
                                ji.get_imputed_indices(org, cor))
  np.testing.assert_array_equal(
      TA.get_imputed_indices(torch.tensor(org), torch.tensor(cor)),
      ji.get_imputed_indices(org, cor))


def test_correlation_scores_match_jax(sco):
  from sisua_tpu.analysis import imputation as ji
  x, y = _truth(sco)
  genes, prots = _var_names(sco)
  want = ji.correlation_scores(x, y, genes, prots)
  assert want
  for X in (x, torch.tensor(x)):
    got = TA.correlation_scores(X, y, genes, prots)
    assert list(got) == list(want)
    for k in want:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
  series = TA.correlation_scores(torch.tensor(x), torch.tensor(y), genes,
                                 prots, return_series=True)
  for k, (a, b) in ji.correlation_scores(x, y, genes, prots,
                                         return_series=True).items():
    np.testing.assert_array_equal(series[k][0], a)
    np.testing.assert_array_equal(series[k][1], b)
  assert TA.correlation_scores(x, y, ["nope"] * G, prots) == {}


# ------------------------------------------------------------- small fits
_PREFIXES = ("NegativeLogLikelihood", "ImputationError", "CorrelationScores")


def _recorder(base):
  class Recorder(base):
    def __init__(self):
      self.seen = []

    def on_epoch_end(self, epoch, logs):
      self.seen.append((epoch, sorted(k for k in logs
                                      if k.startswith(_PREFIXES))))
  return Recorder()


def test_fit_with_the_three_callbacks_logs_as_jax():
  sco = generate_synthetic(n_cells=240, n_genes=40, n_proteins=6,
                           n_celltypes=3, seed=5218)
  train, test = sco.split(0.75, seed=1)
  small = dict(encoder={"units": [16]}, decoder={"units": [16]})
  jrec = _recorder(JCallback)
  jm = J.VAE(JRV(train.n_vars, "zinb", name="rna"), **small)
  jm.fit(train, epochs=3, batch_size=64, callbacks=[
      JA.NegativeLogLikelihood(sco=test, freq=1),
      JA.ImputationError(sco=test, freq=1),
      JA.CorrelationScores(sco=test, freq=2), jrec])
  data = _truth(test)
  trec = _recorder(TCallback)
  tm = T.VAE(TRV(train.n_vars, "zinb", name="rna"), device="cpu", **small)
  tm.fit(np.asarray(train.numpy(), np.float32), epochs=3, batch_size=64,
         callbacks=[TA.NegativeLogLikelihood(data=data, freq=1),
                    TA.ImputationError(data=data, freq=1),
                    TA.CorrelationScores(data=data,
                                         var_names=_var_names(test),
                                         freq=2), trec])
  assert trec.seen == jrec.seen
  assert any("CorrelationScores_spearman" in keys for _, keys in trec.seen)
  for _, keys in trec.seen:
    for k in keys:
      assert np.isfinite(tm.history[k]).all(), k
