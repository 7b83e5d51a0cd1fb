"""The port's distributions, RV specs, schedules and library stats against
the JAX package, on the same numpy inputs (CPU, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu_torch.dist as TD
from sisua_tpu import interpolation as jinterp
from sisua_tpu import rv as jrv
from sisua_tpu.data.utils import get_library_size as j_library_size
from sisua_tpu_torch import interpolation as tinterp
from sisua_tpu_torch import rv as trv
from sisua_tpu_torch.data import get_library_size as t_library_size
from torch_port_threads import _one_thread  # noqa: F401


# log-probs are compared elementwise with rtol 1e-5 on top of an atol of
# 1e-5·max|ref|: XLA's lgamma and libm's lgammaf differ by a few float32
# ulps, and at x ~ 1e6 one ulp of lgamma(x) ~ 1.3e7 is ~1
RTOL = 1e-5


def _close(t, j, rtol=RTOL, atol_frac=1e-5, err_msg=""):
  t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
  j = np.asarray(j)
  assert t.shape == j.shape, (t.shape, j.shape)
  np.testing.assert_allclose(t, j, rtol=rtol,
                             atol=atol_frac * max(np.abs(j).max(), 1e-30),
                             err_msg=err_msg)


def _both(*arrays):
  return ([jnp.asarray(a) for a in arrays],
          [torch.tensor(np.asarray(a)) for a in arrays])


def _counts(seed, shape=(8, 16), extreme=True):
  rng = np.random.default_rng(seed)
  x = rng.poisson(3.0, shape).astype(np.float32)
  x[:, :4] = 0.0
  if extreme:
    x[:, -1] = 1e6
  return rng, x


def test_normal_log_prob_and_kl():
  rng = np.random.default_rng(0)
  loc, z = rng.normal(0, 1, (2, 8, 4)).astype(np.float32)
  scale = rng.gamma(2, 0.5, (8, 4)).astype(np.float32)
  (jl, js, jz), (tl, ts, tz) = _both(loc, scale, z)
  _close(TD.Normal(tl, ts).log_prob(tz), JD.Normal(jl, js).log_prob(jz))
  prior = (TD.Normal(tl * 0.5, ts * 2.0), JD.Normal(jl * 0.5, js * 2.0))
  _close(TD.kl_divergence(TD.Normal(tl, ts), prior[0]),
         JD.kl_divergence(JD.Normal(jl, js), prior[1]))
  # Independent sums the event dim; KL of matched Independents too
  _close(TD.Independent(TD.Normal(tl, ts), 1).log_prob(tz),
         JD.Independent(JD.Normal(jl, js), 1).log_prob(jz))
  _close(TD.kl_divergence(TD.Independent(TD.Normal(tl, ts), 1),
                          TD.Independent(prior[0], 1)),
         JD.kl_divergence(JD.Independent(JD.Normal(jl, js), 1),
                          JD.Independent(prior[1], 1)))


def test_mvndiag_log_prob_kl_and_given_noise():
  rng = np.random.default_rng(1)
  loc, z, eps = rng.normal(0, 1, (3, 8, 5)).astype(np.float32)
  scale = rng.gamma(2, 0.5, (8, 5)).astype(np.float32)
  (jl, js, jz), (tl, ts, tz) = _both(loc, scale, z)
  tq, jq = TD.MultivariateNormalDiag(tl, ts), JD.MultivariateNormalDiag(jl, js)
  _close(tq.log_prob(tz), jq.log_prob(jz))
  tp = TD.MultivariateNormalDiag(torch.zeros(5), torch.ones(5))
  jp = JD.MultivariateNormalDiag(jnp.zeros(5), jnp.ones(5))
  _close(TD.kl_divergence(tq, tp), JD.kl_divergence(jq, jp))
  assert tq.batch_shape == jq.batch_shape == (8,)
  # rsample with given noise is loc + scale·eps exactly
  s = tq.rsample(eps=torch.tensor(eps))
  np.testing.assert_array_equal(s.numpy(), loc + scale * eps)
  # drawn noise follows the generator: same seed, same draw
  g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
  assert torch.equal(tq.rsample((2,), generator=g1),
                     tq.rsample((2,), generator=g2))
  with pytest.raises(TD.NoAnalyticKL):
    TD.kl_divergence(tq, TD.Normal(torch.zeros(5), torch.ones(5)))


def _nb_pairs(kind, seed, per_gene=False, extreme=True):
  """(port dist, JAX dist, x) for one NB parameterization."""
  rng, x = _counts(seed, extreme=extreme)
  shape = (1, 16) if per_gene else (8, 16)
  mu = rng.gamma(2.0, 2.0, (8, 16)).astype(np.float32)
  th = rng.gamma(3.0, 1.0, shape).astype(np.float32)
  if extreme:  # tiny and huge dispersions, both sides of the 1e6 switch
    th[..., 4] = 1e-8
    th[..., 5] = 2e6
    th[..., 6] = 1e8
  logits = rng.normal(0, 2, (8, 16)).astype(np.float32)
  if kind == "logits":
    (a, b), (c, d) = _both(th, logits)
    return (TD.NegativeBinomial(c, d), JD.NegativeBinomial(a, b), x)
  if kind == "disp":
    (a, b), (c, d) = _both(mu, th)
    return (TD.NegativeBinomialDisp(c, d), JD.NegativeBinomialDisp(a, b), x)
  if kind == "displog":
    (a, b), (c, d) = _both(np.log(mu), th)
    return (TD.NegativeBinomialDispLog(c, d),
            JD.NegativeBinomialDispLog(a, b), x)
  log_th = np.log(th)
  log_th[..., 7] = 20.0  # beyond the ±15 clip: θ and logits share it
  (a, b), (c, d) = _both(np.log(mu), log_th)
  return TD.NegativeBinomialLog(c, d), JD.NegativeBinomialLog(a, b), x


NB_KINDS = ["logits", "disp", "displog", "loglog"]


@pytest.mark.parametrize("per_gene", [False, True], ids=["BD", "per_gene"])
@pytest.mark.parametrize("kind", NB_KINDS)
def test_nb_log_prob(kind, per_gene):
  tnb, jnb, x = _nb_pairs(kind, seed=NB_KINDS.index(kind), per_gene=per_gene)
  lp = tnb.log_prob(torch.tensor(x))
  assert torch.isfinite(lp).all()
  _close(lp, jnb.log_prob(jnp.asarray(x)), err_msg=kind)
  _close(tnb.mean(), jnb.mean(), err_msg=kind)


@pytest.mark.parametrize("kind", NB_KINDS)
def test_zero_inflated_log_prob_and_gradients(kind):
  """ZeroInflated over each NB kind, including the −1e30 no-inflation gate
  on one column, and the gradient wrt the gate logits."""
  tnb, jnb, x = _nb_pairs(kind, seed=10 + NB_KINDS.index(kind),
                          extreme=False)
  gate = np.random.default_rng(5).normal(0, 1, (8, 16)).astype(np.float32)
  gate[:, 3] = -1e30
  tg = torch.tensor(gate, requires_grad=True)
  tzi = TD.ZeroInflated(tnb, tg)
  jzi = JD.ZeroInflated(jnb, jnp.asarray(gate))
  assert tzi.count_distribution is tnb
  tlp = TD.Independent(tzi, 1).log_prob(torch.tensor(x))
  jlp = JD.Independent(jzi, 1).log_prob(jnp.asarray(x))
  _close(tlp, jlp, err_msg=kind)
  tlp.sum().backward()
  jg = jax.grad(lambda g: JD.Independent(JD.ZeroInflated(jnb, g), 1)
                .log_prob(jnp.asarray(x)).sum())(jnp.asarray(gate))
  # gradient tolerance 1e-4: sigmoid/softplus forms differ by ulps
  _close(tg.grad, jg, rtol=1e-4, err_msg=kind)
  _close(tzi.mean(), jzi.mean(), err_msg=kind)


_COUNT_POSTERIORS = ("zinbd", "nbd", "zinb", "nb", "poisson", "zip", "mixnb")
# RV kwargs of the cases that carry some, by (posterior, dim)
_RV_KWARGS = {("mdn", 5): {"n_components": 3},
              ("mixnb", 13): {"zero_inflated": True, "n_components": 3},
              ("nzmse", 13): {"log_space": False, "activation": "linear"}}


def _rv_target(posterior, rng, dim):
  if posterior in _COUNT_POSTERIORS:
    return rng.poisson(2.0, (8, dim)).astype(np.float32)
  if posterior == "nzmse":  # counts with dropout zeros, one all-zero row
    x = (rng.poisson(2.0, (8, dim)) * (rng.uniform(size=(8, dim)) > 0.4))
    x[3] = 0
    return x.astype(np.float32)
  if posterior == "onehot":
    return np.eye(dim, dtype=np.float32)[rng.integers(0, dim, 8)]
  if posterior == "bernoulli":
    return (rng.uniform(size=(8, dim)) < 0.3).astype(np.float32)
  return rng.normal(0, 1, (8, dim)).astype(np.float32)


@pytest.mark.parametrize("posterior,dim", [
    ("diag", 6), ("normal", 1), ("zinbd", 12), ("nbd", 12), ("zinb", 12),
    ("nb", 12), ("poisson", 12), ("zip", 12), ("onehot", 5),
    ("bernoulli", 5), ("mse", 6), ("relu", 6), ("mixgaus", 4), ("mdn", 5),
    ("mixnb", 12), ("mixnb", 13), ("nzmse", 12), ("nzmse", 13)])
def test_rv_specs_and_priors(posterior, dim):
  """RVmeta builds the same distribution from the same raw head output,
  with exp(clip ±15) positives and softplus + 1e-4 scales."""
  kwargs = _RV_KWARGS.get((posterior, dim), {})
  t_meta = trv.RVmeta(dim, posterior, name="v", kwargs=kwargs)
  j_meta = jrv.RVmeta(dim, posterior, name="v", kwargs=kwargs)
  assert t_meta.n_params == j_meta.n_params
  assert t_meta.kwargs == j_meta.kwargs
  for prop in ("is_zero_inflated", "is_deterministic", "is_binary"):
    assert getattr(t_meta, prop) == getattr(j_meta, prop), prop
  rng = np.random.default_rng(dim)
  raw = rng.normal(0, 3, (8, t_meta.n_params)).astype(np.float32)
  raw[0, :2] = [-40.0, 40.0]  # through both clip edges
  x = _rv_target(posterior, rng, dim)
  td = t_meta.create_distribution(torch.tensor(raw))
  jd = j_meta.create_distribution(jnp.asarray(raw))
  assert type(td).__name__ == type(jd).__name__
  _close(td.log_prob(torch.tensor(x)), jd.log_prob(jnp.asarray(x)),
         err_msg=posterior)
  _close(td.mean(), jd.mean(), err_msg=posterior)
  t_prior, j_prior = t_meta.create_prior(), j_meta.create_prior()
  if j_prior is None:
    assert t_prior is None
  else:
    _close(t_prior.log_prob(torch.tensor(x)),
           j_prior.log_prob(jnp.asarray(x)))
  # constrained=True passes final parameters through untouched
  if posterior in _COUNT_POSTERIORS:
    pos = np.abs(raw) + 0.5
    _close(t_meta.create_distribution(torch.tensor(pos), True)
           .log_prob(torch.tensor(x)),
           j_meta.create_distribution(jnp.asarray(pos), True)
           .log_prob(jnp.asarray(x)))


def test_parse_rv_and_unknown_posterior():
  assert trv.parse_rv((7, "zinbd", "rna")) == trv.RVmeta(7, "zinbd", True,
                                                         "rna")
  meta = trv.parse_rv({"dim": 5, "posterior": "nbd", "dispersion": "single"})
  assert meta.kw == {"dispersion": "single"} and meta.name == "rv"
  with pytest.raises(ValueError, match="Unknown posterior"):
    trv.RVmeta(3, "gamma")
  # 'nzmse' (scScope's head): deterministic, 'relu' and log1p space by
  # default, the same distribution as JAX's from the same raw output
  t_nz, j_nz = trv.RVmeta(4, "nzmse"), jrv.RVmeta(4, "nzmse")
  assert (t_nz.n_params, t_nz.kw, t_nz.is_deterministic) \
      == (j_nz.n_params, j_nz.kw, j_nz.is_deterministic) == (4, {}, True)
  raw = np.array([[-1.0, 0.5, 2.0, 0.1]], np.float32)
  td, jd = (t_nz.create_distribution(torch.tensor(raw)),
            j_nz.create_distribution(jnp.asarray(raw)))
  assert isinstance(td, TD.NonzeroMaskedDeterministic) and td.log_space
  _close(td.loc, jd.loc)
  _close(td.mean(), jd.mean())
  x = np.array([[0.0, 3.0, 1.0, 0.0]], np.float32)
  _close(td.log_prob(torch.tensor(x)), jd.log_prob(jnp.asarray(x)))
  for name in ("tril", "mvntril", "mixtril"):  # ported: the JAX count
    assert trv.RVmeta(3, name).n_params == jrv.RVmeta(3, name).n_params
  assert trv.RVmeta(3, "relu").kw == jrv.RVmeta(3, "relu").kw \
      == {"activation": "relu"}


def _label_pairs(kind, rng):
  """(port dist, JAX dist, x) at random parameters."""
  shape = (8, 6)
  a = rng.normal(0, 2, shape).astype(np.float32)
  if kind == "poisson":
    rate = np.exp(a)
    rate[0, :2] = 0.0  # rate 0 at x = 0 (log 1) and at x > 0 (−inf)
    x = rng.poisson(3.0, shape).astype(np.float32)
    x[0, :2] = [0.0, 2.0]
    (j,), (t,) = _both(rate)
    return TD.Poisson(t), JD.Poisson(j), x
  if kind == "zip":
    g = rng.normal(0, 1, shape).astype(np.float32)
    x = rng.poisson(2.0, shape).astype(np.float32)
    (j, jg), (t, tg) = _both(np.exp(a), g)
    return (TD.ZeroInflated(TD.Poisson(t), tg),
            JD.ZeroInflated(JD.Poisson(j), jg), x)
  if kind == "bernoulli":
    x = (rng.uniform(size=shape) < 0.4).astype(np.float32)
    (j,), (t,) = _both(a)
    return TD.Bernoulli(t), JD.Bernoulli(j), x
  if kind == "categorical":
    x = rng.integers(0, 6, 8).astype(np.float32)
    (j,), (t,) = _both(a)
    return TD.Categorical(t), JD.Categorical(j), x
  if kind == "onehot":
    x = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 8)]
    x[1] = [0.2, 0.8, 0, 0, 0, 0]  # a soft label
    (j,), (t,) = _both(a)
    return TD.OneHotCategorical(t), JD.OneHotCategorical(j), x
  (j,), (t,) = _both(a)
  x = rng.normal(0, 1, shape).astype(np.float32)
  return TD.VectorDeterministic(t), JD.VectorDeterministic(j), x


@pytest.mark.parametrize("kind", ["poisson", "zip", "bernoulli", "onehot",
                                  "categorical", "deterministic"])
def test_label_and_count_distributions_match_jax(kind):
  td, jd, x = _label_pairs(kind, np.random.default_rng(20))
  tlp = td.log_prob(torch.tensor(x)).numpy()
  jlp = np.asarray(jd.log_prob(jnp.asarray(x)))
  fin = np.isfinite(jlp)
  np.testing.assert_array_equal(np.isfinite(tlp), fin)
  _close(tlp[fin], jlp[fin], err_msg=kind)
  _close(td.mean(), jd.mean(), err_msg=kind)
  if kind == "poisson":
    assert tlp[0, 0] == 0.0 and tlp[0, 1] == -np.inf


def _mixtures(comp, rng, k=3, d=5):
  """(port, JAX) MixtureSameFamily over K components of one family."""
  logits = rng.normal(0, 1, (8, k)).astype(np.float32)
  a = rng.normal(0, 1, (8, k, d)).astype(np.float32)
  b = np.exp(rng.normal(0, 1, (8, k, d))).astype(np.float32)
  g = rng.normal(0, 1, (8, k, d)).astype(np.float32)

  def build(M, t):
    if comp == "gaus":
      base = M.Normal(t(a), t(b))
    else:
      base = M.NegativeBinomialDisp(t(np.exp(a) * 3), t(b))
      if comp == "zinb":
        base = M.ZeroInflated(base, t(g))
    return M.MixtureSameFamily(t(logits), M.Independent(base, 1))
  return build(TD, torch.tensor), build(JD, jnp.asarray)


@pytest.mark.parametrize("comp", ["gaus", "nb", "zinb"])
def test_mixture_same_family_matches_jax(comp):
  rng = np.random.default_rng(30)
  tm, jm = _mixtures(comp, rng)
  x = (rng.normal(0, 1, (8, 5)) if comp == "gaus"
       else rng.poisson(3.0, (8, 5))).astype(np.float32)
  assert tm.batch_shape == tuple(jm.batch_shape) == (8,)
  assert tm.n_components == 3
  _close(tm.log_prob(torch.tensor(x)), jm.log_prob(jnp.asarray(x)),
         err_msg=comp)
  for fn in ("mean", "variance", "mode"):
    _close(getattr(tm, fn)(), getattr(jm, fn)(), err_msg=f"{comp} {fn}")


@pytest.mark.parametrize("comp", ["gaus", "nb", "zinb"])
def test_mixture_sample_from_generator(comp):
  """Draws follow the generator (same seed, same draws) and average to
  the mixture's mean: 4,000 draws, within 5 standard errors."""
  tm, _ = _mixtures(comp, np.random.default_rng(31), d=2)
  s1 = tm.sample((4000,), generator=torch.Generator().manual_seed(1))
  s2 = tm.sample((4000,), generator=torch.Generator().manual_seed(1))
  assert s1.shape == (4000, 8, 2) and torch.equal(s1, s2)
  if comp != "gaus":
    assert torch.equal(s1, torch.round(s1)) and (s1 >= 0).all()
  se = torch.sqrt(tm.variance() / 4000)
  assert ((s1.mean(0) - tm.mean()).abs() <= 5 * se).all()


def test_deterministic_latent_has_zero_kl_and_takes_no_noise():
  from sisua_tpu_torch.models.objective import _kl_term
  loc = torch.tensor(np.random.default_rng(2).normal(0, 1, (8, 4)),
                     dtype=torch.float32)
  q = TD.VectorDeterministic(loc)
  prior = TD.MultivariateNormalDiag(torch.zeros(4), torch.ones(4))
  assert torch.equal(TD.kl_divergence(q, prior), torch.zeros(8))
  assert torch.equal(_kl_term(q, None, loc, True), torch.zeros(8))
  assert torch.equal(q.rsample(eps=torch.ones(8, 4)), loc)
  assert tuple(q.rsample((3,)).shape) == (3, 8, 4)


@pytest.mark.parametrize("spec", [
    1.5, "linear", dict(kind="linear", vmin=0.1, vmax=2.0, norm=7),
    dict(kind="cosine", norm=10, delay_in=3),
    dict(kind="exp", norm=5, cyclical=True, delay_in=2),
    dict(kind="sigmoid", norm=9), dict(kind="expIn", norm=4)])
def test_interpolation_matches_jax(spec):
  t, j = tinterp.get_interpolation(spec), jinterp.get_interpolation(spec)
  for step in (0, 1, 2, 3, 5, 8, 13, 21):
    # float32 (JAX) vs float64 (math) evaluation of the same formula
    np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                               atol=1e-7, err_msg=f"step {step}")


def test_library_size_numpy_and_torch():
  rng = np.random.default_rng(4)
  x = rng.poisson(2.0, (40, 30)).astype(np.float32)
  jm, jv = j_library_size(x)
  tm, tv = t_library_size(x)
  np.testing.assert_array_equal(tm, jm)
  np.testing.assert_array_equal(tv, jv)
  # the torch form stays a tensor (float64 accumulation: rtol 1e-6), in
  # one row-sum pass or in passes of a few rows
  from sisua_tpu_torch.data import utils as tutils
  for elements in (tutils._SUM_ELEMENTS, 7 * 30):
    tutils._SUM_ELEMENTS, saved = elements, tutils._SUM_ELEMENTS
    try:
      tm2, tv2 = t_library_size(torch.tensor(x))
    finally:
      tutils._SUM_ELEMENTS = saved
    assert isinstance(tm2, torch.Tensor) and tm2.shape == (40, 1)
    np.testing.assert_allclose(tm2.numpy(), jm, rtol=1e-6)
    np.testing.assert_allclose(tv2.numpy(), jv, rtol=1e-5)


def _nb_mixture_params(seed, shape=(6, 5)):
  rng = np.random.default_rng(seed)
  back = rng.gamma(2.0, 2.0, shape).astype(np.float32)
  fore = back * (1.0 + rng.gamma(2.0, 2.0, shape)).astype(np.float32)
  disp = np.broadcast_to(rng.gamma(2.0, 1.0, shape[-1:]),
                         shape).astype(np.float32)
  mix = rng.normal(0, 2, shape).astype(np.float32)
  return back, fore, disp, mix


@pytest.mark.parametrize("seed", [0, 1])
def test_nb_mixture_matches_jax(seed):
  """TotalVI's per-element background/foreground NB mixture: log_prob
  (counts up to 1e6), mean, variance, mode and the posterior foreground
  probability, rtol 1e-5 (log-probs with the lgamma atol)."""
  params = _nb_mixture_params(seed)
  (jb, jf, jd, jm), (tb, tf, td, tm) = _both(*params)
  jq = JD.NegativeBinomialMixture(loc_back=jb, loc_fore=jf, disp=jd,
                                  mixing_logits=jm)
  tq = TD.NegativeBinomialMixture(loc_back=tb, loc_fore=tf, disp=td,
                                  mixing_logits=tm)
  _, x = _counts(seed, (6, 5))
  (jx,), (tx,) = _both(x)
  assert tq.batch_shape == tuple(jq.batch_shape) == (6, 5)
  _close(tq.log_prob(tx), jq.log_prob(jx))
  fg = tq.foreground_probability(tx)
  _close(fg, jq.foreground_probability(jx))
  assert ((fg >= 0) & (fg <= 1)).all()
  for attr in ("mean", "variance", "mode"):
    _close(getattr(tq, attr)(), getattr(jq, attr)(), err_msg=attr)
  # an Independent head sums the proteins, as the JAX one
  _close(TD.Independent(tq, 1).log_prob(tx),
         JD.Independent(jq, 1).log_prob(jx))


def test_nb_mixture_sample_and_merge():
  """Draws come at the mixture's batch shape from the generator (per-
  protein parameters under per-cell mixing), reproducibly, with the
  mixture's mean; ``tree_map`` merges its four leaves."""
  back, fore, disp, mix = _nb_mixture_params(2, (4, 3))
  tq = TD.NegativeBinomialMixture(
      torch.tensor(back), torch.tensor(fore), torch.tensor(disp[:1]),
      torch.tensor(mix))
  a = tq.sample((4000,), generator=torch.Generator().manual_seed(0))
  b = tq.sample((4000,), generator=torch.Generator().manual_seed(0))
  assert a.shape == (4000, 4, 3) and torch.equal(a, b)
  assert (a >= 0).all() and torch.equal(a, a.round())
  np.testing.assert_allclose(a.mean(0).numpy(), tq.mean().numpy(),
                             rtol=0.15)
  # TotalVI broadcasts θ to (B, P) before the mixture: every leaf merges
  tq.disp = tq.disp.expand(4, 3)
  merged = TD.tree_map(lambda *t: torch.cat(t), tq, tq)
  assert isinstance(merged, TD.NegativeBinomialMixture)
  assert merged.batch_shape == (8, 3)
  np.testing.assert_array_equal(merged.variance().numpy()[4:],
                                tq.variance().numpy())
