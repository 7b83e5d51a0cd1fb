"""The port's serving half against the JAX package: ``predict`` (streaming
and ``device_cache=True``), ``predict_mean``, ``get_normalized_expression``,
``compute_llk`` and ``marginal_log_prob``, at converted random weights and
fed noise; forced chunking; ``apply``/``encode``/``decode``.

Noise: each JAX serving call draws its keys from the model's stream
(``_next_key`` per streamed batch; one key per chunk, split over its padded
batches, on the device-cached paths). The tests replay those keys through
the JAX module on the same batches, recover each draw as
eps = (z − loc)/scale, and feed the port the same draws in order (the
module's ``_sample`` reads them). Tolerances: rtol 1e-4, atol 1e-5 as
tests/test_torch_port_models.py; sums over cells (``compute_llk``) rtol
1e-5.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.models as J
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_threads import _one_thread  # noqa: F401


G, P, N, B = 60, 6, 70, 32   # 3 batches, the last one ragged (6 rows)
NB = 3                       # batch-covariate levels of 'scvi_nb'
CLOSE = dict(rtol=1e-4, atol=1e-5)
NETS = dict(encoder={"units": [32, 32], "batchnorm": True},
            decoder={"units": [32, 32], "batchnorm": True})
LAT = dict(latents=dict(dim=4, posterior="diag", name="latents"))


def _build(zoo, RV, name, **kw):
  if name == "scvi":
    return zoo.SCVI(RV(G, "zinbd", name="rna"), dispersion="single",
                    **LAT, **NETS, **kw)
  if name == "scvi_nb":
    return zoo.SCVI(RV(G, "zinbd", name="rna"), n_batch=NB, **LAT, **NETS,
                    **kw)
  if name == "sisua":
    return zoo.SISUA([RV(G, "zinb", name="rna"), RV(P, "nb", name="adt")],
                     alpha=10.0, **LAT, **NETS, **kw)
  if name == "dca_mse":
    return zoo.DeepCountAutoencoder(RV(G, "mse", name="rna"), **NETS, **kw)
  return zoo.DeepCountAutoencoder(RV(G, "zinb", name="rna"), **NETS, **kw)


@functools.lru_cache(maxsize=None)
def _weights(name):
  """Random flax params and batch stats (off their init)."""
  jm = _build(J, JRV, name)
  jm._ensure_initialized()
  rng = np.random.default_rng(11)

  def leaf(path, a):
    if path[-1].key == "var":
      return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return (np.asarray(a) + rng.normal(0, 0.2, a.shape)).astype(np.float32)
  return (jax.tree_util.tree_map_with_path(leaf, jax.device_get(jm.params)),
          jax.tree_util.tree_map_with_path(
              leaf, jax.device_get(jm.batch_stats)))


def _pair(name):
  """A JAX model and a port model holding the same weights."""
  params, stats = _weights(name)
  jm = _build(J, JRV, name, seed=5)
  jm._ensure_initialized()
  jm._state = jm._state.replace(params=jax.tree_util.tree_map(
      jnp.asarray, params), batch_stats=jax.tree_util.tree_map(
          jnp.asarray, stats))
  tm = _build(T, TRV, name, device="cpu", seed=5)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, stats))
  return jm, tm


def _data(n=N, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
       * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)
  y = rng.poisson(np.exp(2.0 + rng.normal(0, 1, (n, P)))).astype(np.float32)
  return x, y


# ------------------------------------------------------------ fed noise
def _stream_keys(rng, k):
  keys = []
  for _ in range(k):
    rng, sub = jax.random.split(rng)
    keys.append(sub)
  return keys


def _chunk_keys(rng, k):
  _, sub = jax.random.split(rng)
  return list(jax.random.split(sub, k))


def _library(x):
  logc = np.log(x.sum(1) + 1e-8)
  return np.stack([np.full(len(x), logc.mean()),
                   np.full(len(x), logc.var())], 1).astype(np.float32)


def _jax_draws(jm, x, sample_shape, streaming, batch=B, onehot=None):
  """The eps the JAX serving call on ``x`` (starting from the model's
  current key) draws, batch by batch, as port tensors; ``onehot`` is the
  batch block the module input carries."""
  n = len(x)
  k = -(-n // batch)
  lib = _library(x)
  if onehot is not None:
    x = np.concatenate([x, onehot], 1)
  if streaming:
    keys = _stream_keys(jm._rng, k)
    batches = [(x[i * batch:(i + 1) * batch], lib[i * batch:(i + 1) * batch])
               for i in range(k)]
  else:
    keys = _chunk_keys(jm._rng, k)
    xp = np.zeros((k * batch, x.shape[1]), np.float32)
    xp[:n] = x
    lp = np.zeros((k * batch, 2), np.float32)
    lp[:n] = lib
    batches = [(xp[i * batch:(i + 1) * batch], lp[i * batch:(i + 1) * batch])
               for i in range(k)]
  variables = {"params": jm.params, "batch_stats": jm.batch_stats}
  draws = []
  for key, (xb, lb) in zip(keys, batches):
    out = jm.module.apply(variables, jnp.asarray(xb), rngs={"sample": key},
                          training=False, sample_shape=sample_shape,
                          **jm._apply_kwargs(jnp.asarray(lb)))
    eps = []
    for q, z in zip(out.latents, out.latent_samples):
      q = getattr(q, "base", q)
      scale = getattr(q, "scale_diag", getattr(q, "scale", None))
      eps.append(None if scale is None
                 else torch.tensor(np.asarray((z - q.loc) / scale)))
    draws.append(eps)
  return draws


@contextlib.contextmanager
def _fed(tm, draws):
  """The port's module samples ``draws`` in order, one list per batch."""
  it = iter(draws)
  sample = type(tm.module)._sample
  tm.module._sample = lambda qZ, ss, gen, noise: sample(
      tm.module, qZ, ss, gen, next(it))
  try:
    yield
    assert next(it, None) is None, "fewer batches served than drawn"
  finally:
    del tm.module._sample


def _means(d):
  return [np.asarray(p.mean()) for p in (d if isinstance(d, tuple) else (d,))]


# ----------------------------------------------------------------- predict
@pytest.mark.parametrize("device_cache", [False, True],
                         ids=["streaming", "device_cache"])
@pytest.mark.parametrize("sample_shape", [(), (3,)], ids=["S0", "S3"])
@pytest.mark.parametrize("name", ["scvi", "sisua", "dca"])
def test_predict_matches_jax(name, sample_shape, device_cache):
  """Output and latent parameters of the merged distributions; SISUA is
  served from the RNA matrix alone."""
  jm, tm = _pair(name)
  x, _ = _data()
  draws = _jax_draws(jm, x, sample_shape, streaming=not device_cache)
  jX, jZ = jm.predict(x, sample_shape=sample_shape, batch_size=B,
                      device_cache=device_cache)
  with _fed(tm, draws):
    tX, tZ = tm.predict(x, sample_shape=sample_shape, batch_size=B,
                        device_cache=device_cache)
  for t, j in zip(_tuple(tX) + _tuple(tZ), _tuple(jX) + _tuple(jZ)):
    _assert_dist_close(t, j)
  assert _means(tX)[0].shape == sample_shape + (N, G)
  if name == "scvi":  # the per-gene dispersion row is kept once
    assert tuple(tX.base.count_distribution.disp.shape) == (1, G)


def _tuple(d):
  return d if isinstance(d, tuple) else (d,)


def _assert_dist_close(t, j, path="dist"):
  """Every parameter tensor of a port distribution against the JAX
  distribution's field of the same name (the packages share them); the
  port's are on the CPU."""
  assert type(t).__name__ == type(j).__name__, path
  for k, v in vars(t).items():
    if isinstance(v, torch.Tensor):
      assert v.device.type == "cpu"
      np.testing.assert_allclose(v.numpy(), np.asarray(getattr(j, k)),
                                 err_msg=f"{path}.{k}", **CLOSE)
    elif isinstance(v, T.base.D.Distribution):
      _assert_dist_close(v, getattr(j, k), f"{path}.{k}")


def test_predict_ignores_label_matrices_and_merges_constants():
  """SISUA served from [rna, adt] equals serving from rna alone; SCVI
  'single' keeps its (1, D) row whether 1 or several batches merge."""
  _, tm = _pair("sisua")
  x, y = _data()
  outs = []
  for data in (x, [x, y]):
    tm.generator.manual_seed(1)
    outs.append(tm.predict(data, batch_size=B, device_cache=True))
  for a, b in zip(_means(outs[0][0]), _means(outs[1][0])):
    np.testing.assert_array_equal(a, b)
  _, sm = _pair("scvi")
  for bs in (N, B, 7):
    for dc in (False, True):
      pX, _ = sm.predict(x, batch_size=bs, device_cache=dc)
      assert tuple(pX.base.count_distribution.disp.shape) == (1, G)
      assert tuple(pX.mean().shape) == (N, G)


# ------------------------------------------------------- device-side means
@pytest.mark.parametrize("sample_shape", [(), (3,)], ids=["S0", "S3"])
@pytest.mark.parametrize("name", ["scvi", "sisua", "dca"])
def test_predict_mean_matches_jax(name, sample_shape):
  jm, tm = _pair(name)
  x, _ = _data()
  draws = _jax_draws(jm, x, sample_shape, streaming=False)
  jx, jz = jm.predict_mean(x, sample_shape=sample_shape, batch_size=B)
  with _fed(tm, draws):
    tx, tz = tm.predict_mean(x, sample_shape=sample_shape, batch_size=B)
  assert len(tx) == len(jx) and len(tz) == len(jz)
  for a, b in zip(tx + tz, jx + jz):
    assert a.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_allclose(a, b, **CLOSE)


def test_predict_mean_bf16_fetch_and_int16_upload():
  jm, tm = _pair("sisua")
  x, _ = _data()
  draws = _jax_draws(jm, x, (), streaming=False)
  jx, _ = jm.predict_mean(x, batch_size=B, fetch_dtype="bfloat16")
  with _fed(tm, draws):
    tx, _ = tm.predict_mean(x, batch_size=B, fetch_dtype="bfloat16")
  for a, b in zip(tx, jx):
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-5)
  assert tm._upload_dtype([x], "auto") == torch.int16
  assert tm._upload_dtype([x + 0.5], "auto") == torch.float32
  assert tm._upload_dtype([torch.tensor(x)], "auto") == torch.float32
  with pytest.raises(ValueError, match="int16"):
    tm._upload_dtype([x * 1e5], "int16")
  tm.generator.manual_seed(2)
  a, _ = tm.predict_mean(x, batch_size=B, input_dtype="auto")
  tm.generator.manual_seed(2)
  b, _ = tm.predict_mean(x, batch_size=B, input_dtype=None)
  np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("reduce_mc", [True, False])
@pytest.mark.parametrize("name", ["scvi", "sisua"])
def test_normalized_expression_matches_jax(name, reduce_mc):
  jm, tm = _pair(name)
  x, _ = _data()
  draws = _jax_draws(jm, x, (2, 2), streaming=False)
  j = jm.get_normalized_expression(x, sample_shape=(2, 2), batch_size=B,
                                   reduce_mc=reduce_mc)
  with _fed(tm, draws):
    t = tm.get_normalized_expression(x, sample_shape=(2, 2), batch_size=B,
                                     reduce_mc=reduce_mc)
  assert t.shape == ((N, G) if reduce_mc else (4, N, G))
  np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-7)
  np.testing.assert_allclose(t.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("sample_shape", [(), (3,)], ids=["S0", "S3"])
@pytest.mark.parametrize("name", ["scvi", "sisua", "dca"])
def test_compute_llk_matches_jax(name, sample_shape):
  """MC dims collapse as logsumexp − log S; N = 70 pads the last of three
  batches of 32, whose rows the mask drops."""
  jm, tm = _pair(name)
  x, y = _data()
  targets = {"orig": [x, y][:jm.n_outputs], "noisy": [x + 1.0]}
  draws = _jax_draws(jm, x, sample_shape, streaming=False)
  j = jm.compute_llk(x, targets, sample_shape=sample_shape, batch_size=B)
  with _fed(tm, draws):
    t = tm.compute_llk(x, targets, sample_shape=sample_shape, batch_size=B)
  assert sorted(t) == sorted(j)
  for k in j:
    np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["scvi", "sisua", "dca"])
def test_marginal_log_prob_matches_jax(name):
  jm, tm = _pair(name)
  x, _ = _data()
  draws = _jax_draws(jm, x, (5,), streaming=True)
  j = jm.marginal_log_prob(x, sample_shape=5, batch_size=B)
  with _fed(tm, draws):
    t = tm.marginal_log_prob(x, sample_shape=5, batch_size=B)
  assert t.shape == (N,)
  np.testing.assert_allclose(t, j, **CLOSE)


# ----------------------------------------------------------- forced chunks
def _forced_budget():
  return str(4 * B * 4 * G)  # each chunk ≈ half of it → 2 batches


@contextlib.contextmanager
def _budget(value):
  os.environ["SISUA_TPU_SERVING_BUDGET"] = value
  try:
    yield
  finally:
    del os.environ["SISUA_TPU_SERVING_BUDGET"]


def test_serving_chunks_match_jax_rows():
  jm, tm = _pair("dca_mse")
  x = _data(700)[0]
  feeder = jm._to_feeder(x, B, 0.0, shuffle=False)
  assert tm._serving_chunks([x], B) is None  # CPU: no budget, no chunks
  with _budget(_forced_budget()):
    jc, tc = jm._serving_chunks(feeder), tm._serving_chunks([x], B)
    assert len(tc) > 3 and len(tc) == len(jc)
    for a, b in zip(tc, jc):
      np.testing.assert_array_equal(a, b)
    assert [nv for _, nv in tm._iter_serving_chunks([x], B)][-1] == \
        700 - (len(tc) - 1) * len(tc[0])
  # a batch larger than the data never chunks below one batch
  with _budget("1"):
    assert tm._serving_chunks([x[:10]], 256) is None
    out, _ = tm.predict_mean(x[:10], batch_size=256)
  assert out[0].shape == (10, G)


@pytest.mark.parametrize("method", ["predict_mean", "predict",
                                    "compute_llk"])
def test_forced_chunking_gives_the_same_results(method):
  """A deterministic model (DCA, 'mse') makes chunked ≡ unchunked exact
  (``compute_llk``'s sums within rtol 1e-6, as tests/test_serving_chunks.py);
  both equal the JAX package's chunked result."""
  jm, tm = _pair("dca_mse")
  x = _data(700)[0]
  call = {
      "predict_mean": lambda m: m.predict_mean(x, batch_size=B),
      "predict": lambda m: tuple(
          _means(d)[0] for d in m.predict(x, batch_size=B,
                                          device_cache=True)),
      "compute_llk": lambda m: tuple(
          m.compute_llk(x, {"orig": [x]}, batch_size=B).values()),
  }[method]
  whole = call(tm)
  with _budget(_forced_budget()):
    assert len(tm._serving_chunks([x], B)) > 3
    chunked, jax_chunked = call(tm), call(jm)
  flat = lambda r: [np.asarray(a) for a in (
      r[0] + r[1] if method == "predict_mean" else r)]
  for a, b, c in zip(flat(chunked), flat(whole), flat(jax_chunked)):
    if method == "compute_llk":  # per-chunk sums add in another order
      np.testing.assert_allclose(a, b, rtol=1e-6)
    else:
      np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ apply/encode/decode
@pytest.mark.parametrize("mutable", [False, True])
def test_apply_training_keeps_running_stats_unless_mutable(mutable):
  jm, tm = _pair("sisua")
  x, _ = _data()
  before = {k: v.clone() for k, v in tm.module.named_buffers()}
  key = jax.random.key(4, impl="rbg")
  jout, jstats = jm.apply(jnp.asarray(x), training=True, key=key,
                          mutable=True)
  eps = [torch.tensor(np.asarray((z - q.loc) / q.scale_diag))
         for q, z in zip(jout.latents, jout.latent_samples)]
  res = tm.apply(x, training=True, noise=eps, mutable=mutable)
  out = res[0] if mutable else res
  np.testing.assert_allclose(out.outputs[0].mean().detach().numpy(),
                             np.asarray(jout.outputs[0].mean()), **CLOSE)
  after = dict(tm.module.named_buffers())
  if mutable:
    assert res[1].keys() == after.keys()
    want = convert.jax_to_torch(tm.module, _weights("sisua")[0],
                                jax.device_get(jstats))
    for k, v in after.items():
      np.testing.assert_allclose(v.numpy(), want[k].numpy(), **CLOSE)
      assert not torch.equal(v, before[k])
  else:
    assert all(torch.equal(v, before[k]) for k, v in after.items())
  # a train-mode decode leaves them alone too
  snap = {k: v.clone() for k, v in tm.module.named_buffers()}
  tm.decode(torch.zeros(5, 4), training=True)
  assert all(torch.equal(v, snap[k])
             for k, v in tm.module.named_buffers())


@pytest.mark.parametrize("name", ["scvi", "sisua"])
def test_encode_decode_match_jax(name):
  jm, tm = _pair(name)
  x, _ = _data()
  lib = _library(x)
  jq = jm.encode(x, library=lib)
  tq = tm.encode(x, library=lib)
  for a, b in zip(tq if isinstance(tq, tuple) else (tq,),
                  jq if isinstance(jq, tuple) else (jq,)):
    np.testing.assert_allclose(a.mean().detach().numpy(),
                               np.asarray(b.mean()), **CLOSE)
  z = ([np.asarray(q.mean()) for q in jq] if isinstance(jq, tuple)
       else np.asarray(jq.mean()))
  with torch.no_grad():
    decoded = _means(tm.decode(z))
  for a, b in zip(decoded, _means(jm.decode(z))):
    np.testing.assert_allclose(a, b, **CLOSE)
  if name == "scvi":
    with pytest.raises(ValueError, match="BOTH"):
      tm.decode(z[0])


def test_mesh_is_not_ported():
  """Mesh serving is ported (``tests/test_torch_port_mesh.py``); over a
  one-rank mesh ``predict`` is the single-device call, bitwise, and a
  mesh needs a world."""
  import torch_port_mesh_ranks as ranks
  from sisua_tpu_torch.parallel import spawn
  _, tm = _pair("dca")
  with pytest.raises(RuntimeError, match="process group"):
    from sisua_tpu_torch.parallel import create_mesh
    tm.predict(_data()[0], mesh=create_mesh())
  out = spawn(ranks.one_rank, 1, timeout=120)[0]
  for a, b in zip(out["mesh"]["predict"], out["single"]["predict"]):
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------- batch-covariate conditioning
def _onehot(n=N, seed=3):
  return np.eye(NB, dtype=np.float32)[
      np.random.default_rng(seed).integers(0, NB, n)]


@pytest.mark.parametrize("device_cache", [False, True],
                         ids=["streaming", "device_cache"])
def test_predict_at_n_batch_matches_jax(device_cache):
  """``predict([rna, one-hot])``: both paths hand the batch block to the
  encoder and the decoder, as JAX's (the streaming path once read the RNA
  matrix alone and fell back to the uniform batch prior)."""
  jm, tm = _pair("scvi_nb")
  x, _ = _data()
  oh = _onehot()
  draws = _jax_draws(jm, x, (), streaming=not device_cache, onehot=oh)
  jX, jZ = jm.predict([x, oh], batch_size=B, device_cache=device_cache)
  with _fed(tm, draws):
    tX, tZ = tm.predict([x, oh], batch_size=B, device_cache=device_cache)
  for t, j in zip(_tuple(tX) + _tuple(tZ), _tuple(jX) + _tuple(jZ)):
    _assert_dist_close(t, j)
  with _fed(tm, draws):
    prior, _ = tm.predict(x, batch_size=B, device_cache=device_cache)
  assert not np.allclose(_means(prior)[0], _means(tX)[0], rtol=1e-3)


def test_predict_mean_at_n_batch_matches_jax():
  jm, tm = _pair("scvi_nb")
  x, _ = _data()
  oh = _onehot()
  draws = _jax_draws(jm, x, (), streaming=False, onehot=oh)
  jx, jz = jm.predict_mean([x, oh], batch_size=B)
  with _fed(tm, draws):
    tx, tz = tm.predict_mean([x, oh], batch_size=B)
  for a, b in zip(tx + tz, jx + jz):
    np.testing.assert_allclose(a, b, **CLOSE)


def test_marginal_log_prob_at_n_batch_matches_jax():
  """The module input carries the one-hot; the likelihood target is the
  RNA matrix (it once was the encoder input itself)."""
  jm, tm = _pair("scvi_nb")
  x, _ = _data()
  oh = _onehot()
  draws = _jax_draws(jm, x, (5,), streaming=True, onehot=oh)
  j = jm.marginal_log_prob([x, oh], sample_shape=5, batch_size=B)
  with _fed(tm, draws):
    t = tm.marginal_log_prob([x, oh], sample_shape=5, batch_size=B)
  assert t.shape == (N,)
  np.testing.assert_allclose(t, j, **CLOSE)
