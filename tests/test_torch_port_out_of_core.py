"""The port's streaming and out-of-core loops and its sparse serving upload,
against the JAX package (``sisua_tpu/train/trainer.py``,
``tests/test_out_of_core.py``).

The out-of-core budget is forced tiny (``hbm_budget_bytes``) so that a
small dataset runs the whole chunk machinery on the CPU: N = 1024 cells ×
D = 32 genes, batch 64, budget 65,536 bytes (half the float32 data: 16
chunks of 64 rows, 6 resident, 10 streamed).

* Plans: ``_plan_out_of_core`` and ``_sparse_chunk_plans`` decide as the
  JAX trainer does over a grid of sizes, budgets and ``device_dtype``s.
* Out-of-core fits (the JAX file's tests, at its tolerances): quality
  within 5% of the resident fit; two runs bitwise equal; sparse upload
  equal to dense upload (rtol 1e-6; the densified chunks are exact);
  int16 storage equal to float32 (rtol 1e-5); semi-supervised SISUA with
  callbacks and ``checkpoint_path``; the callback calls equal to JAX's
  out-of-core fit's.
* Streaming: the batches reaching ``_train_step`` are the JAX
  ``DataFeeder``'s, exactly; the history under ``valid_freq`` has JAX's
  keys and lengths; one streamed step at converted weights with JAX's
  draws replayed matches JAX's step (rtol 1e-4 / atol 1e-5, the step
  tests' tolerance); int16 transfers train bitwise like float32.
* Serving: a CSR matrix uploads as triplets and serves bitwise like the
  dense matrix under the same generator state.
"""

import threading
import time

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sisua_tpu.data.feeder import DataFeeder as JFeeder
from sisua_tpu.models import VAE as JVAE
from sisua_tpu.nn import NetConf as JNetConf
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import Trainer as JTrainer
from sisua_tpu_torch.data.feeder import DataFeeder
from sisua_tpu_torch.models import SISUA, VAE, RVmeta, SCVI
from sisua_tpu_torch.nn import NetConf
from sisua_tpu_torch.ops import sparse as tsparse
from sisua_tpu_torch.train import trainer as trainer_mod
from sisua_tpu_torch.train.trainer import Trainer, _prefetch_iter
from test_torch_port_fit_surface import (CLOSE, G, _feed, _flax_leaf,
                                         _jax_model, _JaxRecorder, _noise,
                                         _port_model, _PortRecorder)
from torch_port_threads import _one_thread  # noqa: F401


N, D, B = 1024, 32, 64
BUDGET = 65536


def _counts(seed=0, n=N, d=D):
  rng = np.random.default_rng(seed)
  return rng.poisson(rng.gamma(2.0, 2.0, size=(n, d))).astype(np.float32)


def _sparse_counts(seed, n=N):
  rng = np.random.default_rng(seed)
  return rng.poisson(0.25, size=(n, D)).astype(np.float32)  # ~78% zeros


def _model(seed=1):
  return VAE(RVmeta(D, "zinb", name="rna"), seed=seed, device="cpu",
             encoder=NetConf((16,)), decoder=NetConf((16,)))


def _jmodel(seed=1):
  return JVAE(JRV(D, "zinb", name="rna"), seed=seed,
              encoder=JNetConf((16,)), decoder=JNetConf((16,)))


# ------------------------------------------------------------------- plans
PLANS = [
    # n, d, batch, budget, device_dtype: tests/test_out_of_core.py's three
    (N, D, B, BUDGET, "float32"),
    (N, D, B, B * 4 * D // 2, "float32"),
    (1000, D, B, BUDGET, "float32"),
    (N, D, B, BUDGET // 2, "int16"),
    (N, D, B, BUDGET // 2, "bfloat16"),
    (65_536, 33_000, 512, 2 ** 31, "float32"),
    (65_536, 33_000, 512, 2 ** 31, "int16"),
    (1_000_000, 33_000, 512, 40 * 10 ** 9, "float32"),
    (8192, 33_000, 512, 2 ** 30, "float32"),
    (300, 7, 512, 10 ** 9, "float32"),
]


@pytest.mark.parametrize("n,d,b,budget,dd", PLANS)
def test_plan_out_of_core_matches_jax(n, d, b, budget, dd):
  x = sp.csr_matrix((n, d), dtype=np.float32)  # shapes are what count
  jf, tf = JFeeder([x], batch_size=b), DataFeeder([x], batch_size=b)
  jt = JTrainer(step_core=None, device_cache=True, hbm_budget_bytes=budget,
                device_dtype=dd)
  tt = Trainer(device_cache=True, hbm_budget_bytes=budget, device_dtype=dd)
  assert tt._plan_out_of_core(tf) == jt._plan_out_of_core(jf)
  assert tt._fits_device(tf) == jt._fits_device(jf)
  if (n, budget) == (N, BUDGET) and dd == "float32":
    assert tt._plan_out_of_core(tf) == {"chunk_rows": 64, "n_chunks": 16,
                                        "n_resident": 6}


@pytest.mark.parametrize("dd", ["float32", "int16", "bfloat16"])
def test_sparse_chunk_plans_match_jax(dd):
  """Per source: triplets for a sparse CSR matrix, dense rows for a dense
  matrix and for a CSR matrix too full to gain; the same cap."""
  mats = [sp.csr_matrix(_sparse_counts(0)), _counts(1),
          sp.csr_matrix(_counts(2))]
  jf, tf = JFeeder(mats, batch_size=B), DataFeeder(mats, batch_size=B)
  perm = np.random.default_rng(0).permutation(N)
  rows = [perm[i * 128:(i + 1) * 128] for i in range(N // 128)]
  jt = JTrainer(step_core=None, device_cache=True, device_dtype=dd)
  tt = Trainer(device_cache=True, device_dtype=dd)
  jp = jt._sparse_chunk_plans(jf, rows, multichip=False)
  tp = tt._sparse_chunk_plans(tf, rows)
  assert [p is None for p in tp] == [p is None for p in jp] \
      == [False, True, True]
  assert tp[0]["cap"] == jp[0]["cap"]
  assert tp[0]["col_dtype"] == jp[0]["col_dtype"]
  assert tp[0]["val_dtype"] == getattr(torch, dd)
  assert np.dtype(jp[0]["val_dtype"]).name == dd


# ------------------------------------------------------------ out of core
def test_out_of_core_trains_and_matches_resident_quality():
  X = _counts()
  m_res, m_oc = _model(), _model()
  m_res.fit(X, epochs=8, batch_size=B, device_cache=True)
  m_oc.fit(X, epochs=8, batch_size=B, device_cache=True,
           hbm_budget_bytes=BUDGET)
  assert m_res.trainer._oc_plan is None
  assert m_oc.trainer._oc_plan["n_resident"] == 6
  l_res, l_oc = m_res.history["loss"], m_oc.history["loss"]
  assert len(l_oc) == 8 and l_oc[-1] < l_oc[0]
  assert abs(l_oc[-1] - l_res[-1]) / abs(l_res[-1]) < 0.05, (l_oc, l_res)
  assert "cells_per_sec" in m_oc.history
  assert len(m_oc.trainer._oc_wait_s) == 8


def test_out_of_core_deterministic():
  runs = []
  for _ in range(2):
    m = _model(seed=3)
    m.fit(_counts(), epochs=4, batch_size=B, device_cache=True,
          hbm_budget_bytes=BUDGET)
    runs.append(np.asarray(m.history["loss"]))
  np.testing.assert_array_equal(runs[0], runs[1])


def test_sparse_upload_matches_dense_upload():
  X = _sparse_counts(2)
  m_dense, m_sparse = _model(seed=11), _model(seed=11)
  m_dense.fit(X, epochs=4, batch_size=B, device_cache=True,
              hbm_budget_bytes=BUDGET)
  m_sparse.fit(sp.csr_matrix(X), epochs=4, batch_size=B, device_cache=True,
               hbm_budget_bytes=BUDGET)
  assert m_dense.trainer._oc_plan["sparse_sources"] == [False]
  assert m_sparse.trainer._oc_plan["sparse_sources"] == [True]
  np.testing.assert_allclose(m_sparse.history["loss"],
                             m_dense.history["loss"], rtol=1e-6)


def test_sparse_upload_int16_exact():
  X = sp.csr_matrix(_sparse_counts(3))
  m16, m32 = _model(seed=13), _model(seed=13)
  m16.fit(X, epochs=4, batch_size=B, device_cache=True, device_dtype="int16",
          hbm_budget_bytes=BUDGET // 2)
  m32.fit(X, epochs=4, batch_size=B, device_cache=True,
          device_dtype="float32", hbm_budget_bytes=BUDGET)
  assert m16.trainer._oc_plan == m32.trainer._oc_plan
  np.testing.assert_allclose(m16.history["loss"], m32.history["loss"],
                             rtol=1e-5)


def test_out_of_core_semi_supervised_and_checkpoint(tmp_path):
  rng = np.random.default_rng(3)
  x, y = _counts(4), rng.poisson(5.0, (N, 4)).astype(np.float32)

  def sisua():
    return SISUA([RVmeta(D, "zinb", name="rna"), RVmeta(4, "nb", name="adt")],
                 seed=21, encoder=NetConf((16,)), decoder=NetConf((16,)),
                 device="cpu")
  m = sisua()
  seen = []

  class Spy(trainer_mod.TrainingCallback):
    def on_epoch_end(self, epoch, logs):
      seen.append(dict(logs))
  m.fit([x, y], valid=[x[:128], y[:128]], epochs=5, batch_size=B,
        labels_percent=0.5, device_cache=True, hbm_budget_bytes=2 * BUDGET,
        callbacks=[Spy()], checkpoint_path=str(tmp_path / "ck"))
  assert m.trainer._oc_plan is not None
  assert len(seen) == 5 and all("loss" in s and "val_loss" in s
                                for s in seen)
  loss = m.history["loss"]
  assert np.isfinite(loss).all() and loss[-1] < loss[0]
  m2 = sisua().load_weights(str(tmp_path / "ck"), raise_notfound=True)
  _, qz = m2.predict(x[:32])
  assert tuple(qz.batch_shape) == (32,)


def test_out_of_core_callbacks_follow_jax():
  """The same calls, in order, with the same logs keys, as JAX's
  out-of-core fit (validated, so ``val_*`` keys ride along)."""
  x = _counts(5, n=512, d=G)
  jm, tm = _jax_model("vae"), _port_model("vae")
  jcb, tcb = _JaxRecorder(), _PortRecorder()
  kw = dict(epochs=3, batch_size=32, device_cache=True,
            hbm_budget_bytes=G * 4 * 8 * 32)
  jm.fit(x, valid=x[:64], callbacks=[jcb], **kw)
  tm.fit(x, valid=x[:64], callbacks=[tcb], **kw)
  assert tm.trainer._oc_plan is not None
  assert tcb.calls == jcb.calls
  for k in ("begun", "ended"):
    assert tm.history[k] == list(jm.history[k])


# --------------------------------------------------------------- streaming
@pytest.mark.parametrize("name", ["sisua", "scvi"])
def test_streaming_batches_are_the_jax_feeders(name):
  """Two epochs of batches as ``_train_step`` receives them: the inputs,
  masks (SISUA, labels_percent 0.5) and library rows (SCVI) of the JAX
  ``DataFeeder`` built by JAX's ``_to_feeder``."""
  x, y = _counts(6, n=200), _counts(7, n=200, d=4)
  if name == "sisua":
    m = SISUA([RVmeta(D, "zinb", name="rna"), RVmeta(4, "nb", name="adt")],
              device="cpu")
    data, lp = [x, y], 0.5
  else:
    m = SCVI(RVmeta(D, "zinbd", name="rna"), device="cpu")
    data, lp = [x], 0.0
  seen = []

  def step(batch):
    seen.append({k: ([t.numpy().copy() for t in v] if k == "inputs"
                     else v.numpy().copy()) for k, v in batch.items()})
    m.step += 1
    return {"loss": torch.tensor(1.0)}
  m._train_step = step
  m.fit(data, epochs=2, batch_size=32, labels_percent=lp)
  from sisua_tpu.data.utils import get_library_size as jlib
  mean, var = jlib(x)
  jf = JFeeder(data, library=np.concatenate([mean, var], 1),
               labels_percent=lp, batch_size=32)
  ref = list(jf) + list(jf)
  assert len(seen) == len(ref) == 2 * (200 // 32)
  for a, b in zip(seen, ref):
    for u, v in zip(a["inputs"], b["inputs"]):
      assert np.array_equal(u, v)
    assert np.array_equal(a["mask"], b["mask"])
    if name == "scvi":
      assert np.array_equal(a["library"], b["library"])
    else:
      assert "library" not in a


def test_default_fit_streams_with_jaxs_history(monkeypatch):
  """``device_cache=False`` (the default) is JAX's streaming loop: with
  ``valid_freq`` = 5 steps over 3 epochs of 4 steps, validation runs at
  steps 5 and 10 and at the end of the first epoch; the history has the
  same keys and lengths as JAX's streaming fit."""
  x = _counts(8, n=128)
  jm, tm = _jmodel(), _model()
  kw = dict(valid=x[:40], epochs=3, batch_size=32, valid_freq=5)
  jm.fit(x, **kw)
  seen = []
  real = Trainer.evaluate

  def spy(self, model, feeder):
    seen.append(model.step)
    return real(self, model, feeder)
  monkeypatch.setattr(Trainer, "evaluate", spy)
  tm.fit(x, **kw)
  assert seen == [4, 5, 10] and tm.step == 12
  assert sorted(tm.history) == sorted(jm.history)
  assert {k: len(v) for k, v in tm.history.items()} == \
      {k: len(v) for k, v in jm.history.items()}


def test_streamed_step_matches_jax():
  """The first streamed step of ``fit`` (Adam 1e-3 after the clip at 100)
  on the JAX feeder's first batch, with JAX's draws fed: every parameter
  as JAX's step leaves it."""
  x = _counts(9, n=96, d=30)
  jm, tm = _jax_model("vae_plain"), _port_model("vae_plain")
  jb = next(iter(jm._to_feeder(x, 32, 0.0)))
  jb = jax.tree_util.tree_map(jax.numpy.asarray, jb)
  key = jax.random.key(5, impl="rbg")
  tx = JTrainer(None, None, optimizer="adam", learning_rate=1e-3,
                clipnorm=100.0).make_optimizer()
  state = jm._state.replace(opt_state=tx.init(jm.params))
  new, _ = jax.jit(jm.make_train_step_core(tx))(state, jb, key)
  _feed(tm, _noise(jm, jb, key))
  tm.fit(x, epochs=1, batch_size=32, max_iter=1)
  assert tm.step == 1
  for k, p in tm.module.named_parameters():
    np.testing.assert_allclose(p.detach(), _flax_leaf(new.params, tm.module,
                                                      k), **CLOSE,
                               err_msg=k)


def test_streaming_int16_transfer_trains_like_float32():
  X = sp.csr_matrix(_sparse_counts(10, n=256))
  a, b = _model(seed=4), _model(seed=4)
  a.fit(X, epochs=2, batch_size=B, transfer_dtype="int16")
  b.fit(X, epochs=2, batch_size=B)
  assert a.history["loss"] == b.history["loss"]
  with pytest.raises(ValueError, match="int16"):
    _model().fit(X.toarray() + 0.5, epochs=1, batch_size=B,
                 transfer_dtype="int16")


def test_device_cache_dispatch(capsys, monkeypatch):
  """JAX's rule: resident within the budget, out of core above it,
  streaming (with JAX's message) when not even a one-batch chunk fits, and
  streaming without ``device_cache``."""
  X = _counts(11)
  calls = []
  for name in ("_fit_device_cached", "_fit_out_of_core", "_fit_streaming"):
    def spy(self, *a, _real=getattr(Trainer, name), _name=name):
      calls.append(_name)
      return _real(self, *a)
    monkeypatch.setattr(Trainer, name, spy)
  for kw in (dict(device_cache=True),
             dict(device_cache=True, hbm_budget_bytes=BUDGET),
             dict(device_cache=True, hbm_budget_bytes=1024), dict()):
    _model().fit(X, epochs=1, batch_size=B, **kw)
  assert calls == ["_fit_device_cached", "_fit_out_of_core",
                   "_fit_streaming", "_fit_streaming"]
  assert "streaming instead" in capsys.readouterr().out


def test_evaluate_cached_equals_streamed():
  m = _model()
  m.fit(_counts(12, n=128), epochs=1, batch_size=32, device_cache=True)
  f = DataFeeder([_counts(13, n=100)], batch_size=32, shuffle=False)
  state = m.generator.get_state()  # the same latent draws in both
  cached = Trainer(device_cache=True).evaluate(m, f)
  m.generator.set_state(state)
  streamed = Trainer(device_cache=False).evaluate(m, f)
  assert cached.keys() == streamed.keys()
  for k in cached:
    np.testing.assert_allclose(cached[k], streamed[k], rtol=1e-6)


def test_prefetch_worker_raises_and_stops():
  """A worker's exception is raised at the consumer; a consumer that stops
  early (a max_iter break) stops the worker instead of leaving it parked
  on the full queue."""
  def boom():
    yield 1
    raise KeyError("in the worker")
  it = _prefetch_iter(boom())
  assert next(it) == 1
  with pytest.raises(KeyError, match="in the worker"):
    next(it)
  before = threading.active_count()
  it = _prefetch_iter(iter(range(10 ** 6)), depth=2)
  assert next(it) == 0
  it.close()
  deadline = time.time() + 5.0
  while threading.active_count() > before and time.time() < deadline:
    time.sleep(0.05)
  assert threading.active_count() <= before


# ----------------------------------------------------------------- serving
def test_serving_sparse_upload_matches_dense(monkeypatch):
  """``predict_mean`` and ``predict(device_cache=True)`` of a CSR matrix
  upload triplets (the spy sees them) and equal the dense calls bitwise
  under the same generator state; a dense matrix never builds triplets."""
  from sisua_tpu_torch.models import base
  X = _sparse_counts(14, n=300)
  m = _model(seed=17)
  m.fit(X, epochs=1, batch_size=B, device_cache=True)
  calls = []
  real = base.csr_row_triplets

  def spy(*a, **k):
    calls.append(1)
    return real(*a, **k)
  monkeypatch.setattr(base, "csr_row_triplets", spy)
  state = m.generator.get_state()
  xd, zd = m.predict_mean(X, sample_shape=(4,), input_dtype=None)
  assert not calls
  m.generator.set_state(state)
  xs_, zs_ = m.predict_mean(sp.csr_matrix(X), sample_shape=(4,),
                            input_dtype=None)
  assert calls
  np.testing.assert_array_equal(xs_[0], xd[0])
  np.testing.assert_array_equal(zs_[0], zd[0])
  m.generator.set_state(state)
  pd, _ = m.predict(X, batch_size=B, device_cache=True)
  m.generator.set_state(state)
  ps, _ = m.predict(sp.csr_matrix(X), batch_size=B, device_cache=True)
  assert torch.equal(pd.mean(), ps.mean())
  monkeypatch.setenv("SISUA_TPU_SERVING_BUDGET", str(100 * 4 * D))
  m.generator.set_state(state)
  xc, _ = m.predict_mean(sp.csr_matrix(X), input_dtype="int16")
  m.generator.set_state(state)
  xcd, _ = m.predict_mean(X, input_dtype="int16")
  np.testing.assert_array_equal(xc[0], xcd[0])
  # a CSR matrix too full to gain uploads dense
  dense_csr = sp.csr_matrix(_counts(15, n=64))
  before = len(calls)
  tsrc = m._sparse_or_dense_batches(dense_csr, 1, 64, 64)
  assert len(calls) == before and tsrc.shape == (1, 64, D)
  assert torch.equal(tsrc[0], torch.tensor(dense_csr.toarray()))
  assert tsparse.worthwhile(10, 64, D, 4, 4)
