"""``fit(scan_steps=k)`` in the port against the JAX package's streaming
loop (``sisua_tpu/train/trainer.py``: ``_build_steps`` and the loop over
``DataFeeder.iter_chunks``).

k batches are uploaded as one (k, B, D) chunk and their k steps run from
it; an epoch's steps round down to a multiple of k; validation under
``valid_freq`` and ``max_iter`` are checked once per chunk. At k = 3 the
port validates at the same steps as JAX, its history has JAX's keys and
lengths, and the batches reaching ``_train_step`` are the JAX feeder's
chunks, row for row. The resident loop ignores ``scan_steps``, as JAX's
does.
"""

import numpy as np
import pytest
import torch

from sisua_tpu.data.feeder import DataFeeder as JFeeder
from sisua_tpu.data.utils import get_library_size as jlib
from sisua_tpu.models import VAE as JVAE
from sisua_tpu.nn import NetConf as JNetConf
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import Trainer as JTrainer
from sisua_tpu_torch.models import SCVI, SISUA, VAE, RVmeta
from sisua_tpu_torch.nn import NetConf
from sisua_tpu_torch.train.trainer import Trainer
from torch_port_threads import _one_thread  # noqa: F401


D, K = 24, 3


def _counts(seed, n, d=D):
  rng = np.random.default_rng(seed)
  return rng.poisson(rng.gamma(2.0, 2.0, size=(n, d))).astype(np.float32)


def _model():
  return VAE(RVmeta(D, "zinb", name="rna"), seed=1, device="cpu",
             encoder=NetConf((16,)), decoder=NetConf((16,)))


def _jmodel():
  return JVAE(JRV(D, "zinb", name="rna"), seed=1,
              encoder=JNetConf((16,)), decoder=JNetConf((16,)))


def test_streamed_history_at_k3_matches_jax(monkeypatch):
  """320 cells at batch 32: 10 batches round down to 3 chunks of 3 steps,
  9 steps an epoch. With ``valid_freq`` = 5 over 2 epochs both packages
  validate after the chunks that cross a multiple of 5 (steps 6, 12 and
  15), and no epoch-end validation runs."""
  x = _counts(8, 320)
  kw = dict(valid=x[:40], epochs=2, batch_size=32, valid_freq=5,
            scan_steps=K)
  jseen, seen = [], []
  jreal, real = JTrainer.evaluate, Trainer.evaluate

  def jspy(self, state, feeder, key=None):
    jseen.append(int(state.step))
    return jreal(self, state, feeder, key)

  def spy(self, model, feeder):
    seen.append(model.step)
    return real(self, model, feeder)
  monkeypatch.setattr(JTrainer, "evaluate", jspy)
  monkeypatch.setattr(Trainer, "evaluate", spy)
  jm, tm = _jmodel(), _model()
  jm.fit(x, **kw)
  tm.fit(x, **kw)
  assert seen == jseen == [6, 12, 15]
  assert tm.step == 18
  assert sorted(tm.history) == sorted(jm.history)
  assert {k: len(v) for k, v in tm.history.items()} == \
      {k: len(v) for k, v in jm.history.items()}
  assert np.isfinite(tm.history["loss"]).all()


@pytest.mark.parametrize("name", ["scvi", "sisua"])
def test_chunked_batches_are_the_jax_feeders_chunks(name):
  """Two epochs of k = 3 chunks as ``_train_step`` receives them: the
  inputs, masks (SISUA, labels_percent 0.5) and library rows (SCVI) of
  the JAX ``DataFeeder.iter_chunks(3)``, step by step."""
  x, y = _counts(6, 200), _counts(7, 200, d=4)
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
  m.fit(data, epochs=2, batch_size=32, labels_percent=lp, scan_steps=K)
  mean, var = jlib(x)
  jf = JFeeder(data, library=np.concatenate([mean, var], 1),
               labels_percent=lp, batch_size=32)
  ref = []
  for epoch in range(2):
    jf.set_epoch(epoch)
    for chunk in jf.iter_chunks(K):
      ref += [{k: ([a[j] for a in v] if k == "inputs" else v[j])
               for k, v in chunk.items()} for j in range(K)]
  assert len(seen) == len(ref) == 2 * K * (200 // (K * 32))
  for a, b in zip(seen, ref):
    for u, v in zip(a["inputs"], b["inputs"]):
      assert np.array_equal(u, v)
    assert np.array_equal(a["mask"], b["mask"])
    if name == "scvi":
      assert np.array_equal(a["library"], b["library"])
    else:
      assert "library" not in a


def test_scan_steps_stops_at_max_iter_per_chunk_and_falls_back():
  """``max_iter`` is checked after a whole chunk (5 → 6 steps at k = 3);
  an epoch holding fewer than k batches streams step by step; the
  resident loop takes no notice of ``scan_steps``."""
  x = _counts(9, 320)
  m = _model()
  m.fit(x, epochs=3, batch_size=32, scan_steps=K, max_iter=5)
  assert m.step == 6
  m = _model()
  m.fit(x[:64], epochs=2, batch_size=32, scan_steps=K)
  assert m.step == 4  # two batches an epoch: n_chunks(3) == 0
  a, b = _model(), _model()
  a.fit(x, epochs=2, batch_size=32, device_cache=True, scan_steps=K)
  b.fit(x, epochs=2, batch_size=32, device_cache=True)
  assert a.step == b.step == 20
  assert a.history["loss"] == b.history["loss"]
