"""MULTIVI's loss spikes in its first steps at a wide ATAC side, in the JAX
package and in the port alike.

Both models start from the same weights (the port's init, converted with
``convert.torch_to_jax_stacked``), train on the same batches of the same
seeded multiome counts (phase 11's generator in numpy: Poisson
transcriptome, peaks of 1–4 at ~5% of entries), with no dropout, and the
port replays each step's JAX draws (``member_draws``). The JAX train step
(``make_train_step_core`` under ``jax.jit``) and the port's one-member
fleet step record one loss a step each; both spike at the same step and
agree up to it.

Run as a script for another size, e.g. phase 11's learning rate at 2,000
genes × 20,000 peaks:

    JAX_PLATFORMS=cpu PYTHONPATH=. python \\
        tests/test_torch_port_multivi_spike.py 2000 20000 4096 512 24 3 1e-3

(genes, peaks, cells, batch, steps, seed, learning rate); it prints both
trajectories.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import sisua_tpu.models as J
from sisua_tpu.nn import NetConf as JNet
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu.train.trainer import TrainState
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.train import VmapEnsemble
from test_torch_port_ensemble_zoo import member_draws, stack_members

CLIPNORM = 100.0
# the size and rate at which the spike shows within a few steps here
SIZE = dict(genes=200, peaks=5000, cells=1024, batch=256, steps=7, seed=3,
            lr=3e-3)
SPIKE = 3.0      # a step's loss at least this many times the step before
AGREE = 1e-2     # rtol of the port's losses to JAX's up to the spike


def _multiome(genes, peaks, cells):
  rng = np.random.default_rng(0)
  x = (rng.poisson(np.exp(-2.5 + 1.2 * rng.normal(size=(cells, genes))))
       * (rng.uniform(size=(cells, genes)) > 0.5)).astype(np.float32)
  opening = np.exp(rng.normal(size=peaks))
  depth = np.exp(0.5 * rng.normal(size=(cells, 1)))
  a = np.minimum(rng.poisson(0.027 * depth * opening), 4.0)
  b = np.eye(4, dtype=np.float32)[rng.integers(0, 4, cells)]
  logc = np.log(x.sum(1) + 1e-8)
  return x, a.astype(np.float32), b, np.array([logc.mean(), logc.var()],
                                              np.float32)


def trajectories(genes, peaks, cells, batch, steps, seed, lr):
  """Per-step losses of the JAX MULTIVI and the port's, from the same
  weights, batches and draws."""
  x, a, b, lib = _multiome(genes, peaks, cells)
  net = {"units": [128, 128], "batchnorm": True}  # the default, no dropout
  ens = VmapEnsemble(lambda s: T.MULTIVI(
      [T.RVmeta(genes, "zinbd", name="rna"),
       T.RVmeta(peaks, "bernoulli", name="atac")], n_batch=4, device="cpu",
      seed=s, encoder=(net, net)), n_models=1, base_seed=seed)
  jnet = JNet((128, 128), batchnorm=True)
  jm = J.MULTIVI([JRV(genes, "zinbd", name="rna"),
                  JRV(peaks, "bernoulli", name="atac")], n_batch=4,
                 encoder=(jnet, jnet))
  ens._stacked = ens._stack_states()
  host = convert.torch_to_jax_stacked(ens.model.module, ens._stacked)
  params, stats = (jax.tree_util.tree_map(lambda v: jnp.asarray(v[0]),
                                          host[k])
                   for k in ("params", "batch_stats"))
  tx = optax.chain(optax.clip_by_global_norm(CLIPNORM), optax.adam(lr))
  state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats, opt_state=tx.init(params),
                     aux_params=None, aux_opt_state=None)
  core = jax.jit(jm.make_train_step_core(tx))
  key = jax.random.key(11, impl="threefry2x32")
  order = np.random.default_rng(1).permutation(cells)
  ours, theirs = [], []
  for s in range(steps):
    rows = order[(s * batch) % cells:][:batch]
    inputs = [x[rows], a[rows], b[rows]]
    library = np.tile(lib, (batch, 1))
    jb = {"inputs": [jnp.asarray(v) for v in inputs],
          "mask": jnp.ones(batch), "library": jnp.asarray(library)}
    tb = {"inputs": [torch.tensor(v) for v in inputs],
          "mask": torch.ones(batch), "library": torch.tensor(library)}
    k = jax.random.fold_in(key, s)
    jm._state = state
    noise = stack_members([member_draws(jm, jb, k)[0]])
    state, metrics = core(state, jb, k)
    plan = ens._draw_plan(tb)
    loss, _, _ = ens._train_step(ens._make_step(True, True, plan), tb,
                                 noise, [], lr, CLIPNORM)
    theirs.append(float(metrics["loss"]))
    ours.append(float(loss[0]))
  return np.array(ours), np.array(theirs)


def test_multivi_spikes_in_jax_as_in_the_port():
  ours, theirs = trajectories(**SIZE)
  rise = theirs[1:] / theirs[:-1]
  at = int(np.argmax(rise)) + 1
  assert rise[at - 1] > SPIKE, theirs
  assert ours[at] / ours[at - 1] > SPIKE, ours
  np.testing.assert_allclose(ours[:at + 1], theirs[:at + 1], rtol=AGREE)
  assert np.isfinite(ours).all() and ours[-1] < ours[at]


if __name__ == "__main__":
  jax.config.update("jax_platforms", "cpu")
  torch.set_num_threads(4)
  args = [int(v) for v in sys.argv[1:7]] + [float(sys.argv[7])]
  ours, theirs = trajectories(*args)
  print("JAX ", [round(float(v), 1) for v in theirs])
  print("port", [round(float(v), 1) for v in ours])
  print("rel ", [f"{v:.2e}" for v in np.abs(ours - theirs) / np.abs(theirs)])
