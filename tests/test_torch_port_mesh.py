"""The port's device mesh (``sisua_tpu_torch.parallel``) against the JAX
mesh and against one device.

The ranks are gloo ranks on the CPU, started by ``parallel.spawn``; their
functions are in ``tests/torch_port_mesh_ranks.py`` (no JAX there). The
global batch is 32 and the RNA width 1,024, so the model axis splits the
gene heads. A mesh step must be the single-device step on the same
global batch, from the same weights and the same draws, up to the order
of sums (JAX's GSPMD semantics):

* the rank grid and ``create_mesh``'s refusal, against JAX's;
* the split plan against JAX's ``_param_spec`` on a (4, 2) mesh;
* SCVI's 2 × 2 step against the JAX mesh step at converted weights (JAX's
  noise recovered as eps = (z − loc)/scale and fed to each rank);
* every ``SingleCellModel.fit`` class's 2 × 2 step against its single
  step, dropout on, the label mask giving the second data rank no
  labelled cell (SISUA with ``mask_renorm``, TotalVI's protein mask,
  SCANVI), MULTIVI on mosaic rows;
* the three loops over 2 epochs, the resident loop's odd batch, a NaN in
  one rank's rows;
* every serving call, ``differential_expression`` and ``Posterior``'s
  scores; a mesh checkpoint in both packages' ``load_model``;
* the fleet over 2 ranks, member by member.

A bias feeding a BatchNorm has a true gradient of 0, computed as rounding
noise on both sides, so Adam's first step moves it by ±lr: where a
gradient is within the gradient tolerance of 0, a parameter is held to
2·lr per step; elsewhere to 1e-5 relative.

Each world is started once per session (``_shared``): the test processes
of one run share its results through a file beside their temporary
directories, under a lock, so a world never runs twice however the tests
are spread over them.
"""

import fcntl
import functools
import os
import pickle

import numpy as np
import pytest

import torch_port_mesh_ranks as R
from sisua_tpu_torch import convert
from sisua_tpu_torch.parallel import create_mesh, param_plan, spawn
from torch_port_threads import _one_thread  # noqa: F401

LR = 1e-3
TIMEOUT = 300


def _close(a, b, rtol, atol, what):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                             atol=atol, err_msg=what)


def _grads_close(got, want, rtol, what):
  """Every gradient within ``rtol`` plus an atol of ``rtol``·max|g|."""
  assert sorted(got) == sorted(want), what
  scale = max(float(np.abs(g).max()) for g in want.values())
  for k in want:
    _close(got[k], want[k], rtol, rtol * scale, f"{what}: grad {k}")
  return rtol * scale


def _params_close(got, want, grads, g_atol, steps, what):
  """Parameters after ``steps`` Adam steps (module docstring)."""
  for k, g in grads.items():
    loose = np.abs(g) <= g_atol
    d = np.abs(got[k] - want[k])
    assert (d[loose] <= 2 * LR * steps + 1e-6).all(), f"{what}: {k}"
    assert (d[~loose] <= 1e-5 * np.abs(want[k][~loose]) + 1e-6).all(), \
        f"{what}: {k} off by {d[~loose].max()}"


def _shared(factory, name, compute):
  """``compute()`` once for the session's test processes: the first one
  to ask runs it under a file lock and pickles the result beside the
  processes' temporary directories; the others wait and read it."""
  root = factory.getbasetemp()
  if os.environ.get("PYTEST_XDIST_WORKER"):
    root = root.parent  # shared by the session's workers
  path = os.path.join(str(root), f"mesh_{name}.pkl")
  with open(path + ".lock", "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    try:
      if os.path.isfile(path):
        with open(path, "rb") as f:
          return pickle.load(f)
      out = compute(str(root))
      with open(path, "wb") as f:
        pickle.dump(out, f)
      return out
    finally:
      fcntl.flock(lock, fcntl.LOCK_UN)


# ------------------------------------------------------------- the JAX side
def _jax_scvi():
  from sisua_tpu.models import SCVI as JSCVI
  from sisua_tpu.rv import RVmeta as JRV
  return JSCVI(JRV(R.G, "zinbd", name="rna"),
               latents=dict(dim=8, posterior="diag", name="latents"),
               encoder={"units": [16], "batchnorm": True},
               encoder_l={"units": [8], "batchnorm": True},
               decoder={"units": [16], "batchnorm": True})


def _jax_shapes(jm):
  import jax
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  return jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))


def _jax_scvi_step():
  """One SCVI train step on JAX's 2 × 2 mesh (``shard_params``,
  ``shard_batch``) at random weights, then optax's clipped Adam."""
  import jax
  import jax.numpy as jnp
  import optax
  from sisua_tpu.parallel import (create_mesh as jax_mesh,
                                  replicated_sharding, shard_batch,
                                  shard_params)
  jm = _jax_scvi()
  shapes = _jax_shapes(jm)
  rng = np.random.default_rng(2)

  def fill(path, s):
    name = path[-1].key
    if name == "var":
      return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
    if name == "kernel":
      return rng.normal(0, 1 / np.sqrt(s.shape[0]), s.shape).astype(
          np.float32)
    return rng.normal(0, 0.2, s.shape).astype(np.float32)
  params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
  bs = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
  x = R.counts()["x"]
  logc = np.log(x.sum(1) + 1e-8)
  lib = np.stack([np.full(R.B, logc.mean()), np.full(R.B, logc.var())],
                 1).astype(np.float32)
  batch = {"inputs": [x], "library": lib,
           "mask": np.ones((R.B,), np.float32)}
  mesh = jax_mesh(2, 2, jax.devices()[:4])
  p = shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh)
  b = shard_batch(jax.tree_util.tree_map(jnp.asarray, batch), mesh)
  bs_r = jax.device_put(jax.tree_util.tree_map(jnp.asarray, bs),
                        replicated_sharding(mesh))
  key = jax.random.key(3, impl="rbg")
  (loss, (met, new_bs, out)), grads = jax.jit(jax.value_and_grad(
      lambda q: jm._loss(q, bs_r, b, key, 1.0, training=True),
      has_aux=True))(p)
  noise = []
  for q, z in zip(out.latents, out.latent_samples):
    q = getattr(q, "base", q)
    scale = getattr(q, "scale_diag", getattr(q, "scale", None))
    noise.append(np.asarray((z - q.loc) / scale, np.float32))
  tx = optax.chain(optax.clip_by_global_norm(100.0), optax.adam(LR))
  updates, _ = tx.update(grads, tx.init(p), p)
  after = optax.apply_updates(p, updates)
  get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa
  return dict(params=params, bs=bs, batch=batch, noise=noise,
              loss=float(loss), metrics=get(met), new_bs=get(new_bs),
              grads=get(grads), after=get(after))


@pytest.fixture(scope="session")
def parity(tmp_path_factory):
  """The 4 ranks' grid and SCVI step at the JAX step's weights, batch and
  noise, and the JAX step."""
  def run(_):
    j = _jax_scvi_step()
    port = R.scvi_parity_model()
    state = {k: v.numpy() for k, v in convert.jax_to_torch(
        port.module, j["params"], j["bs"]).items()}
    return spawn(R.parity_suite, 4, args=(state, j["batch"], j["noise"]),
                 timeout=TIMEOUT), j
  return _shared(tmp_path_factory, "parity", run)


@pytest.fixture(scope="session")
def classes(tmp_path_factory):
  """Every class's step on the 2 × 2 mesh, by rank."""
  return _shared(tmp_path_factory, "classes", lambda _: spawn(
      R.every_class_step, 4, timeout=TIMEOUT))


# ------------------------------------------------------------------- (1)
def test_rank_grid_is_jax_device_grid(parity):
  """Rank d·n_model + m is data row d, model column m: JAX's
  ``reshape(n_data, n_model)`` of its device list; a 3 × 2 mesh of four
  raises in both packages, and no world, in the port."""
  import jax
  from sisua_tpu.parallel import create_mesh as jax_mesh
  jgrid = np.vectorize(lambda d: d.id)(jax_mesh(2, 2,
                                                jax.devices()[:4]).devices)
  for r, out in enumerate(parity[0]):
    assert out["grid"]["rank"] == r
    assert out["grid"]["grid"] == jgrid.tolist() == [[0, 1], [2, 3]]
    assert out["grid"]["coords"] == (r // 2, r % 2)
    assert "3×2 mesh cannot cover 4 devices" in out["grid"]["refused"]
  with pytest.raises(AssertionError, match="cannot cover"):
    jax_mesh(3, 2, jax.devices()[:4])
  with pytest.raises(RuntimeError, match="spawn"):
    create_mesh(2, 2)


# ------------------------------------------------------------------- (2)
_PLAN_MODELS = {
    "SCVI": lambda M, RV, **kw: M.SCVI(RV(R.G, "zinbd", name="rna"), **kw),
    "TotalVI": lambda M, RV, **kw: M.TotalVI(
        [RV(R.G, "zinbd", name="rna"), RV(R.P, "nb", name="adt")], **kw),
    "SCScope": lambda M, RV, **kw: M.SCScope(RV(R.G, "zinbd", name="rna"),
                                             **kw),
}


@pytest.mark.parametrize("name", ["SCVI", "TotalVI", "SCScope"])
def test_split_plan_is_jax_param_spec(name):
  """``param_plan`` on n_model = 2 names the leaves JAX's ``_param_spec``
  column-shards on a (4, 2) mesh: SCVI's three gene heads, TotalVI's
  RNA heads and protein-free leaves, SCScope's D × D imputer."""
  import jax
  import sisua_tpu.models as J
  from jax.sharding import PartitionSpec as P
  from sisua_tpu.parallel import create_mesh as jax_mesh
  from sisua_tpu.parallel.mesh import _param_spec
  from sisua_tpu.rv import RVmeta as JRV
  from sisua_tpu_torch import models as T
  from sisua_tpu_torch.rv import RVmeta as TR
  jm = _PLAN_MODELS[name](J, JRV)
  mesh = jax_mesh(4, 2, jax.devices()[:8])
  want = {"/".join(k.key for k in path) for path, leaf in
          jax.tree_util.tree_leaves_with_path(_jax_shapes(jm)["params"])
          if _param_spec(path, leaf, mesh) == P(None, "model")}
  tm = _PLAN_MODELS[name](T, TR, device="cpu")
  plan = param_plan({k: p.shape for k, p in tm.module.named_parameters()},
                    2)
  got = {"/".join(convert.flax_param_path(tm.module, k)) for k in plan}
  assert got == want and want
  if name == "SCScope":
    assert "Imputation/kernel" in got


# ------------------------------------------------------------------- (3)
def test_scvi_step_matches_the_jax_mesh_step(parity):
  """SCVI at converted weights on both 2 × 2 meshes: the loss and the
  ELBO terms, the full gradients (rtol 1e-4, atol 1e-4·max|g|), the
  running statistics (rtol 1e-5) and the clipped-Adam parameters."""
  outs, j = parity
  port = R.scvi_parity_model()
  jgrads = {k: v.numpy() for k, v in convert.jax_to_torch(
      port.module, j["grads"], params_only=True).items()}
  jafter = {k: v.numpy() for k, v in convert.jax_to_torch(
      port.module, j["after"], j["new_bs"]).items()}
  for r, out in enumerate(outs):
    t = out["scvi"]
    np.testing.assert_allclose(t["metrics"]["loss"], j["loss"], rtol=1e-4)
    for k in ("llk_x", "klqp_z", "klqp_z1", "elbo"):
      np.testing.assert_allclose(t["metrics"][k], float(j["metrics"][k]),
                                 rtol=1e-4, err_msg=k)
    g_atol = _grads_close(t["grads"], jgrads, 1e-4, f"rank {r}")
    for k, v in jafter.items():
      if "running" in k:
        _close(t["state"][k], v, 1e-5, 1e-6, k)
    _params_close(t["state"], jafter, jgrads, g_atol, 1, f"rank {r}")


# ------------------------------------------------------------------- (4)
@functools.lru_cache(maxsize=None)
def _single_step(name):
  return R.step_of(name, None)


@pytest.mark.parametrize("name", list(R.CLASSES))
def test_every_class_step_equals_the_single_step(classes, name):
  """One step on the 2 × 2 mesh against one device on the same global
  batch, weights and draws (dropout on): the loss (rtol 1e-5), every
  gradient (rtol 1e-5, atol 1e-5·max|g|), the running statistics and
  the parameters; FVAE's discriminator after its step. Every rank holds
  the same whole model."""
  want = _single_step(name)
  outs = [o[name] for o in classes]
  got = outs[0]
  np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
  g_atol = _grads_close(got["grads"], want["grads"], 1e-5, name)
  for k, v in want["state"].items():
    if "running" in k:
      _close(got["state"][k], v, 1e-5, 1e-6, k)
  _params_close(got["state"], want["state"], want["grads"], g_atol, 1, name)
  if "aux" in want:  # one Adam step of the discriminator's rate, 1e-4
    for k, v in want["aux"].items():
      _close(got["aux"][k], v, 1e-5, 2e-4, f"aux {k}")
  for other in outs[1:]:
    for k, v in got["state"].items():
      np.testing.assert_array_equal(other["state"][k], v)
  # the model axis split the gene heads, where there are any
  assert got["split"] or name == "PEAKVI"


def test_every_class_is_covered():
  from sisua_tpu_torch import models as T
  own_fit = {"SOLO", "CellAssign"}  # their own fit takes no mesh in JAX
  assert sorted(R.CLASSES) == sorted(c.__name__ for c in T.get_all_models()
                                     if c.__name__ not in own_fit)


# ------------------------------------------------------------------- (5)
@pytest.fixture(scope="session")
def loops(tmp_path_factory):
  return _shared(tmp_path_factory, "loops", lambda _: (
      spawn(R.loops, 4, args=((2, 2),), timeout=TIMEOUT), R.loops(None)))


@pytest.mark.parametrize("loop", list(R.LOOPS))
def test_loops_equal_one_device(loops, loop):
  """Two epochs with validation on 101 cells (3 batches of 32; the
  out-of-core loop 300 in 10 chunks of a batch, 4 of them streamed; 40
  validation cells, a last batch of 8): every history entry within 1e-4
  relative of one device's, the same on every rank."""
  outs, single = loops
  want = single[loop]
  for out in outs:
    got = out[loop]
    assert sorted(got) == sorted(want) and "val_loss" in got
    for k in want:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
  if loop == "out_of_core":
    for plan in (outs[0]["plan"], single["plan"]):
      assert (plan["n_chunks"], plan["n_resident"]) == (10, 6)


def test_resident_batch_must_divide_and_nan_stops_every_rank(loops):
  """A resident batch of 31 over 2 data rows raises JAX's assertion; a
  NaN in one row stops every rank at the epoch one device stops at."""
  outs, single = loops
  assert single["odd_batch"] is None
  for out in outs:
    assert "must divide evenly over the 2-way data mesh axis" \
        in out["odd_batch"]
    assert len(out["nan"]) == len(single["nan"]) < 3
    assert not np.isfinite(out["nan"][-1])
    np.testing.assert_allclose(out["nan"][:-1], single["nan"][:-1],
                               rtol=1e-4)


# ------------------------------------------------------------------- (6)
@pytest.fixture(scope="session")
def served(tmp_path_factory):
  def run(root):
    path = os.path.join(root, "mesh_checkpoint")
    return (spawn(R.serving_suite, 4, args=(path,), timeout=TIMEOUT),
            R.serving(None), path)
  return _shared(tmp_path_factory, "served", run)


@pytest.mark.parametrize("call", ["predict", "predict_mean", "normalized",
                                  "llk", "mllk", "de", "posterior"])
def test_mesh_serving_equals_one_device(served, call):
  """On every rank each serving call returns the single-device result
  (rtol 1e-5): predict, predict_mean over 60 cells (a ragged last batch),
  the normalized draws, compute_llk, marginal_log_prob,
  differential_expression and ``Posterior(mesh=)``'s scores."""
  outs, single, _ = served
  want = single[call]
  for out in outs:
    got = out["serving"][call]
    if isinstance(want, dict):
      assert sorted(got) == sorted(want)
      for k in want:
        if isinstance(want[k], np.ndarray) and want[k].dtype.kind in "US":
          np.testing.assert_array_equal(got[k], want[k])
        else:
          np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                     atol=1e-6, err_msg=k)
    elif isinstance(want, list):
      for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    else:
      np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- (7)
def test_mesh_checkpoint_loads_in_both_packages(served):
  """SCVI trained on the 2 × 2 mesh (heads split) and saved by rank 0
  loads whole in the JAX ``load_model`` and in the port on one device,
  and trains on from it on the mesh."""
  import sisua_tpu.models as J
  from sisua_tpu_torch.models import load_model
  outs, _, path = served
  state = outs[0]["checkpoint"]["state"]
  port = load_model(path, device="cpu")
  for k, v in port.module.state_dict().items():
    np.testing.assert_array_equal(v.numpy(), state[k])
  jm = J.load_model(path)
  back = convert.jax_to_torch(port.module, jm.params, jm.batch_stats)
  for k, v in back.items():
    np.testing.assert_array_equal(v.numpy(), state[k])
  for out in outs:
    resumed = out["checkpoint"]
    assert len(resumed["resumed"]) == 1
    assert np.isfinite(resumed["resumed"]).all()
    for k, v in outs[0]["checkpoint"]["after"].items():
      np.testing.assert_array_equal(resumed["after"][k], v)


# ------------------------------------------------------------------- (8)
@pytest.fixture(scope="session")
def fleets(tmp_path_factory):
  return _shared(tmp_path_factory, "fleets", lambda _: (
      spawn(R.fleet_suite, 2, timeout=TIMEOUT),
      {"shared": R.fleet(None), "own": R.fleet(None, shared_batches=False),
       "autozi": R.fleet(None, shared_batches=False, name="AUTOZI")}))


def _bn_biases(state):
  """Dense biases that feed a BatchNorm (``dense{i}`` before ``bn{i}``),
  and that BatchNorm's running mean, which tracks the bias."""
  biases = {k for k in state if k.endswith(".bias") and ".dense" in k
            and k.replace(".dense", ".bn") in state}
  return biases | {k.replace(".dense", ".bn")[:-len("bias")]
                   + "running_mean" for k in biases}


@pytest.mark.parametrize("case", ["shared", "own", "autozi"])
def test_fleet_over_two_ranks_equals_the_unsharded_fleet(fleets, case):
  """4 members over 2 ranks, 2 epochs (3 steps each), against the
  unsharded fleet, member by member: the losses (rtol 1e-4), the steps,
  each member's state (rtol 1e-3; a BatchNorm-fed bias within 2·lr per
  step, and so its BatchNorm's running mean: module docstring); every
  rank holds every member. 'own':
  each member its own batches and rate; 'autozi': δ's draws read every
  member's α, β."""
  outs, single = fleets
  want = single[case]
  for out in outs:
    got = out[case]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["steps"] == want["steps"] == [6] * 4
    for i in range(4):
      loose = _bn_biases(want["members"][i])
      for k, v in want["members"][i].items():
        if k in loose:
          assert np.abs(got["members"][i][k] - v).max() <= 2 * 4e-3 * 6
        else:
          _close(got["members"][i][k], v, 1e-3, 1e-4, f"member {i} {k}")
    for i in range(4):
      for k, v in outs[0][case]["members"][i].items():
        np.testing.assert_array_equal(got["members"][i][k], v)


def test_fleet_refuses_members_that_do_not_divide_and_searches(fleets):
  """3 members over 2 ranks raise JAX's assertion; ``fit_hyper_vmap``
  over the mesh trains both trials and agrees on every rank."""
  outs, _ = fleets
  for out in outs:
    assert "must divide evenly over the 2-device mesh" in out["refusal"]
    trials = out["hyper"]["trials"]
    assert [t["config"]["learning_rate"] for t in trials] == [1e-3, 3e-3]
    assert all(np.isfinite(t["loss"]) for t in trials)
    assert out["hyper"] == outs[0]["hyper"]


def test_world_reraises_a_rank_failure_and_stops():
  """A rank's exception is raised again in the caller, the other rank
  stopped (it would wait in a collective), within the timeout."""
  with pytest.raises(ValueError, match="rank 1 fails"):
    spawn(R.fail_in_rank_one, 2, timeout=60)
