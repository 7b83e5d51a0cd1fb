"""The rank functions of ``tests/test_torch_port_mesh.py``.

Each runs in a rank of a gloo world that ``sisua_tpu_torch.parallel.spawn``
starts on the CPU, with one torch thread, and returns numpy results to
the test, which holds them against the JAX package or against the same
call on one device. Imports no JAX.
"""

import numpy as np
import torch
import torch.distributed as dist

from sisua_tpu_torch import models as T
from sisua_tpu_torch.nn import NetConf
from sisua_tpu_torch.parallel import create_mesh
from sisua_tpu_torch.parallel import functional as PF
from sisua_tpu_torch.parallel.mesh import param_plan
from sisua_tpu_torch.rv import RVmeta as R
from sisua_tpu_torch.train.trainer import ClippedOptimizer, Trainer

#: the global batch of every mesh test, and the width that splits
B, G, P, A = 32, 1024, 4, 40


def _threads():
  torch.set_num_threads(1)


def counts(n=B, seed=0):
  """Seeded counts: RNA (n, G), proteins (n, P), cell types (n, 3),
  peaks (n, A)."""
  rng = np.random.default_rng(seed)
  x = rng.poisson(1.0, (n, G)).astype(np.float32)
  x[:, 0] += 1
  return {"x": x,
          "adt": rng.poisson(5.0, (n, P)).astype(np.float32),
          "celltype": np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)],
          "atac": rng.poisson(0.3, (n, A)).astype(np.float32)}


def _nets(dropout=0.1, batchnorm=True):
  return dict(device="cpu",
              encoder=NetConf((8,), batchnorm=batchnorm, dropout=dropout),
              decoder=NetConf((8,), batchnorm=batchnorm, dropout=dropout))


RNA, RNAD = R(G, "zinb", name="rna"), R(G, "zinbd", name="rna")
ADT = R(P, "nb", name="adt")
#: every class whose ``fit`` is ``SingleCellModel.fit``: (constructor,
#: data names)
CLASSES = {
    "VAE": (lambda: T.VAE(RNA, **_nets()), ["x"]),
    "SISUA": (lambda: T.SISUA([RNA, ADT], mask_renorm=True, **_nets()),
              ["x", "adt"]),
    "MISA": (lambda: T.MISA([RNA, ADT], **_nets()), ["x", "adt"]),
    "DeepCountAutoencoder": (lambda: T.DeepCountAutoencoder(
        RNA, **_nets()), ["x"]),
    "SCVI": (lambda: T.SCVI(RNAD, **_nets()), ["x"]),
    "LDVAE": (lambda: T.LDVAE(R(G, "nbd", name="rna"), device="cpu",
                              encoder=NetConf((8,), batchnorm=True)),
              ["x"]),
    "SCALE": (lambda: T.SCALE(RNA, **_nets()), ["x"]),
    "SCALAR": (lambda: T.SCALAR([RNA, ADT], **_nets()), ["x", "adt"]),
    "FVAE": (lambda: T.FVAE(RNA, discriminator_units=(8, 8), **_nets()),
             ["x"]),
    "SemiFVAE": (lambda: T.SemiFVAE([RNA, ADT], discriminator_units=(8, 8),
                                    **_nets()), ["x", "adt"]),
    "TotalVI": (lambda: T.TotalVI([RNAD, ADT], **_nets()), ["x", "adt"]),
    "SCANVI": (lambda: T.SCANVI([RNAD, R(3, "onehot", name="celltype")],
                                **_nets()), ["x", "celltype"]),
    "PEAKVI": (lambda: T.PEAKVI(R(A, "bernoulli", name="atac"), **_nets()),
               ["atac"]),
    "MULTIVI": (lambda: T.MULTIVI([RNAD, R(A, "nb", name="atac")],
                                  **_nets()), ["x", "atac"]),
    "SCScope": (lambda: T.SCScope(RNAD, **_nets(0.0)), ["x"]),
    "AUTOZI": (lambda: T.AUTOZI(RNAD, **_nets()), ["x"]),
}


def class_data(name):
  """A class's data for one global batch. The label mask (fixed, the
  feeder's) gives labels to the first data rank's rows only, so the
  second holds no labelled cell; MULTIVI's batch is mosaic, RNA-only
  and ATAC-only cells in each half."""
  d = counts()
  names = CLASSES[name][1]
  if name == "MULTIVI":
    d["x"][[3, 20, 21]] = 0
    d["atac"][[5, 6, 30]] = 0
  return [d[k] for k in names]


def _feeder(model, data):
  """A feeder of the data's rows in order, with the library stats when
  the model reads them and the fixed mask of ``class_data``."""
  from sisua_tpu_torch.data.feeder import DataFeeder
  library = model._sources(data)[1]
  labels = model.is_semi_supervised
  f = DataFeeder(list(data), library=library, labels_percent=1.0,
                 batch_size=B, shuffle=False)
  f._mask_all = (np.arange(B) < B // 2).astype(np.float32) if labels \
      else np.zeros(B, np.float32)
  return f


def _recording():
  """Patches ``ClippedOptimizer.step`` to keep each step's pre-clip
  gradients (after the sum over 'data'), keyed by parameter."""
  seen = []
  orig = ClippedOptimizer.step

  def step(self):
    seen.append({id(p): p.grad.detach().clone() for p in self.params
                 if p.grad is not None})
    orig(self)
  ClippedOptimizer.step = step
  return seen, orig


def _full_grads(model, seen, plan, view):
  """The recorded gradients by parameter name, split leaves gathered."""
  out = {}
  for k, p in model.module.named_parameters():
    g = seen[0].get(id(p))
    if g is None:
      continue
    if view is not None and k in plan:
      g = PF.all_gather_cat(g, view.model_group, plan[k])
    out[k] = g.numpy()
  return out


def step_of(name, mesh_shape):
  """One training step of a class on one global batch (its feeder's
  rows in order, FVAE's discriminator step included), on a mesh of
  ``mesh_shape`` or on one device (None): loss, gradients, state."""
  _threads()
  make, _ = CLASSES[name]
  model = make()
  mesh = None if mesh_shape is None else create_mesh(*mesh_shape)
  view = None if mesh is None else PF.MeshView(mesh)
  plan = param_plan(dict(model.module.named_parameters()),
                    1 if view is None else view.n_model)
  feeder = _feeder(model, class_data(name))
  seen, orig = _recording()
  try:
    model.fit(feeder, epochs=1, batch_size=B, valid_freq=0, patience=0,
              mesh=mesh)
  finally:
    ClippedOptimizer.step = orig
  state = {k: v.detach().numpy().copy()
           for k, v in model.module.state_dict().items()}
  out = {"loss": float(model.history["loss"][0]),
         "grads": _full_grads(model, seen, plan, view),
         "state": state, "split": sorted(plan)}
  if model.aux is not None:
    out["aux"] = {k: v.detach().numpy().copy()
                  for k, v in model.aux.state_dict().items()}
  return out


def every_class_step():
  """``step_of`` of every class on the 2 × 2 mesh."""
  return {name: step_of(name, (2, 2)) for name in CLASSES}


def grid():
  """This rank's coordinates and the mesh's rank grid; whether a 3 × 2
  mesh of this world raises as JAX's assertion does."""
  mesh = create_mesh(2, 2)
  view = PF.MeshView(mesh)
  try:
    create_mesh(3, 2)
    refused = None
  except AssertionError as e:
    refused = str(e)
  return {"rank": dist.get_rank(), "coords": (view.data_rank,
                                              view.model_rank),
          "grid": mesh.mesh.tolist(), "refused": refused}


# ------------------------------------------------- SCVI against JAX's step
def scvi_parity_model(state=None):
  """SCVI at G genes, BatchNorm on, dropout 0 (its library encoder's
  too); ``state`` a converted state dict."""
  m = T.SCVI(RNAD, latents=R(8, "diag", name="latents"),
             encoder=NetConf((16,), batchnorm=True),
             encoder_l=NetConf((8,), batchnorm=True),
             decoder=NetConf((16,), batchnorm=True), device="cpu")
  if state is not None:
    m.module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                              for k, v in state.items()})
  return m


def mesh_step(model, batch, mesh_shape, noise=None, lr=1e-3,
              clipnorm=100.0):
  """One ``_train_step`` on the global ``batch`` with ``fit``'s mesh
  set-up (the optimizer, the model axis, this rank's rows; ``noise``:
  the global batch's draws, fed). The loss and metrics, the full
  pre-clip gradients and the state after the step."""
  mesh = create_mesh(*mesh_shape)
  view = PF.MeshView(mesh)
  model._fit_optimizer(Trainer(learning_rate=lr, clipnorm=clipnorm), ())
  plan = param_plan(dict(model.module.named_parameters()), view.n_model)
  split = PF.ModelSplit(model.module, view, model.optimizer) \
      if view.n_model > 1 else None
  model._split = split
  model.optimizer.split_ids = None if split is None else split.ids
  lo, hi = view.rows(len(batch["mask"]))
  local = {k: ([torch.as_tensor(x[lo:hi]) for x in v] if k == "inputs"
               else torch.as_tensor(v[lo:hi])) for k, v in batch.items()}
  seen, orig = _recording()
  try:
    with PF.active(view), PF.batch_rows(len(batch["mask"]), lo, hi):
      metrics = model._train_step(local, noise=None if noise is None else
                                  [torch.as_tensor(n[lo:hi]) for n in noise])
    grads = _full_grads(model, seen, plan, view)
    if split is not None:
      split.close()
  finally:
    ClippedOptimizer.step = orig
    model._split = None
  return {"metrics": {k: float(v) for k, v in metrics.items()},
          "grads": grads,
          "state": {k: v.detach().numpy().copy()
                    for k, v in model.module.state_dict().items()}}


def scvi_parity_step(state, batch, noise):
  """The JAX-parity SCVI step on the 2 × 2 mesh."""
  _threads()
  return mesh_step(scvi_parity_model(state), batch, (2, 2), noise)


# ------------------------------------------------------------- the loops
def loops_model():
  """Without BatchNorm: a BatchNorm-fed bias moves by ±lr a step on
  rounding noise (test module docstring), and the validation's running
  statistics would carry that drift over epochs."""
  return T.VAE(RNA, seed=3, **_nets(batchnorm=False))


LOOPS = {
    "streaming": dict(),
    "scan_steps": dict(scan_steps=2),
    "resident": dict(device_cache=True),
    # chunks of one batch: 10 of them, 6 resident, the last wrapping
    "out_of_core": dict(device_cache=True, hbm_budget_bytes=8 * B * G * 4),
}


def loop_data():
  """101 training cells (not a multiple of n_data; 300 for the out-of-core
  loop, so that its chunks outgrow the budget) and 40 validation cells (a
  last batch of 8)."""
  d = counts(341, seed=4)["x"]
  return d[:101], d[:300], d[300:]


def loops(mesh_shape):
  """Every loop, 2 epochs with validation, on a mesh or on one device:
  the histories (and the out-of-core plan)."""
  _threads()
  mesh = None if mesh_shape is None else create_mesh(*mesh_shape)
  x, many, valid = loop_data()
  out = {}
  for name, kw in LOOPS.items():
    m = loops_model()
    m.fit(many if name == "out_of_core" else x, valid=valid, epochs=2,
          batch_size=B, valid_freq=0, patience=0, mesh=mesh, **kw)
    out[name] = {k: list(v) for k, v in m.history.items()
                 if k not in ("epoch_time", "cells_per_sec")}
    if name == "out_of_core":
      out["plan"] = dict(m.trainer._oc_plan)
  m = loops_model()
  try:
    m.fit(x, epochs=1, batch_size=31, device_cache=True, mesh=mesh)
    out["odd_batch"] = None
  except AssertionError as e:
    out["odd_batch"] = str(e)
  bad = x.copy()
  bad[70, 5] = np.nan  # a row of the second data rank's part of a batch
  m = loops_model()
  m.fit(bad, epochs=3, batch_size=B, device_cache=True, mesh=mesh)
  out["nan"] = list(m.history["loss"])
  return out


# ------------------------------------------------------------- serving
def served_model():
  """A VAE trained one epoch on one device, the same on every rank."""
  m = T.SISUA([R(64, "zinb", name="rna"), R(P, "nb", name="adt")],
              seed=5, **_nets())
  d = counts(96, seed=6)
  m.fit([d["x"][:, :64], d["adt"]], epochs=1, batch_size=B)
  return m, d["x"][:60, :64], d["adt"][:60]


def serving(mesh_shape):
  """Every serving call on 60 cells (a ragged last batch), over a mesh
  or on one device, each from the generator's same state."""
  _threads()
  from sisua_tpu_torch.analysis import Posterior
  mesh = None if mesh_shape is None else create_mesh(*mesh_shape)
  m, x, y = served_model()
  out = {}

  def fresh():
    m.generator.manual_seed(11)
  fresh()
  px, qz = m.predict([x, y], sample_shape=(2,), batch_size=B,
                     device_cache=True, mesh=mesh)
  out["predict"] = [px[0].mean().numpy(), qz.mean().numpy()]
  fresh()
  xm, zm = m.predict_mean(x, sample_shape=(3,), batch_size=B, mesh=mesh)
  out["predict_mean"] = [xm[0], zm[0]]
  fresh()
  out["normalized"] = m.get_normalized_expression(
      x, sample_shape=(2,), batch_size=B, reduce_mc=False, mesh=mesh)
  fresh()
  out["llk"] = m.compute_llk([x, y], {"t": [x, y]}, sample_shape=(2,),
                             batch_size=B, mesh=mesh)
  fresh()
  out["mllk"] = m.marginal_log_prob([x, y], sample_shape=3, batch_size=25,
                                    mesh=mesh)
  fresh()
  labels = np.array(["a", "b", "c"])[np.arange(60) % 3]
  out["de"] = m.differential_expression(
      x, labels, group1="a", sample_shape=(4,), n_pairs=200, batch_size=B,
      mesh=mesh)
  fresh()
  post = Posterior(m, {"transcriptomic": x, "proteomic": y},
                   sample_shape=2, batch_size=B, device_cache=True,
                   mesh=mesh)
  out["posterior"] = {k: v for k, v in post.save_scores().items()
                      if "dci" not in k}
  return out


# ----------------------------------------------------------- checkpoint
def checkpoint(path):
  """SCVI trained 2 epochs on the 2 × 2 mesh (its heads split) and saved
  by rank 0; then every rank loads it and trains on the mesh again."""
  _threads()
  mesh = create_mesh(2, 2)
  m = scvi_parity_model()
  x = counts(64, seed=7)["x"]
  m.fit(x, epochs=2, batch_size=B, mesh=mesh, checkpoint_path=path,
        patience=0)
  m.save_weights(path)
  state = {k: v.detach().numpy().copy()
           for k, v in m.module.state_dict().items()}
  back = T.load_model(path, device="cpu")
  back.fit(x, epochs=1, batch_size=B, mesh=mesh, patience=0)
  return {"state": state, "resumed": list(back.history["loss"]),
          "after": {k: v.detach().numpy().copy()
                    for k, v in back.module.state_dict().items()}}


# ------------------------------------------------------------------ fleets
def fleet_refusal():
  """``n_models`` that does not divide over the world."""
  from sisua_tpu_torch.train import VmapEnsemble
  ens = VmapEnsemble(lambda s: T.VAE(R(16, "zinb", name="rna"), seed=s,
                                     device="cpu"), n_models=3)
  try:
    ens.fit(counts(64)["x"][:, :16], epochs=1, batch_size=B,
            mesh=create_mesh(2, 1))
  except AssertionError as e:
    return str(e)
  return None


def hyper_vmap():
  """``fit_hyper_vmap`` over the 2-rank mesh: 2 rates × 1 seed."""
  _threads()
  from sisua_tpu_torch.models.hyper_params import fit_hyper_vmap
  res = fit_hyper_vmap(lambda s: T.VAE(R(16, "zinb", name="rna"), seed=s,
                                       **_nets()),
                       counts(64)["x"][:, :16], learning_rates=(1e-3, 3e-3),
                       epochs=1, batch_size=B, mesh=create_mesh(2, 1))
  return {"trials": res["trials"], "best": res["best"]}


def fleet(mesh_shape, n_models=4, shared_batches=True, name="SCVI"):
  """A 4-member fleet, 2 epochs (a per-member rate when not shared), on
  a mesh of ``mesh_shape`` or unsharded: the history and every member's
  state."""
  _threads()
  from sisua_tpu_torch.train import VmapEnsemble
  mesh = None if mesh_shape is None else create_mesh(*mesh_shape)
  make = {"SCVI": lambda s: T.SCVI(R(48, "zinbd", name="rna"), seed=s,
                                   **_nets()),
          "AUTOZI": lambda s: T.AUTOZI(R(48, "zinbd", name="rna"), seed=s,
                                       **_nets())}[name]
  ens = VmapEnsemble(make, n_models=n_models)
  lrs = 1e-3 if shared_batches else [1e-3 * (i + 1) for i in range(n_models)]
  ens.fit(counts(96)["x"][:, :48], epochs=2, batch_size=B,
          learning_rate=lrs, shared_batches=shared_batches, mesh=mesh)
  return {"loss": ens.history["loss"],
          "members": [{k: v.detach().numpy().copy() for k, v in
                       m.module.state_dict().items()} for m in ens.models],
          "steps": [m.step for m in ens.models]}


# -------------------------------------------------- what a test spawns
def parity_suite(state, batch, noise):
  """The rank grid and the JAX-parity SCVI step, on the 2 × 2 mesh."""
  return {"grid": grid(), "scvi": scvi_parity_step(state, batch, noise)}


def serving_suite(path):
  """Mesh serving, then the checkpoint round trip, on the 2 × 2 mesh."""
  return {"serving": serving((2, 2)), "checkpoint": checkpoint(path)}


def fleet_suite():
  """The fleet over 2 ranks (shared batches, then each member its own
  batches and rate), its refusal, and ``fit_hyper_vmap``."""
  return {"shared": fleet((2, 1)),
          "own": fleet((2, 1), shared_batches=False),
          "autozi": fleet((2, 1), shared_batches=False, name="AUTOZI"),
          "refusal": fleet_refusal(), "hyper": hyper_vmap()}


def fail_in_rank_one():
  """Rank 1 raises; rank 0 would wait for it in an all-reduce."""
  if dist.get_rank() == 1:
    raise ValueError("rank 1 fails")
  dist.all_reduce(torch.zeros(1))


def one_rank():
  """A fit and a device-cached ``predict`` over a 1 × 1 mesh, beside the
  same calls without a mesh: every collective of a one-rank group is
  skipped, so they are the single-device calls."""
  _threads()
  mesh = create_mesh()
  x = counts(64, seed=8)["x"][:, :48]
  out = {}
  for tag, m_ in (("mesh", mesh), ("single", None)):
    m = T.VAE(R(48, "zinb", name="rna"), seed=2, **_nets())
    m.fit(x, epochs=2, batch_size=B, mesh=m_)
    m.generator.manual_seed(4)
    px, qz = m.predict(x, sample_shape=(2,), batch_size=B,
                       device_cache=True, mesh=m_)
    out[tag] = {"loss": list(m.history["loss"]),
                "predict": [px.mean().numpy(), qz.mean().numpy()]}
  return out
