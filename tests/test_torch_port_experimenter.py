"""The port's experiment manager against the JAX package's: config
plumbing and hashes, the sqlite scoreboard, both experimenters' hooks with
``fit`` recorded (no training) on ``synthetic500``, ``fit_hyper``'s
proposals, and multirun. Models are built on ``device="cpu"``.

The JAX modules are imported by the tests that use them, not at the top:
multirun's spawned processes import this module for ``QuickExperimenter``
and need the port only."""

import dataclasses
import json
import math
import os
import sqlite3

import numpy as np
import pytest
import yaml

import sisua_tpu_torch.models.base as TB
import sisua_tpu_torch.models.hyper_params as TH
import sisua_tpu_torch.train.experimenter as TX
from sisua_tpu_torch.train.scoreboard import ScoreBoard as TScoreBoard


@pytest.fixture(scope="module")
def J():
  """The JAX package's modules under test."""
  import types

  import sisua_tpu.models.base as JB
  import sisua_tpu.models.hyper_params as JH
  import sisua_tpu.train.experimenter as JX
  from sisua_tpu.train.scoreboard import ScoreBoard
  return types.SimpleNamespace(B=JB, H=JH, X=JX, ScoreBoard=ScoreBoard)


# ---------------------------------------------------------------------------
# config plumbing (the JAX tests' cases)
# ---------------------------------------------------------------------------
OVERRIDES = [
    ["model.name=vae,dca", "train.epochs=2"],
    ["encoder.units=[64,64]"],
    ["encoder.units=[64,64],[32]"],
    ["a=1,2", "b=x"],
    ['x=["a]b",1]'],
    ['note="hello, world"'],
    ["train.learning_rate=1e-3", "model.beta=1.0", "dataset.name=synthetic",
     "flag=true", "none=null", "s='a,b'"],
    [],
]


@pytest.mark.parametrize("args", OVERRIDES, ids=range(len(OVERRIDES)))
def test_parse_overrides_equal_jax(J, args):
  JX = J.X
  assert TX.parse_overrides(args) == JX.parse_overrides(args)
  for a in args:
    v = a.split("=", 1)[1]
    assert TX._split_grid(v) == JX._split_grid(v)


def test_parse_overrides_rejects_what_jax_rejects(J):
  for mod in (J.X, TX):
    with pytest.raises(ValueError):
      mod.parse_overrides(["oops"])


def test_nested_set_and_hash_equal_jax(J, tmp_path):
  JX = J.X
  cfg = {"model": {"name": "vae"}, "train": {"epochs": 5}}
  for mod in (JX, TX):
    c = json.loads(json.dumps(cfg))
    mod.nested_set(c, "model.beta", 2.0)
    assert c["model"]["beta"] == 2.0
  h1 = TX.config_hash(cfg, exclude_keys=("train",))
  assert h1 == JX.config_hash(cfg, exclude_keys=("train",))
  TX.nested_set(cfg, "train.epochs", 99)
  assert TX.config_hash(cfg, exclude_keys=("train",)) == h1
  TX.nested_set(cfg, "model.beta", 3.0)
  assert TX.config_hash(cfg, exclude_keys=("train",)) != h1
  # the experiment directory and its config.yaml, from the shared base
  # config with overrides, over a grid that moves the hash
  je = JX.SisuaExperimenter(save_path=str(tmp_path / "j"))
  te = TX.SisuaExperimenter(save_path=str(tmp_path / "t"), device="cpu")
  for grid in TX.parse_overrides(
      ["model.name=sisua,scvi", "dataset.name=synthetic10k,citeseqsim",
       "train.learning_rate=1e-3", "model.encoder.units=[32,32]",
       "variables.latents.event_shape=8"]):
    jc, tc = je.load_config(grid), te.load_config(grid)
    assert tc == jc
    jd, td = je.experiment_dir(jc), te.experiment_dir(tc)
    assert os.path.basename(td) == os.path.basename(jd)
    with open(os.path.join(td, "config.yaml")) as f:
      assert yaml.safe_load(f) == jc
  with pytest.raises(SystemExit, match="--config requires a value"):
    from sisua_tpu_torch.cli.train import main
    main(["model.name=vae", "--config"])


# ---------------------------------------------------------------------------
# scoreboard
# ---------------------------------------------------------------------------
def _same_nested(a, b):
  assert set(a) == set(b)
  for k in a:
    assert set(a[k]) == set(b[k]), k
    for m in a[k]:
      x, y = a[k][m], b[k][m]
      assert x == y or (math.isnan(x) and math.isnan(y)), (k, m, x, y)


def test_scoreboard_rows_and_reads_equal_jax(J, tmp_path):
  writes = [("t1", "run_a", {"loss": 1.0, "f1": 0.5, "x": float("nan"),
                             "s": "text"}),
            ("t1", "run_b", {"loss": 2.0, "x": float("nan")}),
            ("t1", "run_c", {"x": float("nan")}),
            ("t2", "run_a", {"loss": 3.0}),
            ("t1", "run_a", {"loss": 0.5})]
  boards = {}
  for name, cls in (("j", J.ScoreBoard), ("t", TScoreBoard)):
    sb = cls(str(tmp_path / f"{name}.db"))
    for tab, uid, scores in writes:
      sb.write_scores(tab, uid, scores)
    sb.write_scores("t2", "run_a", {"loss": 9.0}, replace=False)
    sb.write_error("run_c", "boom")
    boards[name] = sb
  j, t = boards["j"], boards["t"]
  q = "SELECT tab, uid, metric, value FROM scores ORDER BY 1, 2, 3"
  jrows = list(sqlite3.connect(j.path).execute(q))
  assert list(sqlite3.connect(t.path).execute(q)) == jrows
  for table in ("t1", "t2", None):
    _same_nested(j.read_scores(table).to_dict(orient="index"),
                 t.read_scores(table))
  assert t.read_scores("nope") == {} and j.read_scores("nope").empty
  jerr, terr = j.read_errors(), t.read_errors()
  assert [(e["uid"], e["message"]) for e in terr] == \
      list(zip(jerr["uid"], jerr["message"]))
  assert sorted(t.tables) == sorted(j.tables)


# ---------------------------------------------------------------------------
# both experimenters' hooks, fit recorded
# ---------------------------------------------------------------------------
def _record_fit(monkeypatch, module):
  calls = []

  def fit(self, train, valid=None, **kwargs):
    calls.append((self, train, valid, kwargs))
    return self

  monkeypatch.setattr(module.SingleCellModel, "fit", fit)
  monkeypatch.setattr(module.SingleCellModel, "save_weights",
                      lambda self, path, backend="msgpack": path)
  return calls


def _plain(v):
  """A spec with each package's dataclasses (NetConf, RVmeta) as dicts."""
  if dataclasses.is_dataclass(v):
    return dataclasses.asdict(v)
  if isinstance(v, (list, tuple)):
    return [_plain(x) for x in v]
  if isinstance(v, dict):
    return {k: _plain(x) for k, x in v.items()}
  return v


def _rv(r):
  return (r.dim, r.posterior, r.projection, r.name, tuple(r.kwargs))


def _batches(feeder):
  """One shuffled epoch (masks too), then every row in order."""
  return [{k: (v if k != "inputs" else [np.asarray(x) for x in v])
           for k, v in b.items()}
          for b in list(feeder) + list(feeder.full_batches())]


@pytest.mark.parametrize("model_name", ["vae", "sisua", "scvi", "scanvi"])
def test_hooks_build_and_feed_as_jax(J, tmp_path, monkeypatch, model_name):
  """The same directory, config, outputs, latents, nets and constructor
  arguments, the same ``fit`` keywords, and the same training and
  validation batches (matrices, library statistics, label masks) bitwise,
  from the split 0.9 and the corruption at seed 8 of the training part."""
  JX = J.X
  jcalls = _record_fit(monkeypatch, J.B)
  tcalls = _record_fit(monkeypatch, TB)
  je = JX.SisuaExperimenter(save_path=str(tmp_path / "j"))
  te = TX.SisuaExperimenter(save_path=str(tmp_path / "t"), device="cpu")
  over = {"model.name": model_name, "dataset.name": "synthetic500",
          "train.epochs": 1}
  jc, tc = je.load_config(over), te.load_config(over)
  jd, td = je.experiment_dir(jc), te.experiment_dir(tc)
  assert os.path.basename(td) == os.path.basename(jd)
  jdata, tdata = je.on_load_data(jc), te.on_load_data(tc)
  jm = je.on_create_model(jc, jd, jdata)
  tm = te.on_create_model(tc, td, tdata)
  assert type(tm).__name__ == type(jm).__name__
  assert str(tm.device) == "cpu"
  assert [_rv(r) for r in tm.outputs] == [_rv(r) for r in jm.outputs]
  assert [_rv(r) for r in tm.latents] == [_rv(r) for r in jm.latents]
  for part in ("encoder", "decoder"):
    assert [dataclasses.asdict(n) for n in getattr(tm, part)] == \
        [dataclasses.asdict(n) for n in getattr(jm, part)]
  jkw, tkw = jm._init_kwargs_for_save, tm._init_kwargs_for_save
  for k in set(jkw) - {"outputs", "latents", "encoder", "decoder"}:
    assert _plain(tkw[k]) == _plain(jkw[k]), k
  je.on_train(jc, jd, jm, jdata)
  te.on_train(tc, td, tm, tdata)
  (_, jtrain, jvalid, jfit), = jcalls
  (_, ttrain, tvalid, tfit), = tcalls
  assert jfit.pop("mesh") is None and tfit.pop("mesh") is None
  assert os.path.relpath(tfit.pop("checkpoint_path"), te.save_path) == \
      os.path.relpath(jfit.pop("checkpoint_path"), je.save_path)
  assert tfit == jfit
  jm.set_metadata(jtrain)  # what the JAX fit records first
  assert (tm.dataset, tm.metadata) == (jm.dataset, jm.metadata)
  lp = jfit["labels_percent"] if jm.is_semi_supervised else 0.0
  bs = jfit["batch_size"]
  pairs = ((jm._to_feeder(jtrain, bs, lp), ttrain),
           (jm._to_feeder(jvalid, bs, 1.0, shuffle=False), tvalid))
  for jf, tf in pairs:
    assert (tf.labels_percent, tf.batch_size, tf.shuffle) == \
        (jf.labels_percent, jf.batch_size, jf.shuffle)
    jb, tb = _batches(jf), _batches(tf)
    assert len(tb) == len(jb) > 0
    assert sum(len(b["mask"]) for b in tb) >= tf.n_obs == jf.n_obs
    for a, b in zip(jb, tb):
      assert set(a) == set(b)
      for x, y in zip(a["inputs"], b["inputs"]):
        np.testing.assert_array_equal(y, x)
      for k in set(a) - {"inputs"}:
        np.testing.assert_array_equal(b[k], a[k])


def test_mesh_config_raises_before_loading(tmp_path, monkeypatch):
  te = TX.SisuaExperimenter(save_path=str(tmp_path), device="cpu")
  monkeypatch.setattr(te, "on_load_data", lambda cfg: pytest.fail(
      "data loaded before the mesh check"))
  cfg = te.load_config({"train.n_data_devices": 2})
  with pytest.raises(NotImplementedError, match="A21"):
    te.run_config(cfg)
  errors = te.scoreboard.read_errors()
  assert len(errors) == 1 and "A21" in errors[0]["message"]


def test_failures_in_eval_reach_the_scoreboard(tmp_path, monkeypatch):
  """A criticizer or a score family that raises leaves the rest of the
  scores and an error row, as the JAX experimenter does for the
  criticizers."""
  from sisua_tpu_torch.analysis import Posterior
  from sisua_tpu_torch.analysis.criticizer import Criticizer
  _record_fit(monkeypatch, TB)

  def boom(self):
    raise RuntimeError("planted failure")

  monkeypatch.setattr(Criticizer, "cal_all_scores", boom)
  monkeypatch.setattr(Posterior, "cal_dci", boom)
  te = TX.SisuaExperimenter(save_path=str(tmp_path), device="cpu")
  cfg = te.load_config({"model.name": "vae", "dataset.name": "synthetic200",
                        "variables.latents.event_shape": 4})
  scores = te.run_config(cfg)
  assert scores and not any(k.startswith("dci") for k in scores)
  msgs = [e["message"] for e in te.scoreboard.read_errors()]
  assert len(msgs) == 3 and all("planted failure" in m for m in msgs)
  assert sum(m.startswith("criticizer[") for m in msgs) == 2
  assert len(te.scoreboard.read_scores("scores_synthetic200")) == 1


# ---------------------------------------------------------------------------
# fit_hyper
# ---------------------------------------------------------------------------
def _history(JH, seed, n):
  rng = np.random.RandomState(seed + 100)
  return [(JH._sample(JH.DEFAULT_SPACE, rng), float(rng.rand()))
          for _ in range(n)]


@pytest.mark.parametrize("n_trials", [0, 7, 8, 13])
def test_hyper_proposals_equal_jax(J, n_trials):
  JH = J.H
  for seed in (8, 21):
    trials = _history(JH, seed, n_trials)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(5):
      assert TH._sample(TH.DEFAULT_SPACE, tr) == \
          JH._sample(JH.DEFAULT_SPACE, jr)
      assert TH._tpe_sample(TH.DEFAULT_SPACE, trials, tr) == \
          JH._tpe_sample(JH.DEFAULT_SPACE, trials, jr)
  assert TH.DEFAULT_SPACE == JH.DEFAULT_SPACE


@pytest.mark.parametrize("algorithm", ["rand", "tpe"])
def test_fit_hyper_search_equal_jax(J, monkeypatch, algorithm):
  """The whole search with each trial's loss a fixed function of its
  config: the same trials in the same order, the same best."""
  def fake(payload):
    cfg = payload[2]
    loss = (cfg["hdim"] / 64 - 1.5) ** 2 + cfg["zdim"] / 32 \
        + cfg["nlayers"] * 0.1 + abs(math.log10(cfg["learning_rate"]) + 3)
    return cfg, loss, "err" if cfg["zdim"] == 32 else None

  JH = J.H
  devices = []
  monkeypatch.setattr(JH, "_trial_worker", fake)
  monkeypatch.setattr(TH, "_trial_worker",
                      lambda p: (devices.append(p[-1]), fake(p))[1])
  kw = dict(algorithm=algorithm, max_evals=14, seed=3)
  jr = JH.fit_hyper("vae", "synthetic", **kw)
  tr = TH.fit_hyper("vae", "synthetic", device="cpu", **kw)
  assert tr == jr
  assert devices == ["cpu"] * 14


def test_fit_hyper_trial_trains_on_the_device(monkeypatch):
  """One real trial: the port's data layer, the model on the caller's
  device, a finite validation loss."""
  built = []
  orig = TB.SingleCellModel.__init__

  def init(self, *a, **k):
    built.append(k.get("device"))
    orig(self, *a, **k)

  monkeypatch.setattr(TB.SingleCellModel, "__init__", init)
  cfg = {"nlayers": 1, "hdim": 32, "zdim": 4, "learning_rate": 1e-3}
  got_cfg, loss, err = TH._trial_worker(
      ("vae", "synthetic200", cfg, 1, 64, 8, "cpu"))
  assert err is None and np.isfinite(loss) and got_cfg == cfg
  assert built == ["cpu"]


def test_fit_hyper_scvi_trial_takes_zinbd(monkeypatch):
  """An SCVI trial trains: its transcriptome head is get_rv's 'zinb' made
  'zinbd', the only count heads scVI's family accepts."""
  heads = []
  orig = TB.SingleCellModel.__init__

  def init(self, *a, **k):
    orig(self, *a, **k)
    heads.append(self.outputs[0].posterior)

  monkeypatch.setattr(TB.SingleCellModel, "__init__", init)
  cfg = {"nlayers": 1, "hdim": 32, "zdim": 4, "learning_rate": 1e-3}
  got_cfg, loss, err = TH._trial_worker(
      ("scvi", "synthetic200", cfg, 1, 64, 8, "cpu"))
  assert err is None and np.isfinite(loss) and got_cfg == cfg
  assert heads == ["zinbd"]


# ---------------------------------------------------------------------------
# multirun
# ---------------------------------------------------------------------------
class QuickExperimenter(TX.SisuaExperimenter):
  """Trains as the pipeline does, scores only the last loss and where the
  model lives (multirun's plumbing without the posterior)."""

  def on_eval(self, cfg, exp_dir, model, data):
    return {"loss": float(model.history["loss"][-1]),
            "on_cpu": float(str(model.device) == "cpu")}


def test_multirun_children_inherit_device_and_store(tmp_path):
  exp = QuickExperimenter(save_path=str(tmp_path), device="cpu")
  res = exp.run(["model.name=vae,dca", "dataset.name=synthetic200",
                 "train.epochs=1", "train.valid_freq=0",
                 "variables.latents.event_shape=4", "-m", "--ncpu", "2"])
  assert len(res) == 2 and all("error" not in r for r in res)
  assert all(r["on_cpu"] == 1.0 and np.isfinite(r["loss"]) for r in res)
  rows = exp.scoreboard.read_scores("scores_synthetic200")
  assert len(rows) == 2 and exp.scoreboard.read_errors() == []
  assert sorted(d.split("_")[0] for d in os.listdir(tmp_path)
                if d != "scoreboard.db") == ["dca", "vae"]


@pytest.mark.slow
def test_multirun_parallel_processes(tmp_path):
  """The JAX multirun test's run on the port: two spawned processes, each
  through the whole pipeline with its posterior."""
  exp = TX.SisuaExperimenter(save_path=str(tmp_path), device="cpu")
  res = exp.run(["model.name=vae,dca", "dataset.name=synthetic",
                 "train.epochs=1", "train.valid_freq=0",
                 "dataset.batch_size=64", "-m", "--ncpu", "2"])
  assert len(res) == 2 and all("error" not in r for r in res)
  for r in res:
    assert all(np.isfinite(v) for v in r.values() if isinstance(v, float))
  assert len(exp.scoreboard.read_scores("scores_synthetic")) == 2
