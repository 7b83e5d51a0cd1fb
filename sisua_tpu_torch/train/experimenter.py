"""Experimenter — YAML-config experiment manager with multirun (port of
``sisua_tpu/train/experimenter.py``).

* ``configs/base.yaml`` (read with the port's own ``_yaml``) plus dotted
  overrides (``model.name=sisua dataset.name=synthetic10k``); comma values
  fan out into a grid (``model.name=vae,dca`` → 2 configs);
* experiment directories named ``<model>_<dataset>_<hash>``, the hash the
  JAX package's (md5 of the sorted JSON of the config less ``train`` and
  ``verbose``, 5 hex digits), so both packages name a config's directory
  alike;
* hooks ``on_load_data`` → ``on_create_model`` → ``on_train`` →
  ``on_eval``, the scores into the sqlite ``ScoreBoard``;
* multirun ``-m --ncpu N``: one spawned process per config, on the
  parent's device and under its ``save_path``.

Every model is built on ``device`` ('cuda' unless the caller asks for the
CPU). A mesh (``train.n_data_devices × train.n_model_devices > 1``) raises
``NotImplementedError`` before any data is loaded (ROADMAP A21).
"""

from __future__ import annotations

import hashlib
import inspect
import itertools
import json
import os
import re
import traceback
from typing import Any, Dict, List, Optional, Sequence

from ..data.adapters import fit_sco, sco_posterior
from ..data.path import CONFIG_PATH, EXP_DIR
from . import _yaml as yaml
from .scoreboard import ScoreBoard

__all__ = ["Experimenter", "SisuaExperimenter", "nested_set",
           "parse_overrides", "config_hash"]


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------
def nested_set(cfg: dict, dotted: str, value) -> None:
  keys = dotted.split(".")
  d = cfg
  for k in keys[:-1]:
    d = d.setdefault(k, {})
  d[keys[-1]] = value


def _parse_value(s: str):
  try:
    return json.loads(s)
  except (json.JSONDecodeError, TypeError):
    return s


def _split_grid(v: str) -> List[str]:
  """Split a grid value on commas at bracket depth 0 only: 'a,b' is a
  two-point grid, '[64,64]' ONE JSON list value. Brackets and commas
  inside quoted strings are text."""
  parts: List[str] = []
  depth = 0
  quote: Optional[str] = None
  cur: List[str] = []
  for ch in v:
    if quote is not None:
      if ch == quote:
        quote = None
    elif ch in "\"'":
      quote = ch
    elif ch in "[{(":
      depth += 1
    elif ch in "]})":
      depth -= 1
    elif ch == "," and depth == 0:
      parts.append("".join(cur))
      cur = []
      continue
    cur.append(ch)
  parts.append("".join(cur))
  return parts


def parse_overrides(args: Sequence[str]) -> List[Dict[str, Any]]:
  """['a.b=1,2', 'c=x'] → the grid of {dotted: value} combinations."""
  keyed: List[List[tuple]] = []
  for a in args:
    if "=" not in a:
      raise ValueError(f"Override must be key=value, got {a!r}")
    k, v = a.split("=", 1)
    vals = [_parse_value(x) for x in _split_grid(v)]
    keyed.append([(k, x) for x in vals])
  return [dict(combo) for combo in itertools.product(*keyed)] if keyed \
      else [{}]


def config_hash(cfg: dict, exclude_keys: Sequence[str] = (),
                length: int = 5) -> str:
  slim = {k: v for k, v in cfg.items() if k not in exclude_keys}
  blob = json.dumps(slim, sort_keys=True, default=str)
  return hashlib.md5(blob.encode()).hexdigest()[:length]


def _from_config(cfg: dict, fn, overrides: Optional[dict] = None):
  """Call ``fn`` with the subset of cfg matching its signature."""
  spec = inspect.getfullargspec(fn)
  accepts_any = spec.varkw is not None
  kw = {k: v for k, v in cfg.items() if accepts_any or k in spec.args}
  for k, v in (overrides or {}).items():
    if accepts_any or k in spec.args:
      kw[k] = v
  return fn(**kw)


def _mc_from_sample_shape(x) -> int:
  """``train.sample_shape`` (an int or a list) → the number of
  training-time MC draws (1 = the plain reparameterized ELBO)."""
  if isinstance(x, (list, tuple)):
    n = 1
    for v in x:
      n *= int(v)
    return max(1, n)
  return max(1, int(x or 1))


# ---------------------------------------------------------------------------
# Experimenter
# ---------------------------------------------------------------------------
class Experimenter:
  """Config-hash experiment runner with hook methods."""

  def __init__(self,
               save_path: str = EXP_DIR,
               config_path: str = CONFIG_PATH,
               exclude_keys: Sequence[str] = ("train", "verbose"),
               hash_length: int = 5,
               device: str = "cuda"):
    self.save_path = save_path
    self.config_path = config_path
    self.exclude_keys = tuple(exclude_keys)
    self.hash_length = int(hash_length)
    self.device = str(device)
    os.makedirs(save_path, exist_ok=True)
    self.scoreboard = ScoreBoard(os.path.join(save_path, "scoreboard.db"))

  # ------------------------------------------------------------- config
  def load_config(self, overrides: Optional[dict] = None) -> dict:
    with open(self.config_path) as f:
      cfg = yaml.safe_load(f)
    for k, v in (overrides or {}).items():
      nested_set(cfg, k, v)
    return cfg

  def experiment_dir(self, cfg: dict) -> str:
    h = config_hash(cfg, self.exclude_keys, self.hash_length)
    name = cfg.get("model", {}).get("name", "model")
    ds = str(cfg.get("dataset", {}).get("name", "data"))
    # a dataset "name" may be a file path: keep a filesystem-safe tag
    ds_tag = re.sub(r"[^A-Za-z0-9_.-]+", "_", os.path.basename(ds))
    path = os.path.join(self.save_path, f"{name}_{ds_tag}_{h}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.yaml"), "w") as f:
      yaml.safe_dump(cfg, f)
    return path

  # ----------------------------------------------------------------- hooks
  def check_config(self, cfg: dict) -> None:
    """Refuse what cannot run, before any data is loaded."""

  def on_load_data(self, cfg: dict):
    raise NotImplementedError

  def on_create_model(self, cfg: dict, exp_dir: str, data):
    raise NotImplementedError

  def on_train(self, cfg: dict, exp_dir: str, model, data):
    raise NotImplementedError

  def on_eval(self, cfg: dict, exp_dir: str, model, data) -> Dict[str, float]:
    return {}

  # ------------------------------------------------------------------ run
  def run_config(self, cfg: dict) -> Dict[str, float]:
    exp_dir = self.experiment_dir(cfg)
    uid = os.path.basename(exp_dir)
    try:
      self.check_config(cfg)
      data = self.on_load_data(cfg)
      model = self.on_create_model(cfg, exp_dir, data)
      self.on_train(cfg, exp_dir, model, data)
      scores = self.on_eval(cfg, exp_dir, model, data) or {}
      if scores:
        self.scoreboard.write_scores(
            table=f"scores_{cfg['dataset']['name']}", unique=uid,
            scores=scores)
      return scores
    except Exception:
      self.scoreboard.write_error(uid, traceback.format_exc())
      raise

  def run(self, argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parse CLI overrides; '-m' fans the override grid into processes."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--config" in argv:  # e.g. configs/presets/cortex_vae.yaml
      i = argv.index("--config")
      self.config_path = argv[i + 1]
      del argv[i:i + 2]
    multirun = "-m" in argv
    ncpu = 1
    for flag in ("--ncpu", "-ncpu"):
      if flag in argv:
        i = argv.index(flag)
        ncpu = int(argv[i + 1])
        del argv[i:i + 2]
    argv = [a for a in argv if a not in ("-m", "--reset")]
    grids = parse_overrides(argv)
    if len(grids) > 1 and not multirun:
      raise ValueError(
          f"{len(grids)} config combinations given; pass -m for multirun")
    configs = [self.load_config(g) for g in grids]
    if multirun and len(configs) > 1 and ncpu > 1:
      return self._run_parallel(configs, ncpu)
    return [self.run_config(c) for c in configs]

  def _run_parallel(self, configs: List[dict], ncpu: int) -> List[Dict]:
    """One spawned process per config; results land in the scoreboard."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    cls = type(self)
    state = {"save_path": self.save_path, "config_path": self.config_path,
             "exclude_keys": list(self.exclude_keys),
             "hash_length": self.hash_length, "device": self.device}
    results = []
    with ctx.Pool(processes=ncpu) as pool:
      for r in pool.imap_unordered(
          _run_config_in_subprocess,
          [(cls.__module__, cls.__qualname__, c, state) for c in configs]):
        results.append(r)
    return results


def _run_config_in_subprocess(payload):
  module_name, qualname, cfg, state = payload
  import importlib
  cls = importlib.import_module(module_name)
  for part in qualname.split("."):
    cls = getattr(cls, part)
  # rebuilt with the PARENT's paths and device: a bare cls() would write
  # to the default EXP_DIR on the default device
  sig = inspect.signature(cls)
  has_varkw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                  for p in sig.parameters.values())
  kw = {k: state[k] for k in ("save_path", "config_path", "device")
        if k in sig.parameters or has_varkw}
  try:  # callable by binding only: a TypeError inside __init__ propagates
    sig.bind(**kw)
    callable_with_kw = True
  except TypeError:
    callable_with_kw = False
  if callable_with_kw:
    exp = cls(**kw)
  else:
    exp = cls.__new__(cls)
    Experimenter.__init__(exp, save_path=state["save_path"],
                          config_path=state["config_path"],
                          device=state["device"])
  for k in ("save_path", "config_path", "hash_length", "device"):
    setattr(exp, k, state[k])
  exp.exclude_keys = tuple(state["exclude_keys"])
  sb_path = os.path.join(state["save_path"], "scoreboard.db")
  if getattr(exp.scoreboard, "path", None) != sb_path:
    exp.scoreboard.close()
    exp.scoreboard = ScoreBoard(sb_path)
  try:
    return exp.run_config(cfg)
  except Exception as e:  # noqa: BLE001 — the error is on the scoreboard
    return {"error": str(e)}


# ---------------------------------------------------------------------------
# SisuaExperimenter
# ---------------------------------------------------------------------------
class SisuaExperimenter(Experimenter):
  """The concrete experiment pipeline of ``sisua-train``."""

  def __init__(self, save_path: str = EXP_DIR,
               config_path: str = CONFIG_PATH, device: str = "cuda"):
    super().__init__(save_path=save_path, config_path=config_path,
                     exclude_keys=("train", "verbose"), hash_length=5,
                     device=device)

  def check_config(self, cfg: dict) -> None:
    tr_cfg = cfg.get("train", {})
    n_data = int(tr_cfg.get("n_data_devices", 1))
    n_model = int(tr_cfg.get("n_model_devices", 1))
    if n_data * n_model > 1:
      raise NotImplementedError(
          f"train.n_data_devices × train.n_model_devices = {n_data} × "
          f"{n_model}: mesh training is not ported yet (ROADMAP A21)")

  # ------------------------------------------------------------------ data
  def on_load_data(self, cfg: dict):
    from ..data import get_dataset
    ds_cfg = cfg["dataset"]
    sco = get_dataset(ds_cfg["name"])
    train, test = sco.split(float(ds_cfg.get("train_percent", 0.8)))
    return {"sco": sco, "train": train, "test": test}

  # ----------------------------------------------------------------- model
  def on_create_model(self, cfg: dict, exp_dir: str, data):
    from ..models import get_model
    from ..nn import parse_netconf
    from ..rv import RVmeta
    sco = data["sco"]
    model_cfg = dict(cfg["model"])
    var_cfg = cfg.get("variables", {})
    cls = get_model(model_cfg.pop("name"))
    lat = var_cfg.get("latents", {"event_shape": 10, "posterior": "diag"})
    latents = RVmeta(int(lat.get("event_shape", 10)),
                     lat.get("posterior", "diag"), True, "latents",
                     tuple(sorted((lat.get("kwargs") or {}).items())))
    # one output RV per omic present in both the data and the variables
    outputs = []
    for omic_name in sco.omics:
      v = var_cfg.get(omic_name)
      if v is None:
        continue
      outputs.append(RVmeta(sco.get_dim(omic_name),
                            v.get("posterior", "zinb"), True, omic_name,
                            tuple(sorted((v.get("kwargs") or {}).items()))))
    if not outputs:
      raise ValueError(f"No variables configured for omics {sco.omics}")
    # unsupervised models get the main omic only; models that supervise
    # named omics (SCANVI → celltype) keep the main omic plus those
    is_semi = getattr(cls, "mask_outputs", False)
    if not is_semi:
      outputs = outputs[:1]
    else:
      sup = getattr(cls, "supervised_omics", None)
      if sup is not None:
        outputs = [outputs[0]] + [o for o in outputs[1:] if o.name in sup]
    encoder = parse_netconf(model_cfg.pop("encoder", {"units": [64, 64]}),
                            "encoder")
    decoder = parse_netconf(model_cfg.pop("decoder", {"units": [64, 64]}),
                            "decoder")
    model_cfg.pop("lamda", None)  # reserved, as in the JAX package
    model = _from_config(
        model_cfg, cls,
        overrides=dict(outputs=outputs if is_semi else outputs[0],
                       latents=latents, encoder=encoder, decoder=decoder,
                       dataset=cfg["dataset"]["name"], device=self.device))
    # resume the weights an earlier run saved
    model.load_weights(os.path.join(exp_dir, "model"))
    return model

  # ----------------------------------------------------------------- train
  def on_train(self, cfg: dict, exp_dir: str, model, data):
    ds_cfg, tr_cfg = cfg["dataset"], cfg["train"]
    train, valid = data["train"].split(0.9)
    train.corrupt(dropout_rate=float(ds_cfg.get("dropout_rate", 0.2)),
                  retain_rate=float(ds_cfg.get("retain_rate", 0.2)))
    max_iter = int(tr_cfg.get("max_iter", -1))
    fit_sco(
        model, train, valid=valid,
        epochs=int(tr_cfg.get("epochs", 100)),
        batch_size=int(ds_cfg.get("batch_size", 64)),
        learning_rate=float(tr_cfg.get("learning_rate", 1e-3)),
        optimizer=str(tr_cfg.get("optimizer", "adam")),
        clipnorm=float(tr_cfg.get("clipnorm", 100)),
        labels_percent=float(ds_cfg.get("labels_percent", 0.0)),
        valid_freq=int(tr_cfg.get("valid_freq", 500)),
        patience=int(tr_cfg.get("earlystop_patience", 20)),
        min_delta=float(tr_cfg.get("earlystop_threshold", 1e-4)),
        track_gradient_norms=bool(tr_cfg.get("track_gradient_norms", False)),
        terminate_on_nan=bool(tr_cfg.get("terminate_on_nan", True)),
        allow_rollback=bool(tr_cfg.get("allow_rollback", True)),
        max_iter=None if max_iter <= 0 else max_iter,
        checkpoint_path=os.path.join(exp_dir, "model"),
        mesh=None,
        mc_samples=_mc_from_sample_shape(tr_cfg.get("sample_shape", [])),
        scan_steps=int(tr_cfg.get("scan_steps", 1)),
        device_cache=bool(tr_cfg.get("device_cache", False)),
        device_dtype=str(tr_cfg.get("device_dtype", "float32")),
        metrics_interval=int(tr_cfg.get("metrics_interval", 1)),
        verbose=bool(cfg.get("verbose", False)))
    model.save_weights(os.path.join(exp_dir, "model"))

  # ------------------------------------------------------------------ eval
  def on_eval(self, cfg: dict, exp_dir: str, model, data):
    ds_cfg = cfg["dataset"]
    post = sco_posterior(
        model, data["test"],
        dropout_rate=float(ds_cfg.get("dropout_rate", 0.2)),
        retain_rate=float(ds_cfg.get("retain_rate", 0.2)))
    scores = post.save_scores(os.path.join(exp_dir, "scores.json"))
    uid = os.path.basename(exp_dir)
    # a score family or a criticizer that fails must not sink the rest,
    # but it must land on the scoreboard (the JAX experimenter records the
    # criticizers' failures only)
    for family, err in post.failures.items():
      print(f"[experimenter] posterior.{family} failed (see scoreboard "
            "errors)")
      self.scoreboard.write_error(uid, f"posterior.{family} failed: {err}")
    for f, crt in post.criticizers.items():
      try:
        for k, v in crt.cal_all_scores().items():
          scores[f"{k}_{f}"] = v
      except Exception:
        msg = f"criticizer[{f}] failed:\n{traceback.format_exc()}"
        print(f"[experimenter] {msg.splitlines()[0]} (see scoreboard errors)")
        self.scoreboard.write_error(uid, msg)
    return scores

  # ------------------------------------------------------------- retrieval
  def get_models(self, query: str = "", load_models: bool = True):
    """(config, model or None) of every experiment directory whose config
    matches 'model.name=X dataset.name=Y' style filters; a model is
    rebuilt with ``load_model`` on this experimenter's device when
    ``load_models`` and its directory holds one."""
    from ..models import load_model
    want = dict(kv.split("=", 1) for kv in query.split() if "=" in kv)
    out = []
    for d in sorted(os.listdir(self.save_path)):
      full = os.path.join(self.save_path, d)
      cfg_path = os.path.join(full, "config.yaml")
      if not os.path.isfile(cfg_path):
        continue
      with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
      ok = True
      for k, v in want.items():
        node = cfg
        for part in k.split("."):
          node = node.get(part, {}) if isinstance(node, dict) else {}
        if str(node) != v:
          ok = False
          break
      if not ok:
        continue
      if load_models and os.path.isfile(
          os.path.join(full, "model", "metamodel.json")):
        out.append((cfg, load_model(os.path.join(full, "model"),
                                    device=self.device)))
      else:
        out.append((cfg, None))
    return out
