"""Posterior: the evaluation hub of a fitted model on a test set (port of
``sisua_tpu/analysis/posterior.py``).

Built from a fitted ``SingleCellModel`` and test matrices, it corrupts a
copy of the main matrix (dropout 0.2, retain 0.2, binomial; the port's
``apply_artificial_corruption``, seed 8, bitwise the JAX routine), serves
the model on the corrupted and on the original data with
``sample_shape`` MC draws, and builds an analysis dataset holding, per
output omic, ``i<omic>`` (the imputed posterior mean: a zero-inflated
head's count distribution), the original omics, and ``latent`` (the
latent means); then one ``Criticizer`` per factor omic.

The port takes arrays in place of the JAX package's ``SingleCellOMIC``:
``data = {omic_name: (n, d) matrix}`` (numpy, scipy sparse or tensors) in
the container's omic order, the main omic first, and ``var_names =
{omic_name: names}`` beside it. Heads pair with omics by name when every
head's name is an omic of ``data``, else with the first omics in order,
as the JAX hub pairs them. The factor omics are those of ``data`` among
``_FACTOR_OMICS``.

Metric families (cached): ``cal_llk`` (4-way imputed/reconstructed ×
original/corrupted log-likelihood, MC draws by logsumexp − log S, on the
model's device, where a ZINB/NB head takes the fused forward kernel with
the draws as its member axis: of the predicted distributions, a batch at
a time; with ``device_cache=True`` through ``compute_llk``),
``cal_marginal_llk``,
``cal_imputation_scores``, ``cal_pearson``/``cal_spearman``/
``cal_protein_prediction``, ``cal_mutual_information``,
``cal_importance``, ``cal_protein_classification`` and the criticizers'
``cal_betavae``/``cal_factorvae``/``cal_mig``/``cal_dci``/
``cal_clustering_scores``; ``save_scores`` gathers them, each family
failing alone (its name and error kept in ``failures``).

The distributions stay on the host as ``predict`` returns them. The
log-likelihoods, the estimators of the criticizers and the protein
classification run on the model's device. The plots wait for the port's
plotting layer, ``mesh=`` for ROADMAP A21.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy import stats as sp_stats

from .. import dist as D
from ..data.const import MARKER_ADT_GENE
from ..data.utils import apply_artificial_corruption
from ..models.objective import mc_row_log_prob
from .criticizer import Criticizer
from .imputation import (correlation_scores, imputation_mean_score,
                         imputation_score, imputation_std_score)
from .latent import streamline_classifier

__all__ = ["Posterior"]

_FACTOR_OMICS = ("proteomic", "celltype", "disease", "progenitor", "tissue")
# the omics whose imputed mirror ('i' + name) the JAX OMIC vocabulary has
_MIRRORED = ("genomic", "atac", "transcriptomic", "proteomic", "celltype",
             "tissue", "disease", "progenitor", "pmhc", "rpkm", "ercc")
_RNA = ("transcriptomic", "itranscriptomic")
_ADT = ("proteomic", "iproteomic")


def _dist_mean(dist) -> torch.Tensor:
  """The distribution's mean with its MC sample dims averaged, where it
  lies."""
  m = dist.mean()
  if m.ndim > 2:
    m = m.mean(dim=tuple(range(m.ndim - 2)))
  return m


def _unwrap_imputed(dist):
  """The 'imputed' convention: a zero-inflated output's count
  distribution (its mean without the dropout gate)."""
  base = dist.base if isinstance(dist, D.Independent) else dist
  if isinstance(base, D.ZeroInflated):
    return base.count_distribution
  return base


def _numpy(a) -> np.ndarray:
  """A matrix as a dense host array."""
  if isinstance(a, torch.Tensor):
    return a.detach().cpu().numpy()
  if hasattr(a, "toarray"):
    return a.toarray()
  return np.asarray(a)


def _tuple(x):
  return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _omic(name) -> str:
  return str(name).lower().strip()


def _rows(dist, lo: int, hi: int, device):
  """Cells ``lo:hi`` of a predicted distribution (batch shape (S…, n)),
  on ``device``: every leaf with the cell axis and a dim after it is
  sliced there; a batch-invariant constant (a (1, D) per-gene row) is
  shared."""
  ax = len(dist.batch_shape) - 1
  n = dist.batch_shape[-1]

  def take(t):
    if t.ndim >= ax + 2 and t.shape[ax] == n:
      t = t.narrow(ax, lo, hi - lo)
    return t.to(device)
  return D.tree_map(take, dist)


class Posterior:
  """Posterior analysis of a fitted SingleCellModel on test matrices."""

  def __init__(self,
               scm,
               data: Dict[str, object],
               var_names: Optional[Dict[str, Sequence[str]]] = None,
               dropout_rate: float = 0.2,
               retain_rate: float = 0.2,
               corruption_distribution: str = "binomial",
               sample_shape: int = 10,
               batch_size: int = 256,
               seed: int = 8,
               device_cache: bool = False,
               mesh=None,
               verbose: bool = False):
    if mesh is not None:
      raise NotImplementedError("mesh serving is not ported yet "
                                "(ROADMAP A21)")
    if not isinstance(data, dict) or not data:
      raise ValueError("data must be a non-empty {omic_name: matrix} dict")
    self.scm = scm
    self.data = {_omic(k): v for k, v in data.items()}
    names = {_omic(k): v for k, v in (var_names or {}).items()}
    self.var_names = {
        o: [str(v) for v in names[o]] if o in names else
        [f"{o}{i}" for i in range(int(m.shape[1]))]
        for o, m in self.data.items()}
    self.sample_shape = int(sample_shape)
    self.batch_size = int(batch_size)
    self.device_cache = bool(device_cache)
    self.verbose = bool(verbose)
    self.seed = int(seed)
    self.dropout_rate = float(dropout_rate)
    self.retain_rate = float(retain_rate)
    self.corruption_distribution = corruption_distribution
    self.failures: Dict[str, str] = {}
    self._cache: Dict[str, object] = {}
    self._host: Dict[str, np.ndarray] = {}
    main = next(iter(self.data))
    self.corrupted = dict(self.data)
    self.corrupted[main] = apply_artificial_corruption(
        _numpy(self.data[main]), dropout=dropout_rate,
        distribution=corruption_distribution, retain_rate=retain_rate,
        copy=True, seed=seed)
    self._initialize()

  # ------------------------------------------------------------------ build
  def _initialize(self):
    scm = self.scm
    rv_names = [_omic(rv.name) for rv in scm.outputs]
    if all(n in self.data for n in rv_names):
      omics = rv_names
    else:
      omics = list(self.data)[:scm.n_outputs]
    self.output_omics = omics
    kw = dict(sample_shape=(self.sample_shape,), batch_size=self.batch_size,
              device_cache=self.device_cache)
    self.pX_cor, self.qZ_cor = scm.predict(
        [self.corrupted[o] for o in omics], **kw)
    self.pX_org, self.qZ_org = scm.predict(
        [self.data[o] for o in omics], **kw)
    analysis = {o: self.original(o) for o in self.data}
    names = dict(self.var_names)
    for o, dist in zip(omics, _tuple(self.pX_cor)):
      if o in _MIRRORED:
        analysis[f"i{o}"] = _dist_mean(_unwrap_imputed(dist)).numpy()
        names[f"i{o}"] = self.var_names[o]
    zmeans = [q.mean().numpy() for q in _tuple(self.qZ_cor)]
    latent = np.concatenate(zmeans, -1) if len(zmeans) > 1 else zmeans[0]
    analysis["latent"] = latent
    names["latent"] = [f"z{i}" for i in range(latent.shape[1])]
    self.analysis, self.analysis_var_names = analysis, names
    self.latents = latent
    self.criticizers: Dict[str, Criticizer] = {}
    for f in self.factor_omics:
      self.criticizers[f] = self._criticizer(self.original(f),
                                             self.var_names[f])

  def _criticizer(self, factors, names) -> Criticizer:
    return Criticizer(self.latents, factors, factor_names=list(names),
                      seed=self.seed, device=self.scm.device)

  def original(self, omic: str) -> np.ndarray:
    """An omic of the test data as a dense host array (kept once)."""
    if omic not in self._host:
      self._host[omic] = _numpy(self.data[omic])
    return self._host[omic]

  # -------------------------------------------------------------- properties
  @property
  def name(self) -> str:
    return getattr(self, "_name", None) or \
        f"{self.scm.id}_{self.scm.dataset or 'data'}"

  @name.setter
  def name(self, value: str):
    self._name = str(value)

  @property
  def dataset(self) -> Dict[str, np.ndarray]:
    """The analysis dataset: the original omics, the imputed mirrors and
    ``latent``."""
    return self.analysis

  @property
  def n_latents(self) -> int:
    return int(self.latents.shape[1])

  @property
  def n_outputs(self) -> int:
    return len(self.output_omics)

  @property
  def main_omic(self) -> str:
    return self.output_omics[0]

  @property
  def factor_omics(self) -> List[str]:
    return [o for o in self.data if o in _FACTOR_OMICS]

  @property
  def is_semi_supervised(self) -> bool:
    return self.scm.is_semi_supervised

  # ------------------------------------------------------------ data access
  def get_data(self, omic, data_type="auto"):
    """An array or a predicted distribution. ``data_type`` one of
    'imputed' (the prediction from the corrupted data), 'reconstructed'
    (from the original data), 'original', 'corrupted' or 'auto', or a
    list of them (the first found wins). For ``latent``,
    'corrupted'/'imputed'/'auto' is the posterior on the corrupted data."""
    omic = _omic(omic)
    types = [data_type] if isinstance(data_type, str) else list(data_type)
    for dtype in [str(t).lower().strip() for t in types]:
      if omic == "latent":
        if dtype in ("corrupted", "imputed", "auto"):
          return self.qZ_cor
        if dtype in ("original", "reconstructed"):
          return self.qZ_org
        continue
      if dtype in ("imputed", "reconstructed"):
        dists = self.pX_cor if dtype == "imputed" else self.pX_org
        for name, d in zip(self.output_omics, _tuple(dists)):
          if name == omic:
            return d
      elif dtype == "original" and omic in self.data:
        return self.original(omic)
      elif dtype == "corrupted" and omic in self.corrupted:
        return _numpy(self.corrupted[omic])
      elif dtype == "auto":
        if omic in self.analysis:
          return self.analysis[omic]
        for name, d in zip(self.output_omics, _tuple(self.pX_cor)):
          if f"i{name}" == omic:
            return d
    raise ValueError(
        f"No data found for OMIC: {omic}-{data_type}; outputs="
        f"{self.output_omics}, omics={list(self.analysis)}")

  def get_criticizer(self, factor_omic: str = "proteomic") -> Criticizer:
    """The factor omic's Criticizer, made on demand for an omic of the
    analysis dataset (an imputed one, ``i<omic>``, too)."""
    factor_omic = _omic(factor_omic)
    if factor_omic not in self.criticizers:
      if factor_omic in self.data:
        values = self.original(factor_omic)
      elif factor_omic in self.analysis:
        values = self.analysis[factor_omic]
      else:
        raise ValueError(f"No omic {factor_omic} in {list(self.data)} or "
                         f"{list(self.analysis)}")
      self.criticizers[factor_omic] = self._criticizer(
          values, self.analysis_var_names[factor_omic])
    return self.criticizers[factor_omic]

  def get_marker_pairs(self, omic1="transcriptomic", omic2="proteomic",
                       var_names1=None, var_names2=None,
                       remove_duplicated: bool = True):
    """Known (gene, protein) marker pairs whose names both omics of the
    analysis dataset hold (the marker table ``MARKER_ADT_GENE``)."""
    o1, o2 = _omic(omic1), _omic(omic2)
    if o1 in _RNA and o2 in _ADT:
      pairs = [(g, p) for p, g in MARKER_ADT_GENE.items()]
    elif o1 in _ADT and o2 in _RNA:
      pairs = [(p, g) for p, g in MARKER_ADT_GENE.items()]
    else:
      return []
    names1 = set(map(str, self.analysis_var_names.get(o1, ())))
    names2 = set(map(str, self.analysis_var_names.get(o2, ())))
    if var_names1 is not None:
      names1 &= set(map(str, var_names1))
    if var_names2 is not None:
      names2 &= set(map(str, var_names2))
    out = [(a, b) for a, b in pairs if a in names1 and b in names2]
    if remove_duplicated:
      out = list(dict.fromkeys(out))
    return out

  # ------------------------------------------------------------------- LLK
  def cal_llk(self) -> Dict[str, float]:
    """4-way log-likelihood: {imputed|reconstructed} × {original|corrupted}
    data, the MC draws by logsumexp − log S, averaged over cells."""
    if "llk" in self._cache:
      return self._cache["llk"]
    if self.device_cache:
      out = self._cal_llk_on_device()
    else:
      out = self._cal_llk_of_predictions()
    self._cache["llk"] = out
    return out

  def _cal_llk_of_predictions(self, row_log_prob=mc_row_log_prob
                              ) -> Dict[str, float]:
    """``cal_llk`` of the distributions ``predict`` returned (their
    draws): ``batch_size`` cells of each and of both targets at a time go
    to the model's device, where ``row_log_prob`` (the fused op) reduces
    them."""
    dev = self.scm.device
    log_s = math.log(self.sample_shape)
    out: Dict[str, float] = {}
    with torch.no_grad():
      for tag, pX in (("cor", self.pX_cor), ("org", self.pX_org)):
        for omic, dist in zip(self.output_omics, _tuple(pX)):
          targets = (("org", self.original(omic)),
                     ("cor", _numpy(self.corrupted[omic])))
          n = targets[0][1].shape[0]
          sums = {t: torch.zeros((), dtype=torch.float64, device=dev)
                  for t, _ in targets}
          for lo in range(0, n, self.batch_size):
            hi = min(n, lo + self.batch_size)
            d = _rows(dist, lo, hi, dev)
            for t, x in targets:
              lp = row_log_prob(d, torch.as_tensor(
                  np.asarray(x[lo:hi], np.float32), device=dev))
              if lp.ndim > 1:
                lp = torch.logsumexp(lp.reshape(-1, lp.shape[-1]), 0) \
                    - log_s
              sums[t] += lp.sum(dtype=torch.float64)
          for t, v in sums.items():
            out[f"llk_{omic}_pred{tag}_data{t}"] = float(v) / n
    return out

  def _cal_llk_on_device(self) -> Dict[str, float]:
    """``cal_llk`` through ``SingleCellModel.compute_llk``: the draws and
    their log-likelihoods on the device, one pass per prediction source."""
    targets = {
        "dataorg": [self.data[o] for o in self.output_omics],
        "datacor": [self.corrupted[o] for o in self.output_omics],
    }
    out: Dict[str, float] = {}
    for tag, source in (("cor", self.corrupted), ("org", self.data)):
      vals = self.scm.compute_llk([source[o] for o in self.output_omics],
                                  targets, sample_shape=(self.sample_shape,),
                                  batch_size=self.batch_size)
      for key, v in vals.items():
        data_tag, output_i = key.split("_output")
        out[f"llk_{self.output_omics[int(output_i)]}_pred{tag}_"
            f"{data_tag}"] = v
    return out

  def cal_marginal_llk(self, sample_shape: int = 100) -> Dict[str, float]:
    """Importance-sampled marginal log-likelihood of the main omic."""
    key = f"marginal_llk_{int(sample_shape)}"
    if key not in self._cache:
      mllk = self.scm.marginal_log_prob(
          [self.data[o] for o in self.output_omics],
          sample_shape=sample_shape, batch_size=8)
      self._cache[key] = {f"marginal_llk_{self.main_omic}":
                          float(np.mean(mllk))}
    return self._cache[key]

  # -------------------------------------------------------------- imputation
  def cal_imputation_scores(self) -> Dict[str, float]:
    """Denoising scores of the main omic."""
    if "imputation" not in self._cache:
      org = self.original(self.main_omic)
      cor = _numpy(self.corrupted[self.main_omic])
      imp = self.analysis[f"i{self.main_omic}"]
      self._cache["imputation"] = {
          "imputation_med": imputation_score(org, imp),
          "imputation_mean": imputation_mean_score(org, cor, imp),
          "imputation_std": imputation_std_score(org, cor, imp),
      }
    return self._cache["imputation"]

  # ------------------------------------------------------------ correlation
  def _marker_correlations(self, imputed: bool = True):
    key = f"marker_corr_{imputed}"
    if key not in self._cache:
      if "proteomic" not in self.data:
        self._cache[key] = {}
      else:
        X = (self.analysis[f"i{self.main_omic}"] if imputed
             else self.original(self.main_omic))
        self._cache[key] = correlation_scores(
            X, self.original("proteomic"), self.var_names[self.main_omic],
            self.var_names["proteomic"])
    return self._cache[key]

  def cal_spearman(self, imputed: bool = True) -> Dict[str, float]:
    corr = self._marker_correlations(imputed)
    out = {f"spearman_{k}": v[0] for k, v in corr.items()}
    if corr:
      out["spearman_mean"] = float(np.mean([v[0] for v in corr.values()]))
    return out

  def cal_pearson(self, imputed: bool = True) -> Dict[str, float]:
    corr = self._marker_correlations(imputed)
    out = {f"pearson_{k}": v[1] for k, v in corr.items()}
    if corr:
      out["pearson_mean"] = float(np.mean([v[1] for v in corr.values()]))
    return out

  def cal_protein_prediction(self) -> Dict[str, float]:
    """Per-protein Pearson and Spearman of the imputed protein mean
    (``iproteomic``, models with a protein head) against the true
    counts."""
    if "protein_pred" in self._cache:
      return self._cache["protein_pred"]
    if "proteomic" not in self.data or "iproteomic" not in self.analysis:
      self._cache["protein_pred"] = {}
      return {}
    y = self.original("proteomic")
    yhat = self.analysis["iproteomic"]
    out: Dict[str, float] = {}
    pear, spear = [], []
    for j, nm in enumerate(self.var_names["proteomic"]):
      if np.std(y[:, j]) == 0 or np.std(yhat[:, j]) == 0:
        continue
      p = float(sp_stats.pearsonr(yhat[:, j], y[:, j])[0])
      s = float(sp_stats.spearmanr(yhat[:, j], y[:, j])[0])
      out[f"protein_pearson_{nm}"] = p
      out[f"protein_spearman_{nm}"] = s
      pear.append(p)
      spear.append(s)
    if pear:
      out["protein_pearson_mean"] = float(np.mean(pear))
      out["protein_spearman_mean"] = float(np.mean(spear))
    self._cache["protein_pred"] = out
    return out

  def cal_mutual_information(self, factor_omic: str = "proteomic"
                             ) -> Dict[str, float]:
    crt = self.criticizers.get(factor_omic)
    if crt is None:
      return {}
    mi = crt.create_mutualinfo_matrix()
    return {f"mi_{factor_omic}": float(mi.max(0).mean())}

  def cal_importance(self, factor_omic: str = "proteomic"
                     ) -> Dict[str, float]:
    crt = self.criticizers.get(factor_omic)
    if crt is None:
      return {}
    _, acc = crt.create_importance_matrix()
    return {f"importance_acc_{factor_omic}": float(np.mean(acc))}

  def get_correlation_matrix(self, method: str = "spearman",
                             factor_omic: str = "proteomic") -> np.ndarray:
    crt = self.criticizers.get(factor_omic)
    if crt is None:
      raise ValueError(f"no criticizer for {factor_omic}")
    if method in ("spearman", "pearson"):
      return crt.create_correlation_matrix(method)
    if method in ("mutual_info", "mi"):
      return crt.create_mutualinfo_matrix()
    if method in ("importance", "average", "lasso"):
      return crt.create_importance_matrix()[0]
    raise ValueError(f"unknown method {method}")

  # -------------------------------------------------------- disentanglement
  def _crt_metric(self, fn_name: str) -> Dict[str, float]:
    out = {}
    for f, crt in self.criticizers.items():
      for k, v in getattr(crt, fn_name)().items():
        out[f"{k}_{f}"] = v
    return out

  def cal_betavae(self) -> Dict[str, float]:
    return self._crt_metric("cal_betavae_score")

  def cal_factorvae(self) -> Dict[str, float]:
    return self._crt_metric("cal_factorvae_score")

  def cal_mig(self) -> Dict[str, float]:
    return self._crt_metric("cal_mutual_info_gap")

  def cal_dci(self) -> Dict[str, float]:
    return self._crt_metric("cal_dci_scores")

  def cal_clustering_scores(self) -> Dict[str, float]:
    return self._crt_metric("cal_clustering_scores")

  def cal_disentanglement_full(self) -> Dict[str, float]:
    return self._crt_metric("cal_all_scores")

  # ------------------------------------------------------------ classifier
  def _protein_embedding(self):
    """The protein counts' ProbabilisticEmbedding at its defaults (seed
    8), fitted once on the model's device."""
    if "protein_embedding" not in self._cache:
      # imported here: label_threshold imports analysis.estimators
      from ..label_threshold import ProbabilisticEmbedding
      self._cache["protein_embedding"] = ProbabilisticEmbedding(
          device=self.scm.device).fit(self.original("proteomic"))
    return self._cache["protein_embedding"]

  def cal_protein_classification(self) -> Dict[str, float]:
    """Per-protein F1 of linear SVMs from the latents to the binarized
    proteins (``streamline_classifier``), on an 80/20 split drawn with
    ``RandomState(seed)``."""
    if "proteomic" not in self.data:
      return {}
    if "protein_f1" in self._cache:
      return self._cache["protein_f1"]
    ybin = self._protein_embedding().predict(self.original("proteomic"))
    n = len(self.latents)
    cut = int(0.8 * n)
    idx = np.random.RandomState(self.seed).permutation(n)
    tr, te = idx[:cut], idx[cut:]
    z = torch.as_tensor(self.latents, dtype=torch.float64,
                        device=self.scm.device)
    tr_t = torch.as_tensor(tr, device=z.device)
    te_t = torch.as_tensor(te, device=z.device)
    _, test_s = streamline_classifier(z[tr_t], ybin[tr], z[te_t], ybin[te],
                                      self.var_names["proteomic"],
                                      device=self.scm.device)
    out = {f"f1_{k}": v for k, v in test_s.items()}
    self._cache["protein_f1"] = out
    return out

  def save_scores(self, path: Optional[str] = None) -> Dict[str, float]:
    """Every scalar metric family in one dict (written as JSON to
    ``path`` when given). A family that raises is left out, its error
    kept in ``failures`` (and printed when ``verbose``)."""
    scores = {}
    for fn in (self.cal_llk, self.cal_imputation_scores, self.cal_spearman,
               self.cal_pearson, self.cal_protein_prediction,
               self.cal_mutual_information,
               self.cal_protein_classification, self.cal_mig, self.cal_dci,
               self.cal_clustering_scores):
      try:
        scores.update(fn())
      except Exception as e:  # metric families degrade independently
        self.failures[fn.__name__] = repr(e)
        if self.verbose:
          print(f"[posterior] {fn.__name__} failed: {e!r}")
    if path is not None:
      with open(path, "w") as f:
        json.dump(scores, f, indent=2)
    return scores
