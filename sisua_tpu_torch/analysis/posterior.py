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
classification run on the model's device.

The hub is a ``Visualizer``: its 20 ``plot_*`` methods and ``plot_all``
give the JAX hub's figures under the JAX names, in its order. Their data
steps run on the model's device; the figures of the container (scatter,
violins, heatmaps, dendrogram, dot plot, marker matrices and scatters)
come from ``sco_analysis``, the port's ``SingleCellOMIC`` of the original
omics, the imputed ``i<omic>`` and ``latent``, built at the first figure
that needs it. ``figure_data()`` runs the data steps alone (no
matplotlib). ``mesh=``: the model's predictions, log-likelihoods and
marginal log-likelihoods run over the mesh's data axis (every rank gets
the whole arrays, so the scores after them are the single-device ones).
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
from ..utils.visualization import Visualizer, _pyplot, _seaborn
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


class Posterior(Visualizer):
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
    self.mesh = mesh
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
              device_cache=self.device_cache, mesh=self.mesh)
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
                                  batch_size=self.batch_size, mesh=self.mesh)
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
          sample_shape=sample_shape, batch_size=8, mesh=self.mesh)
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

  # --------------------------------------------------------------- figures
  @property
  def sco_analysis(self):
    """The analysis dataset as the port's ``SingleCellOMIC``: the original
    omics, the imputed mirrors and ``latent``, under their var names
    (made once, at the first figure that needs it)."""
    if getattr(self, "_sco_analysis", None) is None:
      from ..data.dataset import SingleCellOMIC
      omics = list(self.data) + [o for o in self.analysis
                                 if o not in self.data]
      first = omics[0]
      ana = SingleCellOMIC(self.analysis[first],
                           gene_id=self.analysis_var_names[first],
                           omic=first, name=self.name)
      for o in omics[1:]:
        ana.add_omic(o, self.analysis[o], self.analysis_var_names[o])
      self._sco_analysis = ana
    return self._sco_analysis

  @property
  def _dev(self):
    return self.scm.device

  def _tag(self, omic) -> str:
    o = _omic(omic)
    return o if (o in self.data or o in self.analysis) else str(omic)

  def plot_scatter(self, color_by: Optional[str] = None, algo: str = "tsne"):
    """Latent embedding scatter colored by a factor omic (or an imputed
    one, ``i<omic>``), named ``<name>_latent_<factor>_<algo>``."""
    color_by = color_by or (self.factor_omics[0] if self.factor_omics
                            else None)
    tag = "none" if color_by is None else self._tag(color_by)
    ana = self.sco_analysis
    return self._take(ana, lambda: ana.plot_scatter(
        X="latent", color_by=color_by, algo=algo,
        title=f"{self.name}_latent_{tag}_{algo}", device=self._dev))

  def plot_imputation_scatter(self):
    from .imputation import _imputation_data, _render_imputation
    org = self.original(self.main_omic)
    imp = self.analysis[f"i{self.main_omic}"]
    data = dict(title=self.name, **_imputation_data(
        torch.as_tensor(org, device=self._dev), imp))
    return self._draw(f"{self.name}_imputation", data, _render_imputation)

  def plot_distance_heatmap(self, factor_omic: Optional[str] = None,
                            omic: Optional[str] = None):
    """Group-centroid distance heatmap: in the latent space
    (``omic=None``), or in an omic's expression space (the container's
    figure, ``<name>_distheatmap_<omic>_<factor>``)."""
    from ..data.visualizer import _render_distance_heatmap
    from .latent import _distance_heatmap_data
    factor_omic = factor_omic or (self.factor_omics[0]
                                  if self.factor_omics else None)
    if factor_omic is None:
      return self
    if omic is not None:
      if _omic(omic) not in self.analysis:
        return self
      return self._delegate(
          "plot_distance_heatmap",
          rename=f"{self.name}_distheatmap_{_omic(omic)}_"
                 f"{_omic(factor_omic)}",
          X=omic, group_by=factor_omic)
    labels = np.argmax(self.original(factor_omic), 1)
    names = np.asarray(self.var_names[factor_omic])
    data = dict(title=self.name, **_distance_heatmap_data(
        self.latents, names[labels], device=self._dev))
    return self._draw(f"{self.name}_distance_{factor_omic}", data,
                      _render_distance_heatmap)

  def plot_correlation_matrix(self, method: str = "spearman",
                              factor_omic: str = "proteomic",
                              omic1: Optional[str] = None):
    """Correlation heatmap: latent × factor (``omic1=None``; spearman,
    pearson, mi or importance), or the container's marker-pair matrix of
    an omic's genes and the factor omic."""
    if omic1 is not None:
      o1, f = _omic(omic1), _omic(factor_omic)
      if o1 not in self.analysis or f not in self.analysis:
        return self
      delegate = {"spearman": "plot_spearman_matrix",
                  "pearson": "plot_pearson_matrix",
                  "mi": "plot_mutual_information",
                  "mutual_information": "plot_mutual_information"}[method]
      return self._delegate(delegate,
                            rename=f"{self.name}_{method}_{o1}_{f}",
                            omic1=o1, omic2=f)
    if factor_omic not in self.criticizers:
      return self
    data = dict(m=np.asarray(self.get_correlation_matrix(method,
                                                         factor_omic)),
                method=method, factor_omic=factor_omic,
                names=list(self.var_names[factor_omic]))
    return self._draw(f"{self.name}_{method}_{factor_omic}", data,
                      _render_correlation_matrix)

  def plot_latents_protein_pairs(self):
    from .latent import _protein_pairs_data, _render_protein_pairs
    if "proteomic" not in self.data:
      return self
    d = _protein_pairs_data(self.latents, self.original("proteomic"),
                            self.var_names["proteomic"], device=self._dev)
    if d is not None:
      self._draw(f"{self.name}_protein_pairs", dict(title=self.name, **d),
                 _render_protein_pairs)
    return self

  def plot_latents_binary(self):
    from .latent import _latents_binary_data, _render_latents_binary
    if "proteomic" not in self.data:
      return self
    ybin = self._protein_embedding().predict(self.original("proteomic"))
    data = dict(title=self.name, **_latents_binary_data(
        self.latents, ybin, self.var_names["proteomic"], device=self._dev))
    return self._draw(f"{self.name}_latent_binary", data,
                      _render_latents_binary)

  def plot_learning_curves(self, summary_steps: int = 1):
    hist = self.scm.history
    if not hist:
      return self
    data = dict(curves={k: np.asarray(hist[k], np.float64)
                        for k in ("loss", "val_loss") if k in hist},
                title=f"{self.name} learning curves")
    return self._draw(f"{self.name}_learning_curves", data,
                      _render_learning_curves)

  def plot_confusion_matrix(self, factor_omic: Optional[str] = None):
    factor_omic = factor_omic or ("celltype" if "celltype" in self.data
                                  else None)
    if factor_omic is None:
      return self
    true = np.argmax(self.original(factor_omic), 1)
    pred = self.sco_analysis.clustering(
        "latent", n_clusters=int(true.max() + 1), algo="kmeans",
        matching_labels=factor_omic, device=self._dev)
    k = int(max(true.max(), pred.max()) + 1)
    cm = np.zeros((k, k))
    np.add.at(cm, (true, pred), 1)
    return self._draw(f"{self.name}_confusion_{factor_omic}",
                      dict(cm=cm, factor_omic=factor_omic),
                      _render_confusion)

  def plot_disentanglement(self, factor_omic: Optional[str] = None):
    """Per criticizer: the |spearman| latent × factor heatmap and the
    disentanglement suite's bars."""
    factors = ([factor_omic] if factor_omic is not None
               else list(self.criticizers))
    for f in factors:
      try:
        crt = self.get_criticizer(f)  # makes imputed-factor criticizers
      except ValueError:
        continue
      m = np.abs(crt.create_correlation_matrix("spearman"))
      scores = crt.cal_all_scores()
      data = dict(m=m, factor=f, names=list(scores),
                  values=[scores[k] for k in scores])
      self._draw(f"{self.name}_disentanglement_{f}", data,
                 _render_disentanglement)
    return self

  def _delegate(self, method: str, rename: Optional[str] = None, **kwargs):
    """Run a figure method of ``sco_analysis`` and take its figures (or
    their data), named ``rename`` or ``<name>_<figure>``."""
    ana = self.sco_analysis
    return self._take(
        ana, lambda: getattr(ana, method)(device=self._dev, **kwargs),
        lambda k: rename or f"{self.name}_{k}")

  def plot_violins(self, omic: Optional[str] = None,
                   group_by: Optional[str] = None):
    """Marker-variable violins on the analysis dataset (imputed omic)."""
    omic = omic or f"i{self.main_omic}"
    group = group_by or (self.factor_omics[0] if self.factor_omics else None)
    if group is None or omic not in self.analysis:
      return self
    return self._delegate("plot_stacked_violins", X=omic, group_by=group)

  def plot_heatmap(self, omic: Optional[str] = None,
                   group_by: Optional[str] = None):
    """Grouped marker heatmap (original or imputed omic)."""
    omic = omic or f"i{self.main_omic}"
    group = group_by or (self.factor_omics[0] if self.factor_omics else None)
    if group is None or omic not in self.analysis:
      return self
    return self._delegate("plot_heatmap", X=omic, group_by=group)

  def plot_dendrogram(self, omic: Optional[str] = None,
                      group_by: Optional[str] = None):
    """Ward-linkage dendrogram heatmap of group centroids."""
    omic = omic or f"i{self.main_omic}"
    group = group_by or (self.factor_omics[0] if self.factor_omics else None)
    if group is None or omic not in self.analysis:
      return self
    return self._delegate(
        "plot_dendrogram_heatmap",
        rename=f"{self.name}_dendrogram_{omic}_{_omic(group)}",
        X=omic, group_by=group)

  def plot_dotplot(self, omic: Optional[str] = None,
                   group_by: Optional[str] = None):
    omic = omic or f"i{self.main_omic}"
    group = group_by or (self.factor_omics[0] if self.factor_omics else None)
    if group is None or omic not in self.analysis:
      return self
    return self._delegate("plot_dotplot", X=omic, group_by=group)

  def plot_correlation_scatter(self, imputed: bool = True):
    """Top marker gene↔protein scatter pairs, on the original or the
    imputed transcriptome."""
    if "proteomic" not in self.data:
      return self
    omic1 = f"i{self.main_omic}" if imputed else self.main_omic
    if omic1 not in self.analysis:
      return self
    return self._delegate("plot_correlation_scatter", omic1=omic1,
                          omic2="proteomic")

  def plot_divergence(self, algo: str = "pca"):
    """Latent embedding colored by each protein's level."""
    if "proteomic" not in self.data:
      return self
    return self._delegate("plot_divergence", X="latent", omic="proteomic",
                          algo=algo)

  def plot_disentanglement_scatter(self, factor_omic: str = "proteomic",
                                   pairs=None, n_pairs: int = 6):
    """Latent 2-D PCA colored by the log-contrast of opposing factor
    pairs (``PROTEIN_PAIR_NEGATIVE``)."""
    from ..data.const import PROTEIN_PAIR_NEGATIVE
    from ..data.utils import standardize_protein_name
    if factor_omic in self.data:
      values = self.original(factor_omic)
    elif factor_omic in self.analysis:  # imputed factors
      values = self.analysis[factor_omic]
    else:
      return self
    raw_names = list(map(str, self.analysis_var_names[factor_omic]))
    # knowledge-base pairs match the standardized names, explicit pairs
    # the raw names too
    name_idx = {}
    for i, n in enumerate(raw_names):
      name_idx.setdefault(standardize_protein_name(n), i)
    for i, n in enumerate(raw_names):
      name_idx.setdefault(n, i)
    if pairs is None:
      pairs = [(a, b) for a, b in PROTEIN_PAIR_NEGATIVE
               if a in name_idx and b in name_idx]
    pairs = [p for p in pairs
             if p[0] in name_idx and p[1] in name_idx][:n_pairs]
    if not pairs:
      return self
    emb = self.sco_analysis.dimension_reduce("latent", n_components=2,
                                             algo="pca", device=self._dev)
    y = torch.log1p(torch.as_tensor(values, device=self._dev))
    contrast = torch.stack([y[:, name_idx[a]] - y[:, name_idx[b]]
                            for a, b in pairs], 1)
    data = dict(emb=np.asarray(emb), contrast=contrast.cpu().numpy(),
                pairs=[(str(a), str(b)) for a, b in pairs])
    return self._draw(f"{self.name}_disentanglement_scatter_{factor_omic}",
                      data, _render_disentanglement_scatter)

  def plot_llk_bars(self):
    """4-way imputed/reconstructed × original/corrupted LLK bars (the
    cached ``cal_llk``)."""
    llk = self.cal_llk()
    if not llk:
      return self
    return self._draw(f"{self.name}_llk",
                      dict(llk=dict(llk), title=f"{self.name} 4-way LLK"),
                      _render_llk)

  def plot_protein_prediction(self, n_proteins: int = 9):
    """Predicted vs true ADT scatter grid (models with a protein head)."""
    if "proteomic" not in self.data or "iproteomic" not in self.analysis:
      return self
    names = self.var_names["proteomic"]
    n = min(n_proteins, len(names))
    y = torch.log1p(torch.as_tensor(self.original("proteomic")[:, :n],
                                    device=self._dev))
    yhat = torch.log1p(torch.as_tensor(self.analysis["iproteomic"][:, :n],
                                       device=self._dev))
    data = dict(y=y.cpu().numpy(), yhat=yhat.cpu().numpy(),
                names=[str(v) for v in names[:n]])
    return self._draw(f"{self.name}_protein_prediction", data,
                      _render_protein_prediction)

  def plot_series(self, omic: Optional[str] = None):
    """Original vs imputed sorted column sums: of the main omic, or of a
    factor omic (``<name>_series_<omic>``)."""
    from ..utils.plot_utils import _series_statistics_data
    name = self.main_omic if omic is None else _omic(omic)
    if name not in self.data or f"i{name}" not in self.analysis:
      return self
    org = torch.as_tensor(self.original(name), device=self._dev)
    imp = torch.as_tensor(self.analysis[f"i{name}"], device=self._dev)
    data = dict(title=f"{self.name} {name}", **_series_statistics_data(
        {"original": org.sum(0), "imputed": imp.sum(0)}))
    key = (f"{self.name}_series" if omic is None
           else f"{self.name}_series_{name}")
    return self._draw(key, data, _render_series)

  def plot_all(self, full: bool = False):
    """The figure battery: ``full=False`` the 10-figure summary;
    ``full=True`` also the per-factor-omic grid (scatters, violins,
    heatmaps, dendrogram, dot plot, distances, confusion, the latent ×
    factor matrices, disentanglement, the marker matrices and scatters)
    and the LLK, protein prediction and divergence figures. Outside
    ``figure_data()`` it needs matplotlib (and seaborn for the full
    grid's violins) and raises at once without them."""
    if not self._data_only:
      (_seaborn if full else _pyplot)()
    (self.plot_learning_curves().plot_imputation_scatter()
     .plot_scatter(algo="pca").plot_distance_heatmap()
     .plot_correlation_matrix().plot_latents_protein_pairs()
     .plot_latents_binary().plot_confusion_matrix()
     .plot_disentanglement().plot_series())
    if not full:
      return self
    self.plot_llk_bars().plot_protein_prediction()
    self.plot_divergence()
    if not self.factor_omics:
      self.plot_scatter(algo="tsne")
    binary = ("disease", "progenitor", "celltype")
    for f in self.factor_omics:
      fi = f"i{f}"
      has_imputed = fi in self.analysis
      for algo in ("tsne", "umap"):
        self.plot_scatter(color_by=f, algo=algo)
        if has_imputed:
          self.plot_scatter(color_by=fi, algo=algo)
      if has_imputed:
        self.plot_series(omic=f)
      groups = [f] + ([fi] if has_imputed else [])
      for om in (self.main_omic, f"i{self.main_omic}"):
        for g in groups:
          self.plot_violins(omic=om, group_by=g)
          self.plot_heatmap(omic=om, group_by=g)
      self.plot_dendrogram(group_by=f)
      self.plot_dotplot(group_by=f)
      self.plot_distance_heatmap(factor_omic=f)
      self.plot_confusion_matrix(factor_omic=f)
      for method in ("spearman", "pearson", "mi", "importance"):
        self.plot_correlation_matrix(method=method, factor_omic=f)
      self.plot_disentanglement(factor_omic=f)
      if has_imputed:
        self.plot_disentanglement(factor_omic=fi)
      if f in binary:
        for om in (self.main_omic, f"i{self.main_omic}"):
          self.plot_distance_heatmap(factor_omic=f, omic=om)
      else:
        for om in (self.main_omic, f"i{self.main_omic}"):
          for method in ("spearman", "pearson"):
            self.plot_correlation_matrix(method=method, factor_omic=f,
                                         omic1=om)
        self.plot_disentanglement_scatter(factor_omic=f)
        if has_imputed:
          self.plot_disentanglement_scatter(factor_omic=fi)
        for imputed in (False, True):
          self.plot_correlation_scatter(imputed=imputed)
    return self


# ------------------------------------------------------------- render steps
def _render_correlation_matrix(m, method, factor_omic, names):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(8, 5))
  vmax = np.abs(m).max() or 1.0
  im = ax.imshow(m, aspect="auto", cmap="coolwarm", vmin=-vmax, vmax=vmax)
  ax.set_xlabel(factor_omic)
  ax.set_ylabel("latent dim")
  ax.set_xticks(range(m.shape[1]))
  ax.set_xticklabels(names, rotation=90, fontsize=6)
  ax.set_title(f"{method} latent×{factor_omic}")
  fig.colorbar(im, ax=ax)
  return fig


def _render_learning_curves(curves, title):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(7, 4))
  for k, v in curves.items():
    ax.plot(v, label=k)
  ax.set_xlabel("epoch")
  ax.legend()
  ax.set_title(title)
  return fig


def _render_confusion(cm, factor_omic):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(5, 5))
  im = ax.imshow(cm, cmap="Blues")
  ax.set_xlabel("cluster")
  ax.set_ylabel(factor_omic)
  fig.colorbar(im, ax=ax)
  return fig


def _render_disentanglement(m, factor, names, values):
  plt = _pyplot()
  fig, axes = plt.subplots(1, 2, figsize=(12, 4),
                           gridspec_kw={"width_ratios": [1, 1.4]})
  im = axes[0].imshow(m, aspect="auto", cmap="viridis", vmin=0, vmax=1)
  axes[0].set_xlabel(factor)
  axes[0].set_ylabel("latent dim")
  axes[0].set_title("|spearman| latent × factor")
  fig.colorbar(im, ax=axes[0])
  axes[1].bar(range(len(names)), values)
  axes[1].set_xticks(range(len(names)))
  axes[1].set_xticklabels(names, rotation=45, fontsize=7, ha="right")
  axes[1].set_title("disentanglement suite")
  fig.tight_layout()
  return fig


def _render_disentanglement_scatter(emb, contrast, pairs):
  plt = _pyplot()
  ncol = 3
  nrow = int(np.ceil(len(pairs) / ncol))
  fig, axes = plt.subplots(nrow, ncol, figsize=(3.6 * ncol, 3 * nrow),
                           squeeze=False)
  for k, (a, b) in enumerate(pairs):
    ax = axes[k // ncol][k % ncol]
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=contrast[:, k], s=4,
                    cmap="coolwarm", linewidths=0)
    ax.set_title(f"{a} − {b}", fontsize=8)
    fig.colorbar(sc, ax=ax)
  for k in range(len(pairs), nrow * ncol):
    axes[k // ncol][k % ncol].axis("off")
  fig.tight_layout()
  return fig


def _render_llk(llk, title):
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(6, 4))
  names = list(llk)
  ax.bar(range(len(names)), [llk[k] for k in names])
  ax.set_xticks(range(len(names)))
  ax.set_xticklabels(names, rotation=30, fontsize=7, ha="right")
  ax.set_ylabel("log-likelihood")
  ax.set_title(title)
  fig.tight_layout()
  return fig


def _render_protein_prediction(y, yhat, names):
  plt = _pyplot()
  n = len(names)
  ncol = 3
  nrow = int(np.ceil(n / ncol))
  fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 3 * nrow),
                           squeeze=False)
  for k in range(n):
    ax = axes[k // ncol][k % ncol]
    ax.scatter(y[:, k], yhat[:, k], s=4, alpha=0.3, linewidths=0)
    lim = max(y[:, k].max(), yhat[:, k].max())
    ax.plot([0, lim], [0, lim], "r--", lw=0.8)
    ax.set_title(str(names[k]), fontsize=8)
    ax.set_xlabel("true (log1p)", fontsize=7)
    ax.set_ylabel("predicted", fontsize=7)
  for k in range(n, nrow * ncol):
    axes[k // ncol][k % ncol].axis("off")
  fig.tight_layout()
  return fig


def _render_series(series, log_scale, title):
  from ..utils.plot_utils import _render_series_statistics
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(8, 4))
  _render_series_statistics(series, log_scale, title, ax)
  return fig
