"""Synthetic single-cell datasets, in numpy and scipy only (port of
``sisua_tpu/data/synthetic.py``).

The same ``np.random.default_rng`` calls in the same order, with the same
dtypes and row chunks, as the JAX package's generators: for the same
arguments the count, protein and one-hot matrices and the var names are
bitwise theirs. Each returns the port's ``SingleCellOMIC``.

* ``generate_synthetic``: clustered ZINB transcriptomic counts (per-cluster
  gene programs, per-cell library size, zero inflation), NB protein counts
  tied to cell type, one-hot cell types; marker genes tied to their
  proteins.
* ``generate_citeseq``: RNA and ADT drawn from one latent cell state
  through separate loadings, with ambient protein background, capture
  efficiency and batch effects (``obs['batch']``).
* ``generate_multiome``: paired RNA + ATAC peaks from one cell state.
* ``read_synthetic``: the registry's 'synthetic' and 'synthetic<k>' names,
  k in ``SYNTHETIC_SIZES`` cells × 500 genes × 10 proteins.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse

from .const import MARKER_ADT_GENE, MARKER_ADTS
from .dataset import SingleCellOMIC

__all__ = ["generate_synthetic", "generate_citeseq", "generate_multiome",
           "read_synthetic", "SYNTHETIC_SIZES"]


def generate_synthetic(n_cells: int = 3000,
                       n_genes: int = 558,
                       n_proteins: int = 10,
                       n_celltypes: int = 7,
                       zero_inflation: float = 0.3,
                       library_loc: float = 7.0,
                       library_scale: float = 0.4,
                       sparse_format: bool = True,
                       seed: int = 5218,
                       name: str = "synthetic") -> SingleCellOMIC:
  """Clustered multi-omic counts → SingleCellOMIC with 3 omics."""
  rng = np.random.default_rng(seed)
  # per-celltype gene programs (log-space archetypes)
  archetypes = rng.normal(0.0, 1.0, size=(n_celltypes, n_genes)
                          ).astype(np.float32)
  celltype = rng.integers(0, n_celltypes, size=n_cells)
  theta = 2.0  # typical NB over-dispersion
  # Generate in row chunks of float32: at 1M cells the straightforward
  # whole-matrix float64 pipeline allocates a chain of multi-GB temporaries
  # whose huge-page zeroing dominates wall-clock on virtualized hosts.
  X = np.empty((n_cells, n_genes), np.float32)
  Y = np.empty((n_cells, n_proteins), np.float32)
  prot_arch = np.abs(rng.normal(2.0, 1.0, size=(n_celltypes, n_proteins))
                     ).astype(np.float32)
  chunk = max(1, min(n_cells, 100_000))
  for lo in range(0, n_cells, chunk):
    hi = min(lo + chunk, n_cells)
    ct = celltype[lo:hi]
    logits = archetypes[ct] + rng.normal(
        0, 0.3, (hi - lo, n_genes)).astype(np.float32)
    props = np.exp(logits, out=logits)  # reuse the buffer
    props /= props.sum(1, keepdims=True)
    lib = np.exp(rng.normal(library_loc, library_scale,
                            size=(hi - lo, 1))).astype(np.float32)
    rate = props * lib
    g = rng.gamma(theta, rate / theta).astype(np.float32)
    Xc = rng.poisson(g).astype(np.float32)
    Xc *= (rng.random((hi - lo, n_genes)) > zero_inflation)
    X[lo:hi] = Xc
    prot_rate = prot_arch[ct] * np.exp(
        rng.normal(0, 0.2, (hi - lo, n_proteins)).astype(np.float32)) * 20.0
    gp = rng.gamma(theta, prot_rate / theta).astype(np.float32)
    Y[lo:hi] = rng.poisson(gp).astype(np.float32)

  # use real marker names so marker-based metrics (gene↔protein correlation,
  # importance, marker pairs) are exercised end-to-end on synthetic data
  prot_names = np.array(
      (MARKER_ADTS + [f"Protein{i:02d}" for i in range(n_proteins)])
      [:n_proteins])
  paired_genes = [MARKER_ADT_GENE[p] for p in prot_names
                  if p in MARKER_ADT_GENE]
  gene_names = np.array([f"Gene{i:04d}" for i in range(n_genes)], dtype=object)
  seen = set()
  gi = 0
  for g in paired_genes:
    if g not in seen and gi < n_genes:
      gene_names[gi] = g
      seen.add(g)
      gi += 1
  gene_names = gene_names.astype(str)
  # tie each marker gene's counts to its protein so correlations are real
  for j, p in enumerate(prot_names):
    g = MARKER_ADT_GENE.get(str(p))
    if g is not None:
      k = int(np.nonzero(gene_names == g)[0][0])
      lam = Y[:, j] * 0.05 + 0.5
      X[:, k] = rng.poisson(lam).astype(np.float32)
  ct_names = np.array([f"CellType{i}" for i in range(n_celltypes)])

  Xmat = sparse.csr_matrix(X) if sparse_format else X
  sco = SingleCellOMIC(Xmat,
                       cell_id=[f"Cell{i:06d}" for i in range(n_cells)],
                       gene_id=gene_names,
                       omic="transcriptomic",
                       name=name)
  sco.add_omic("proteomic", Y, prot_names)
  onehot = np.eye(n_celltypes, dtype=np.float32)[celltype]
  sco.add_omic("celltype", onehot, ct_names)
  return sco


def generate_citeseq(n_cells: int = 5000,
                     n_genes: int = 500,
                     n_proteins: int = 10,
                     n_celltypes: int = 10,
                     n_lineages: int = 3,
                     n_factors: int = 15,
                     n_batches: int = 2,
                     ambient_level: float = 25.0,
                     capture_sigma: float = 0.35,
                     batch_strength: float = 0.15,
                     zero_inflation: float = 0.1,
                     library_loc: float = 7.2,
                     library_scale: float = 0.45,
                     weak_factors: int = 0,
                     weak_gene_scale: float = 0.2,
                     n_nuisance: int = 0,
                     nuisance_scale: float = 0.9,
                     sparse_format: bool = True,
                     seed: int = 5218,
                     name: str = "citeseq_sim") -> SingleCellOMIC:
  """CITE-seq simulator, the benchmark-grade generator.

  * **Proteins independent of the realized RNA.** RNA and ADT counts are
    drawn from the same latent cell state through separate loading
    matrices with independent measurement noise, as in real antibody
    capture: a model scores on gene↔protein correlation only by denoising
    toward the latent state.
  * **Discriminative structure.** Hierarchical cell types (``n_celltypes``
    over ``n_lineages`` lineages), within-type continuous variation,
    per-cell capture efficiency (lognormal), per-protein ambient
    background counts and multiplicative per-batch effects on both
    modalities.

  Each protein shares its latent loading direction with its marker gene
  (names from ``MARKER_ADT_GENE``), so the marker-pair metrics measure
  cross-modality denoising.

  ``weak_factors > 0``: the last ``weak_factors`` latent factors keep
  their protein loadings while their gene loadings are scaled by
  ``weak_gene_scale`` (proteins whose mRNA is barely detectable, as CD4's).
  ``n_nuisance > 0`` adds RNA-only programs. Both flags add no draws when
  0.
  """
  rng = np.random.default_rng(seed)
  K, T, L = n_factors, n_celltypes, n_lineages
  # --- hierarchy: lineage centers, type archetypes around them ------------
  lineage_of = np.sort(rng.integers(0, L, size=T))
  lineage_centers = rng.normal(0.0, 1.0, (L, K))
  archetypes = (lineage_centers[lineage_of]
                + 0.45 * rng.normal(0.0, 1.0, (T, K)))
  celltype = rng.integers(0, T, size=n_cells)
  batch = rng.integers(0, max(1, n_batches), size=n_cells)
  # --- latent state: archetype + within-type continuous variation ---------
  state = (archetypes[celltype]
           + 0.30 * rng.normal(0.0, 1.0, (n_cells, K))).astype(np.float32)

  # --- loadings -----------------------------------------------------------
  W_g = rng.normal(0.0, 0.6, (K, n_genes)).astype(np.float32)
  gene_bias = rng.normal(0.0, 1.0, n_genes).astype(np.float32)
  prot_names = np.array(
      (MARKER_ADTS + [f"Protein{i:02d}" for i in range(n_proteins)])
      [:n_proteins])
  gene_names = np.array([f"Gene{i:04d}" for i in range(n_genes)],
                        dtype=object)
  marker_gene_idx = {}
  gi = 0
  for j, p in enumerate(prot_names):
    g = MARKER_ADT_GENE.get(str(p))
    if g is not None and g not in gene_names[:gi].tolist():
      gene_names[gi] = g
      marker_gene_idx[j] = gi
      gi += 1
  gene_names = gene_names.astype(str)
  # protein loadings: marker proteins share their marker gene's latent
  # direction (scaled up to be clearly type-informative); the rest random
  W_p = rng.normal(0.0, 0.6, (K, n_proteins)).astype(np.float32)
  for j, g_idx in marker_gene_idx.items():
    W_g[:, g_idx] = 1.6 * rng.normal(0.0, 1.0, K)  # strong marker program
    W_p[:, j] = W_g[:, g_idx]
  if weak_factors:
    # CD4 effect: the LAST `weak_factors` factors become nearly silent in
    # RNA (scaling W_g rows here, after the marker-program assignment,
    # shrinks the marker genes' loadings too) while being re-weighted to
    # carry the DOMINANT share of the protein foreground (per-protein
    # standardization below makes only the ratio matter). Deterministic
    # (no extra RNG draws), so weak_factors=0 reproduces the old stream.
    wf = min(int(weak_factors), K)
    W_g[K - wf:, :] *= float(weak_gene_scale)
    W_p[:K - wf, :] *= 0.5
    W_p[K - wf:, :] *= 2.0
  # RNA-only nuisance programs (cell-cycle / stress / dissociation-like):
  # structured variance visible ONLY in the transcriptome, competing with
  # the protein-relevant factors for encoder capacity. With weak_factors
  # this creates the regime the label-efficiency claim lives
  # in: an unsupervised objective fills its latent budget with the
  # loudest programs and drops the whisper-level protein factors;
  # supervision re-prioritizes them. Gated: n_nuisance=0 draws nothing.
  state_nu = W_nu = None
  if n_nuisance:
    state_nu = rng.normal(0.0, 1.0, (n_cells, n_nuisance)).astype(np.float32)
    W_nu = (float(nuisance_scale)
            * rng.normal(0.0, 0.6, (n_nuisance, n_genes))).astype(np.float32)

  # --- batch effects ------------------------------------------------------
  gene_batch = np.exp(batch_strength * rng.normal(
      0, 1, (max(1, n_batches), n_genes))).astype(np.float32)
  prot_batch = np.exp(batch_strength * rng.normal(
      0, 1, (max(1, n_batches), n_proteins))).astype(np.float32)
  ambient = (ambient_level
             * rng.lognormal(0.0, 0.5, n_proteins)).astype(np.float32)

  theta_g, theta_p = 2.0, 10.0
  X = np.empty((n_cells, n_genes), np.float32)
  Y = np.empty((n_cells, n_proteins), np.float32)
  # per-protein standardization of the foreground logit keeps the ADT
  # dynamic range realistic (~e^±3 over ambient) regardless of K / loading
  # scale; computed once over the population so chunks stay consistent
  t_all = state @ W_p
  t_mean = t_all.mean(0, keepdims=True)
  t_std = t_all.std(0, keepdims=True) + 1e-6
  chunk = max(1, min(n_cells, 100_000))
  for lo in range(0, n_cells, chunk):
    hi = min(lo + chunk, n_cells)
    s, b = state[lo:hi], batch[lo:hi]
    # RNA: softmax gene programs × lognormal library × batch shift
    logits = s @ W_g + gene_bias
    if state_nu is not None:
      logits += state_nu[lo:hi] @ W_nu
    props = np.exp(logits - logits.max(1, keepdims=True))
    props *= gene_batch[b]
    props /= props.sum(1, keepdims=True)
    lib = np.exp(rng.normal(library_loc, library_scale,
                            (hi - lo, 1))).astype(np.float32)
    rate = props * lib
    g = rng.gamma(theta_g, rate / theta_g).astype(np.float32)
    Xc = rng.poisson(g).astype(np.float32)
    if zero_inflation > 0:
      Xc *= (rng.random((hi - lo, n_genes)) > zero_inflation)
    X[lo:hi] = Xc
    # ADT: INDEPENDENT draw from the same state — foreground signal +
    # ambient background, scaled by per-cell capture efficiency
    fg = np.exp(1.2 * (s @ W_p - t_mean) / t_std) * 15.0
    capture = rng.lognormal(0.0, capture_sigma,
                            (hi - lo, 1)).astype(np.float32)
    prate = capture * (fg + ambient) * prot_batch[b]
    gp = rng.gamma(theta_p, prate / theta_p).astype(np.float32)
    Y[lo:hi] = rng.poisson(gp).astype(np.float32)

  ct_names = np.array([f"L{lineage_of[t]}_Type{t:02d}" for t in range(T)])
  Xmat = sparse.csr_matrix(X) if sparse_format else X
  sco = SingleCellOMIC(Xmat,
                       cell_id=[f"Cell{i:06d}" for i in range(n_cells)],
                       gene_id=gene_names,
                       omic="transcriptomic",
                       name=name)
  sco.add_omic("proteomic", Y, prot_names)
  sco.add_omic("celltype", np.eye(T, dtype=np.float32)[celltype],
               ct_names)
  sco.obs["batch"] = batch
  return sco


# the scalability protocol's cell counts (× 500 genes × 10 proteins): the
# single source of the registry's 'synthetic<k>' names
SYNTHETIC_SIZES = {"200": 200, "500": 500, "1k": 1000, "2k": 2000,
                   "5k": 5000, "10k": 10000, "40k": 40000,
                   "100k": 100000, "1m": 1000000}


def generate_multiome(n_cells: int = 3000,
                      n_genes: int = 400,
                      n_regions: int = 600,
                      n_celltypes: int = 6,
                      unpaired_frac: float = 0.0,
                      library_loc: float = 6.5,
                      library_scale: float = 0.4,
                      seed: int = 5218,
                      name: str = "multiome") -> SingleCellOMIC:
  """Paired RNA + ATAC multiome simulator (MULTIVI's habitat).

  A shared per-cell state (celltype archetype + noise) drives BOTH a
  gamma-Poisson RNA count matrix and a Bernoulli peak matrix (per-celltype
  accessibility logits × per-cell depth × per-region detectability), so
  cross-modal models have real joint structure to learn.

  ``unpaired_frac``: that fraction of cells is made mosaic — half lose the
  ATAC row, half the RNA row (all-zero rows, MULTIVI's missing-modality
  convention).
  """
  rng = np.random.default_rng(seed)
  celltype = rng.integers(0, n_celltypes, size=n_cells)
  # RNA: gamma-Poisson over per-celltype archetypes (generate_synthetic's
  # recipe, no zero-inflation knob — NB sparsity suffices)
  arch = rng.normal(0.0, 1.0, size=(n_celltypes, n_genes)).astype(np.float32)
  logits = arch[celltype] + rng.normal(0, 0.3, (n_cells, n_genes)
                                       ).astype(np.float32)
  props = np.exp(logits)
  props /= props.sum(1, keepdims=True)
  lib = np.exp(rng.normal(library_loc, library_scale,
                          size=(n_cells, 1))).astype(np.float32)
  theta = 2.0
  X = rng.poisson(rng.gamma(theta, props * lib / theta)).astype(np.float32)
  # ATAC: per-celltype accessibility programs; ~25% housekeeping-open
  # regions shared by all types; per-cell depth shifts; per-region offset
  acc = rng.normal(-2.0, 1.5, size=(n_celltypes, n_regions)
                   ).astype(np.float32)
  open_all = rng.random(n_regions) < 0.25
  acc[:, open_all] += 3.0
  depth = rng.normal(0.0, 0.7, size=(n_cells, 1)).astype(np.float32)
  region = rng.normal(0.0, 0.5, size=(1, n_regions)).astype(np.float32)
  p_open = 1.0 / (1.0 + np.exp(-(acc[celltype] + depth + region)))
  A = (rng.random((n_cells, n_regions)) < p_open).astype(np.float32)
  # fragment-like counts (models binarize internally)
  A *= rng.integers(1, 4, size=A.shape).astype(np.float32)
  if unpaired_frac > 0:
    k = int(round(unpaired_frac * n_cells))
    drop = rng.permutation(n_cells)[:k]
    A[drop[: k // 2]] = 0.0   # RNA-only cells
    X[drop[k // 2:]] = 0.0    # ATAC-only cells
  sco = SingleCellOMIC(sparse.csr_matrix(X),
                       cell_id=[f"Cell{i:06d}" for i in range(n_cells)],
                       gene_id=[f"Gene{i:04d}" for i in range(n_genes)],
                       omic="transcriptomic",
                       name=name)
  sco.add_omic("atac", sparse.csr_matrix(A),
               [f"Region{i:04d}" for i in range(n_regions)])
  onehot = np.eye(n_celltypes, dtype=np.float32)[celltype]
  sco.add_omic("celltype", onehot,
               [f"CellType{i}" for i in range(n_celltypes)])
  return sco


def read_synthetic(spec: str = "", **kwargs) -> SingleCellOMIC:
  """Registry entry: 'synthetic' or 'synthetic<k>' with k cells in
  {200, 500, 1k, 2k, 5k, 10k, 40k, 100k, 1m} (scalability protocol)."""
  sizes = SYNTHETIC_SIZES
  spec = spec.lower().replace("synthetic", "").strip("_")
  if spec in sizes:
    return generate_synthetic(n_cells=sizes[spec], n_genes=500,
                              n_proteins=10,
                              name=f"synthetic{spec}", **kwargs)
  return generate_synthetic(name="synthetic", **kwargs)
