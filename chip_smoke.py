#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``sisua_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sisua_tpu_torch/csrc`` (and
the host gathers of ``sisua_tpu_torch/native``) and drives the port's
paths at full transcriptome width (33,000 genes)
through the entry points a user calls, ``fit`` and ``evaluate``: SCVI
training with the ZINB likelihood in its 'full' dispersion form (in
float32, and in mixed precision through the kernels' bf16 modes), and
SISUA training (a 'zinb' RNA head and a masked 'nb' head over 10
proteins).

Phases, one result line each; any failure raises and exits non-zero
before the final line:
  1. device: CUDA present; card name and power limit from nvidia-smi;
  2. build: nvcc → shared library, seconds and the ptxas report
     (registers, shared memory, spills) of every kernel in the library;
  3. each kernel against its plain PyTorch version on the card, at both
     paths' shapes and at edge shapes (forward rtol 1e-4; gradients rtol
     2e-4 / atol 1e-5, plus a sum-order term for per-gene sums), run
     twice for the same bits, with median µs per call of kernel and
     plain, timed with CUDA events over back-to-back calls in turns
     (plain, kernel, kernel, plain), beside the case's bound (bytes at
     3.35 TB/s, or this data's operations at 67 TFLOP/s if larger) and the
     share of it reached; then the bf16 modes on the same operands
     (BF16_CASES): bf16 (B, D) operands at 'main_full', 'single' (a
     float32 per-gene θ beside bf16 logits), the 10-protein NB head (D =
     10, 20-byte bf16 rows), ragged and extreme, and float32 operands
     with SISUA_TPU_BWD_WRITES=bf16 at 'main_full'; a bf16-written
     gradient within 1 bf16 ulp of the plain version's (rtol 7.9e-3);
  4. SCVI fit on 8,192 × 33,000 device-resident synthetic counts, batch
     512, 8 epochs in two windows of 4; every loss finite, the last
     window's mean loss below the first's, both launch counters equal to
     the step count; then evaluate on 1,024 held-out cells;
  5. the kernel route against the plain route (distribution math under
     autograd) on one 512 × 33,000 batch at the same converted weights and
     noise, for 'full' and 'single' dispersion;
  6. SISUA fit on the same counts plus 10 protein columns, the JAX
     package's default nets, α = 10, labels_percent 0.1, batch 512, 8
     epochs in two windows of 4, validated on the 1,024 held-out cells;
     every loss finite and falling, ``llk_x1`` and ``val_loss`` in the
     history, each kernel launched twice per step (RNA and protein heads)
     and the forward twice per validation and evaluate batch;
  7. the kernel route against the plain route on one 512-row train step at
     the same converted weights and noise for SISUA (mixed mask; the mask
     must change the loss), DCA ('zinb') and MISA ('zinb' + 'nbd' →
     'mixnb', whose mixture head never reaches the kernels);
  8. serving: the phase 4 SCVI and phase 6 SISUA models, saved with
     ``save_weights`` right after their fits, come back from disk with
     ``load_model``: weights bitwise equal, history restored, ``evaluate``
     equal to the trained model's at the same noise (the forward kernel
     once per batch per ZINB/NB head); ``predict`` streaming against
     ``device_cache=True``; ``predict_mean`` cells/s at sample_shape ()
     and (10,), bf16 fetch, forced chunking; ``get_normalized_expression``,
     ``compute_llk`` (Jensen: ≥ evaluate's llk_x) and
     ``marginal_log_prob`` (≥ the ELBO); save and load seconds and bytes.
     Serving math launches no kernel but ``compute_llk``'s, which takes
     the fused forward once per ZINB/NB head and batch, the draws as its
     member axis.
  9. the rest of the zoo at the same width, each fit from launch counts
     set to 0, batch 512, 8 epochs in two windows of 4, the JAX
     package's default nets: FVAE ('zinb', γ = 6, its TC discriminator
     trained in the same step), SCALAR ('zinb' + the 10 proteins 'nb',
     α = 10, labels_percent 0.1, a 10-component mixture latent), SCALE
     ('zinb', 10 components) and LDVAE ('nbd', per-gene θ through
     ``column_sum_kernel``). Each: every loss finite and falling (FVAE:
     ``tc`` and ``disc_loss`` in the history), each kernel launched once
     per head per step, steady step ms, cells/s and peak memory; a
     ``save_weights`` → ``load_model`` round trip with weights (and the
     discriminator) bitwise equal and ``evaluate`` equal within
     EVAL_RTOL; the kernel route against the plain route on one batch at
     the same converted weights and noise, with phase 7's bounds.
 10. batch-covariate conditioning and the scvi-tools models on the same
     data plus a seeded one-hot over 4 batches, the 10 proteins and 10
     cell types, each fit from launch counts set to 0, batch 512, 8
     epochs in two windows of 4, validated on the 1,024 held-out cells:
     SCVI 'zinbd' at n_batch = 4 with an 'nb' label head over the
     proteins (phase 4's nets; two heads), TotalVI ('zinbd' RNA + the
     proteins' background/foreground NB mixture, n_batch = 4,
     mask_protein, labels_percent 0.5; the mixture takes plain math) and
     SCANVI ('zinbd' + the cell types, α = 50, labels_percent 0.1), at
     the JAX package's default nets. Each: every loss finite and falling,
     each kernel launched heads × (steps + validation batches) forward
     and heads × steps backward, steady step ms, cells/s and peak memory;
     the kernel route against the plain route on one batch (phase 7's
     bounds); ``save_weights`` → ``load_model`` with ``evaluate`` equal
     within EVAL_RTOL; one served call: SCVI's ``predict_mean`` with the
     one-hot (which must differ from the uniform batch prior's), TotalVI's
     ``denoised_proteins`` (in [0, 1]), SCANVI's ``predict_labels``.
 11. the multiome models at 10x Multiome width: phase 4's counts plus a
     seeded 8,192 × 108,377 peak matrix on the card (~5% nonzero, counts
     1–4), 10% of the cells made ATAC-only and another 10% RNA-only, in
     training and held-out data alike. PEAKVI on the peaks and MULTIVI
     ('zinbd' RNA + peaks, n_batch = 4), at the JAX package's default
     nets, batch 512, 8 epochs in two windows of 4, validated on the
     held-out cells, each from launch counts set to 0. Each: every loss
     finite and falling, MULTIVI's ``modality_penalty``, ``klqp_z1`` and
     ``llk_x1`` in the history, MULTIVI launching each kernel once per
     step and the forward once per validation and evaluate batch, PEAKVI
     none; steady step ms, cells/s and peak memory; ``save_weights`` →
     ``load_model`` bitwise with ``evaluate`` within EVAL_RTOL;
     ``get_accessibility_estimates`` in [0, 1], the region-free ones never
     below; MULTIVI's joint mean of ATAC-only cells unmoved by zeroing
     their RNA block, a paired cell's moved; the kernel route against the
     plain route on one batch of paired, RNA-only and ATAC-only cells
     (phase 7's bounds). Phase 11 works on a copy of the counts, which it
     makes mosaic.
 12. the last of the zoo on phase 4's counts, at the JAX package's
     default nets, each fit from launch counts set to 0, batch 512, 8
     epochs in two windows of 4, validated on the 1,024 held-out cells:
     AUTOZI ('zinbd', 'full' dispersion, its gate composed per gene by δ:
     each kernel once a step, the forward once per validation and
     evaluate batch; ``klqp_delta`` in the history; ``n_total_cells``
     through ``load_model``; ZI probabilities in (0, 1); the kernel route
     against the plain route with δ's log-gamma draws as a noise entry;
     δ's gradient from the backward kernel's gate gradient alone) and
     SCScope ('nzmse', latent 50, t_steps 2: a 33,000 × 33,000 imputer of
     1.09e9 parameters, at lr 6.1e-5 since lr 1e-3 diverges at this width
     (SCSCOPE_LR), no kernel, ``llk_cycles``; a save_weights →
     load_model round trip through the 4.36 GB chunked leaf, bitwise).
     Each: steady step ms, cells/s and peak memory. Then the kernel route
     against the plain route for an SCScope with a 'zinb' head; SOLO on
     the trained AUTOZI (16,384 simulated doublets, 60 epochs at batch
     256; the AUTOZI bitwise unchanged, P(doublet) in [0, 1], no kernel;
     fit seconds and predict cells/s); CellAssign on a planted panel of
     300 genes and 10 types (150 epochs, lr 1e-2; the planted type
     recovered for at least 90% of the cells, no kernel).
 13. this slice's path and the rest of ``fit``, on phase 4's counts:
     (a) SCVI at ``compute_dtype='bfloat16'`` with
     SISUA_TPU_FWD_OPERANDS=bf16 (both kernels in their bf16 modes),
     batch 512, 8 epochs in two windows of 4, validated on the 1,024
     held-out cells, from launch counts set to 0: every loss finite and
     falling, float32 parameters, both kernels launched once a step and
     the forward once per validation and evaluate batch; the kernel route
     against the plain route (loss rtol 1e-4, gradient bound 1e-2 over
     max|g| + 2^-8·G); ``save_weights`` → ``load_model`` keeping the
     compute dtype, ``evaluate`` within EVAL_RTOL; then the A/B of
     steady step ms, cells/s and peak memory with bf16 operands, f32
     operands, and f32 operands with bf16 writes, each twice in turns.
     (b) phase 4's float32 SCVI: each of the six other optimizers for 4
     epochs (loss finite, every parameter moved); ``fit_query`` on the
     held-out cells (frozen tensors bitwise unchanged); ``mc_samples=3``
     (no kernel in training, the forward in evaluate); ``callbacks``,
     ``track_gradient_norms`` and ``checkpoint_path`` in one validated
     fit (call counts, a metric injected into the history, the file
     reloading bitwise to the best state); ``device_dtype='int16'``
     (resident bytes halved, the losses of the float32 fit).
 14. the probe kernels and the host data path. (a) ``elemwise_probe`` and
     ``lgamma_probe`` (csrc/probe.cu) at 1024 × 33,000 on the TPU probe's
     operands made on the card: each against its plain version (rtol 1e-4
     plus 1e-6·Σ|element|; n_fma 64 and 256 on a multiplier in (0, 1),
     since a chain over θ overflows), twice for the same bits, a NaN
     planted in c (and b) reaching its row; then ``ops/probe.run_probe``
     from launch counts of 0: 32 back-to-back launches per variant in 3
     passes, one line each (µs, GB/s, bound, share) and the derived FMA
     costs. (b) SCVI ('full', phase 4's nets) out of core on 65,536 cells
     made on the card in 8,192-row slices as a host CSR (~6.6% nonzero),
     ``device_cache=True, hbm_budget_bytes=2**31``, batch 512, 3 epochs:
     the plan must be 1,536 rows × 43 chunks with 8 resident, all sparse
     (int16 storage: 3,584 × 19, 7 resident); losses finite and falling,
     both kernels once a step; steady ms a step, cells/s, seconds an
     epoch waited for streamed chunks; peak memory within the budget plus
     the model's footprint (a two-epoch resident fit of it on 1,024
     cells); the plan for 1,000,000 cells under the card's default
     budget. (c) phase 4's
     8,192 counts out of core at 2**30 from the dense host array and from
     its CSR: losses within rtol 1e-6. (d) the default streaming ``fit``
     on the 65,536-cell CSR, one epoch validated every 64 steps, float32
     and int16 transfers: ms a step, cells/s, and the device's idle share
     over 32 streamed steps under ``torch.profiler``. (e) ``predict_mean``
     of the held-out cells as CSR (triplets densified on the card) equal
     to the dense call bitwise.
 15. the vmapped ensemble (``train/ensemble.py``) and ``scan_steps``.
     (e) runs first, on phase 14b's CSR: the streamed fit with
     ``scan_steps=4`` on 127 batches (124 steps, a multiple of 4) against
     k = 1 stopped at the same step: the same loss (rtol 1e-4), ms a step
     of each. (a) both kernels with 4 members in one launch at
     4 × 512 × 33,000 (``MEMBER_CASES``: x shared through a member stride
     of 0 or per member, θ (B, D) or per gene, float32 and bf16
     operands) against their plain versions over the member axis with
     phase 3's tolerances, twice for the same bits, and one member
     bitwise equal to the (B, D) launch; µs per call beside the bound
     (a shared x counted once). (b) one fleet step of 4 SCVI members
     (phase 4's nets, 'zinbd', full dispersion) against 4 single-model
     steps on the same batch, noise and dropout masks (loss rtol 1e-4,
     gradients within phase 7's bound, parameters within 2·lr); then a
     ``VmapEnsemble`` of 4 members, shared batches, 4 epochs in windows
     of 2, from launch counts of 0: each kernel once per fleet step,
     every member's loss finite and falling, members different; steady
     ms a fleet step beside phase 4's single-model step, cells/s summed
     over members, the device's idle share over one profiled epoch, peak
     memory. (c) one window with ``shared_batches=False``. (d)
     ``fit_hyper_vmap`` at the JAX defaults (learning rates 1e-4, 3e-4,
     1e-3, 3e-3), 2 epochs: every trial finite, the best served with
     ``predict_mean`` on the held-out cells.
 16. the analysis path on fitted models (``sisua_tpu_torch.analysis``,
     ``differential_expression``, ``ops/knn_mi.py``). (a) SISUA at phase
     6's configuration for 4 epochs of one window each, with
     ``NegativeLogLikelihood`` and ``ImputationError`` (every epoch) and
     ``CorrelationScores`` (every second) on the 1,024 held-out cells,
     ten genes named after the marker genes of the ten proteins: each
     key at its epochs and finite; both kernels twice a step and the
     forward once per head per served NLL batch, its 2 draws as members;
     the NLL's kernel route against the distribution math on the same
     draws (rtol 1e-4); ``med``/``mean`` equal to numpy on the fetched
     imputed mean; the callbacks' seconds an epoch beside the step ms.
     (b) phase 4's SCVI fit (16 epochs) on a copy of the counts in 4 groups
     of 2,048 cells, 200 genes of each group's own redrawn as Poisson(0.5)
     and ×4 in its cells; ``differential_expression`` one-vs-rest at the
     JAX defaults and group0 in 'vanilla' mode: ≥ 150 of each group's 200
     genes in its top 200 ``lfc_median``, Spearman against the empirical
     log2 fold change > 0.5, the card's float64 statistics equal to the
     numpy statements on the same draws (rtol 1e-10 of each value or of
     the terms it is a difference of, ``proba_*`` exact);
     seconds per group for draws and statistics, peak memory. (c)
     ``knn_mutual_information`` on the card of the SISUA's imputed mean
     of the 2,000 most variable genes of (a)'s held-out imputation
     against the 10 proteins over 4,096 cells: finite, ≥ 0, 64 genes
     equal to the CPU on the same operands (atol 1e-5 nats), peak memory
     within its 2 GiB budget; seconds.
 17. the posterior hub (``sisua_tpu_torch.analysis``). (a) after 16c,
     ``create_posterior`` of 16a's SISUA on the 1,024 held-out cells at
     the JAX defaults (dropout 0.2, retain 0.2, binomial, 10 draws, batch
     256, seed 8) with ``device_cache=True``, then ``save_scores()`` and
     the proteins' ``cal_all_scores()`` (the JAX experimenter's
     ``on_eval``): every family's keys present and finite, none skipped;
     ``cal_llk`` through the fused forward (the draws as members: 2
     sources × 4 batches × 2 target sets × 2 heads = 32 launches) equal to
     the distribution math at the same draws (rel ≤ 1e-5); seconds by
     family, peak memory, the host bytes of ``pX_cor`` and ``pX_org``.
     (b) after 16b, its SCVI's latent means of all 8,192 planted cells
     against their 4 groups: ``clustering_scores`` (KMeans 10 restarts,
     a full GMM, the silhouette over 8,192² pairs) on the card against
     the port's CPU path (KMeans and GMM partitions identical up to
     relabeling, ASW/ARI/NMI/UCA within 1e-9) and the criticizer's
     ``cal_all_scores()`` with the groups one-hot as factors; seconds.
 18. the experiment entry points, every part with ``SISUA_EXP`` in a
     temporary directory. (a) ``python -m sisua_tpu_torch.cli.train
     model.name=sisua dataset.name=synthetic10k dataset.batch_size=128
     train.epochs=3 train.valid_freq=0`` in a subprocess, as a user runs
     it: exit 0, the 'cuda' device printed, ``config.yaml``,
     ``model/metamodel.json`` and ``scores.json`` written, one uid in
     ``scores_synthetic10k`` with every value finite, no error row; then
     ``cli.predict`` of its model on synthetic10k (the manifest's shapes,
     finite means) and, at the same time, ``cli.evaluate -model sisua -ds
     synthetic10k -ds2 synthetic2k --no-plots`` (one finite row in
     ``eval_synthetic2k``, the score table written). (b)
     ``SisuaExperimenter.run_config`` of SISUA on the port's
     ``generate_synthetic(8192, 33000, 10)`` split 0.8 (base.yaml's
     variables: 'zinbd' RNA, 'nb' proteins, one-hot cell types), batch
     512, 4 epochs, streamed: host seconds of the generator, training and
     ``on_eval`` (posterior, ``save_scores``, criticizers), the steady ms
     a step, peak device memory, both ZINB kernels launched, every score
     finite and no error row. (c) multirun of VAE and DCA on synthetic in
     two spawned processes sharing the card: two results without an
     error, two scoreboard uids. (d) ``fit_hyper`` of SCVI, 4 one-epoch
     trials in 2 processes: every trial finite, a best config. (a), (c),
     (d) and (b)'s generator run at once (threads over subprocesses and
     spawned processes); (b)'s training and scoring then run alone.
 20. the data analyzer (``SingleCellOMIC``, ``data/analysis.py``), after
     17b: phase 4's counts in 16b's 4 planted groups with phase 6's 10
     proteins, 8,192 × 33,000: ``calculate_quality_metrics``,
     ``filter_highly_variable_genes(n_top_genes=2000)``, ``normalize``
     (total, log1p), PCA (IncrementalPCA above 4,096 rows), UMAP on 50
     PCs, ``neighbors``, ``louvain``, ``clustering`` by KMeans, GMM, Ward
     and spectral matched to the groups, ``rank_vars_groups`` (Welch,
     Mann-Whitney), ``get_correlation``, ``get_mutual_information`` with
     both backends on 2,048 cells (cut) and ``get_importance_matrix`` on
     the 250 most variable genes at the largest tree count the phase's
     90 s budget leaves (cut, printed): seconds on the card and peak
     memory above the resident of each; each method held against the
     port's CPU path on every 4th cell, each later step on one input,
     with its tolerance printed; the card-side methods within the budget.
 21. the classical baselines and t-SNE, after 20 (about 180 s). (a)
     ``baselines.run_baseline`` of PCA, PPCA, sparse PCA, NMF and factor
     analysis at 10 components on phase 20's 8,192 planted cells at
     counts, cut to its 2,000 HVGs, with the 10 proteins and the 4 groups
     as ``celltype``: seconds, peak memory and score keys of each, every
     score finite; each estimator's latents on every 4th cell (2,048)
     held to the port's CPU path. (b) ``dimension_reduce(algo='tsne')``
     on every 2nd cell, 4,096 (3 components on 50 of phase 20's 100
     cached PCs, the octree): seconds, the KL divergence of the embedding
     (the Barnes-Hut error under its P) and its trustworthiness (k = 12)
     against the 50 PCs, on the card. (c) ``utils.dimension_reduction(z,
     'tsne', 2)`` of every 2nd of 16b's 8,192 SCVI latent means (the
     quadtree, the kd-tree's exact neighbours). (d) on every 4th of the
     8,192 cells, 2,048, card
     against CPU: the neighbours and P (1e-7 of the largest), the first
     forces from one start at one OpenMP thread (1e-6 of the largest),
     and the final KL of two default runs within 2%. No kernel launches.
 23. the device mesh (``sisua_tpu_torch.parallel``), within 90 s;
     (a)'s rank and (b)'s four start at once while this process makes
     their one-device references. (a) one NCCL rank on the card
     (``parallel.spawn``): phase 4's SCVI on phase 4's counts (made again
     from their seed), batch 512, 2 epochs with ``fit(mesh=create_mesh(),
     device_cache=True)`` against the same fit on one device: per-epoch
     losses within 1e-6 relative (the collectives of a one-rank group are
     skipped), both kernels once a step, ``predict_mean(mesh=)`` against
     ``predict_mean()`` within SERVE_RTOL; the mesh step's ms beside
     phase 4's. (b) a 2 × 2 world of 4 gloo ranks sharing the card (NCCL
     refuses two ranks on one device): SCVI at 33,000 genes, its three
     gene heads split over 'model', 4 steps of ``fit(mesh=create_mesh(2,
     2))`` on 2,048 seeded cells (each data rank 256 of a batch's 512
     rows) from the seeded weights and the generator's global draws,
     against the same fit on one device: each step's loss within 1e-5
     relative, step 1's gradients within phase 5's ROUTE_GRAD_BOUND
     measure, the parameters after step 4 (every entry within 2·lr a
     step, each leaf's update within 5% of its norm: P23_UPDATE_RTOL),
     both kernels launched in every rank once a step. Gloo takes every
     collective on CUDA tensors there (none is staged through the host);
     its step time is no speed figure.
 24. the data-ingestion layer (``sisua_tpu_torch.data.loaders``):
     (a) a CellRanger v3 ``filtered_feature_bc_matrix`` directory at the
     published size of 10x's pbmc_10k_protein_v3 sample, 7,865 cells ×
     33,538 "Gene Expression" features (every 1,500th symbol repeated)
     and its 17 "Antibody Capture" features (``matrix.mtx.gz``,
     ``barcodes.tsv.gz``, ``features.tsv.gz``): phase 1's generators on
     the card from the seed, written with scipy. (b) $SISUA_DATA and
     $SISUA_DOWNLOAD in a temporary folder, set before the port is
     imported; ``get_dataset(<dir>)``; ``get_dataset('10k')`` with the
     tree placed as the downloaded and extracted archive (it parses the
     files and writes the npz cache); ``get_dataset('10k')`` again with
     ``download_file`` refusing, a pure cache hit. The three containers:
     transcriptomic + proteomic bitwise the written counts, the names
     (repeats suffixed as the JAX container does) and barcodes in order,
     one md5. (c) SISUA at phase 6's nets: the kernel route against the
     plain route on the cached container's first 512 cells (rows of
     33,538 f32, not 16-byte aligned; 17 proteins), as phase 7 holds
     them; then ``data.adapters.fit_sco`` on the cached container, batch
     512, 2 epochs (a fit's start, not a fit): every loss finite, the
     second epoch's below the first, each kernel launched twice a step;
     ``predict_mean`` of 512 cells. (d) the seconds of the write, the
     three loads, the cache write, the route check, the fit and the
     prediction, beside the phase's 60 s budget.
 25. the tutorials (``sisua_tpu_torch.tutorials``), last: every
     tutorial's ``main()`` on the card at depth 1 (1 epoch, 2 TPE
     evaluations, 2 MC draws, a 2-run grid; the JAX tutorials' widths),
     then the notebook's code cells in order, in a fresh working
     directory, each from launch counts set to 0: every number it returns
     finite, both ZINB kernels launched by each but the embedding's (no
     model), the drill's (its ``cli.train`` and ``cli.evaluate`` run in
     a process of their own) and the uncertainty tutorial's
     backward (its ``mc_samples=2`` steps take the distribution math, as
     phase 13b's); the seconds of each beside the
     phase's 90 s budget. What the tutorials print goes to a log, shown
     when one raises.
Earlier phases train through ``fit(device_cache=True)``, the loop they
were written for. Before the last line it prints the kernels' JSON summary
(launches of the phase 4 and phase 6 fits, of phase 8 and of phases 9 to
17's fits and 18b's run_config, round trips, served NLL and LLK batches,
phase 23's mesh fits, phase 24's fit, phase 25's tutorials and phase
14a's probe run;
time, plain time and bound at 512 × 33,000 'main_full', and under
``bf16_operands`` / ``bf16_writes`` the bf16 modes' at the same shape
with phase 13a's launches, under ``members`` the 4-member launch's at 15a's
'fleet_full_shared' with phase 15b–d's launches; the probes' at
1024 × 33,000, ``sol_mem`` and ``lg_lgammaf``);
the last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX.
"""

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
GENES = 33_000
PROTEINS = 10
CELLS = 8192
HELD_OUT = 1024
BATCH = 512
# phases 4-13's fits: 8 epochs in two windows of 4 (cut from 16 in
# windows of 8 so that phases 1-23 fit the run's 1,200 s on a slow host)
EPOCHS = 8
WINDOW = 4            # metrics_interval, in epochs
LONG_EPOCHS = 16      # 16b's DE fit and MULTIVI's fleet (19b) keep 16
LONG_WINDOW = 8
ALPHA = 10.0          # configs/base.yaml:10
LABELS_PERCENT = 0.1  # configs/base.yaml:26
FWD_RTOL = 1e-4       # row-sum order bound (tests/test_ops.py:79)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_ops.py:130
# a bf16 (B, D) gradient: kernel and plain round the same f32 formula, so
# they differ by at most 1 bf16 ulp (2^-7 relative)
BF16_GRAD_RTOL = 7.9e-3
# a per-gene (1, D) gradient sums B rows in another order than the plain
# version: its atol adds ~8 float32 ulps (1e-6) of Σ_rows |term|
SUM_ULPS = 1e-6
ROUTE_LOSS_RTOL = 1e-4
# per parameter: max|Δg| ≤ 1e-3·(max|g| of it + 1e-3·max|g| overall)
ROUTE_GRAD_BOUND = 1e-3
SERVE_RTOL = 1e-5     # streaming vs device-cached predict, chunked means
EVAL_RTOL = 1e-6      # evaluate of the reloaded model vs the trained one
BOUND_SLACK = 5e-3    # Jensen / importance-weighted bounds, relative
BF16_RTOL = 1e-2      # bf16-fetched means vs float32
MC = 10               # MC draws of the serving phase
# the kernels of csrc/zinb.cu and csrc/probe.cu, as the ptxas report
# names them
KERNEL_NAMES = ("zinb_rowsum_fwd_kernel", "row_chunk_sum_kernel",
                "zinb_rowsum_bwd_kernel", "column_sum_kernel",
                "probe_rowsum_kernel")
PROBE_KINDS = ("fma", "lanczos", "stirling", "lgammaf")
# the card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# f32 operations per element of each path, counted from the element
# formulas (ops/zinb.py _zinb_elem, _zinb_grads_elem): each arithmetic op,
# comparison, exp, log and log1p as one, an lgammaf as 20
OPS = {"fwd": (30, 95), "bwd": (55, 110)}  # (zero count, nonzero count)
IW_SAMPLES, IW_BATCH, IW_CELLS = 100, 32, 256
NLL_RTOL = 1e-4       # phase 16a: the NLL's kernel route vs plain route
PHASE4 = {}  # phase 4's steady single-model step ms, beside phase 15's fleet
SINGLE_MS = {}  # phases 9–12: each class's steady step ms, beside phase 19


def log(msg):
  print(msg, flush=True)


def check(cond, msg):
  if not cond:
    raise RuntimeError(f"check failed: {msg}")


def phase_device(torch):
  check(torch.cuda.is_available(), "torch.cuda.is_available()")
  try:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
  except (OSError, IndexError, subprocess.SubprocessError) as e:
    smi = f"unavailable ({e})"
  log(f"[1 device] {smi}")
  log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
      f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
  return smi


def phase_build():
  """The CUDA kernels (one nvcc per source, all at once) and, beside them,
  the host gathers with g++; both must load."""
  from sisua_tpu_torch import native
  from sisua_tpu_torch.ops import _build
  fresh = not _build.library_path().is_file()
  t0 = time.perf_counter()
  with ThreadPoolExecutor(max_workers=1) as pool:
    gather = pool.submit(native.load)
    lib = _build.build()
    _build.load()
    gather.result()
  dt = time.perf_counter() - t0
  log(f"[2 build] {'built' if fresh else 'reused'} {lib.name} in {dt:.2f} s; "
      f"host gathers {native.library_path().name} loaded")
  report = lib.with_suffix(".log")
  if report.is_file():  # one line per kernel: registers and spills
    name, spills = None, ""
    for line in report.read_text().splitlines():
      if "Compiling entry function" in line:
        name = next((k for k in KERNEL_NAMES if k in line), line)
        flags = re.search(r"ILb([01])ELb([01])E(?:Lb([01])E)?", line)
        probe = re.search(r"ILi(\d)ELi(\d+)ELb([01])E", line)
        if flags:
          name += f"<constrained={flags[1]},vec={flags[2]}"
          name += f",mixed={flags[3]}>" if flags[3] else ">"
        elif probe:
          name += (f"<{PROBE_KINDS[int(probe[1])]},n_fma={probe[2]},"
                   f"vec={probe[3]}>")
      elif "spill" in line:
        spills = line.strip()
      elif "registers" in line and name:
        log(f"[2 build] {name}: {line.split(':', 1)[1].strip()}; {spills}")


def _time_turns(torch, fns, reps=10, rounds=3):
  """Median µs per call. A turn is ``reps`` back-to-back calls between two
  CUDA events (host overhead overlaps the device as in a real step); turns
  go plain, kernel, kernel, plain, ``rounds`` times, after a warm-up."""
  for f in fns.values():
    f()
  torch.cuda.synchronize()
  samples = {k: [] for k in fns}
  for k in ("plain", "kernel", "kernel", "plain") * rounds:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
      fns[k]()
    end.record()
    end.synchronize()
    samples[k].append(start.elapsed_time(end) * 1e3 / reps)
  return {k: statistics.median(v) for k, v in samples.items()}


def _counts(torch, gen, rows, cols):
  """Poisson(exp(−2.5 + 1.2·N(0,1))) × Bernoulli(0.5) counts on the card
  (benchmarks/wide_genes.py's synthetic transcriptome)."""
  lam = torch.exp(-2.5 + 1.2 * torch.randn((rows, cols), generator=gen,
                                           device=DEVICE))
  x = torch.poisson(lam, generator=gen)
  return x * (torch.rand((rows, cols), generator=gen, device=DEVICE) > 0.5)


def _proteins(torch, gen, rows, cols=PROTEINS):
  """Poisson(exp(2 + N(0,1))) protein counts on the card."""
  return torch.poisson(torch.exp(2.0 + torch.randn(
      (rows, cols), generator=gen, device=DEVICE)), generator=gen)


# phase-3 cases: name, rows, cols, constrained, per-gene (θ, logits, gate)
CASES = (
    ("main_full", BATCH, GENES, False, (False, False, False)),
    ("main_gene_theta", BATCH, GENES, True, (True, False, False)),
    ("nb_gate", BATCH, GENES, False, (False, False, True)),
    ("zinb_logits", BATCH, GENES, True, (False, False, False)),
    ("adt_nb", BATCH, PROTEINS, True, (False, False, True)),
    ("tall", 4096, 2048, False, (False, False, False)),
    ("ragged", 130, 1001, True, (True, False, False)),
    ("extreme", 4, 16, True, (False, False, False)),
)
# phase-3 cases whose gate is the NB heads' −1e30 per-gene row
NB_GATE_CASES = ("nb_gate", "adt_nb", "adt_nb_bf16")
# phase-3 bf16 cases: name, the f32 case they cast, and the mode —
# 'operands': every (B, D) parameter bf16 (per-gene rows stay float32),
# and then bf16 gradient writes; 'writes': float32 operands with
# SISUA_TPU_BWD_WRITES=bf16
BF16_CASES = (
    ("main_full_bf16", "main_full", "operands"),
    ("main_single_bf16", "main_gene_theta", "operands"),
    ("adt_nb_bf16", "adt_nb", "operands"),
    ("ragged_bf16", "ragged", "operands"),
    ("extreme_bf16", "extreme", "operands"),
    ("main_full_writes", "main_full", "writes"),
)


def _case(torch, gen, name, rows, cols, constrained, per_gene):
  """Operands for one phase-3 case: (x, θ-operand, logits, gate)."""
  x = (_proteins(torch, gen, rows) if name == "adt_nb"
       else _counts(torch, gen, rows, cols))
  shapes = [(1 if pg else rows, cols) for pg in per_gene]
  cr = torch.randn(shapes[0], generator=gen, device=DEVICE)
  if name == "zinb_logits":  # the 'zinb' head's exp(clip(raw, ±15)), wide
    cr = torch.exp(torch.clamp(6.0 * cr, -15.0, 15.0))  # enough for θ > 1e6
  elif constrained:  # θ itself, log-normal around e^0.5
    cr = torch.exp(0.5 + 0.7 * cr)
  lg = torch.randn(shapes[1], generator=gen, device=DEVICE) - 2.0
  gt = torch.randn(shapes[2], generator=gen, device=DEVICE) - 1.0
  if name in NB_GATE_CASES:
    gt = torch.full(shapes[2], -1e30, device=DEVICE)
  return x, cr, lg, gt


def _extreme_case(torch):
  """θ ∈ {1e-8, 1e7}, logits ±30, x ∈ {0, 1e6}, gate ±3: every
  combination, four rows."""
  vals = torch.cartesian_prod(torch.tensor([1e-8, 1e7]),
                              torch.tensor([-30.0, 30.0]),
                              torch.tensor([0.0, 1e6]),
                              torch.tensor([-3.0, 3.0])).T.contiguous()
  th, lg, x, gt = (v.repeat(4, 1).to(DEVICE).contiguous() for v in vals)
  return x, th, lg, gt


def _to_bf16_case(torch, name, x, cr, lg, gt):
  """A phase-3 case's (B, D) parameters as bf16 (per-gene rows stay
  float32). The protein head's θ operand and logits become two 10-column
  chunks of one (B, 20) bf16 matrix: 20-byte rows whose second chunk
  starts 20 bytes in, 4-byte aligned only, as the head passes them."""
  b = x.shape[0]
  cast = [p if p.shape[0] == 1 < b else p.to(torch.bfloat16)
          for p in (cr, lg, gt)]
  if name.startswith("adt_nb"):
    buf = torch.cat(cast[:2], dim=1)
    cast[:2] = torch.chunk(buf, 2, dim=1)
  return cast


def check_kernels(torch, tz, name, x, cr, lg, gt, g, constrained, need):
  """One case of ``tz``'s two kernels against their plain versions
  (forward rtol FWD_RTOL; gradients GRAD_TOL plus the per-gene sum-order
  term, a bf16-written (B, D) field within 1 bf16 ulp, BF16_GRAD_RTOL, in
  its primal's dtype; no unneeded gradient written), run twice for the
  same bits. Returns (forward max|Δ|, gradient max|Δ|)."""
  import numpy as np
  out = tz._fwd_launch(x, cr, lg, gt, constrained)
  grads = tz._bwd_launch(x, cr, lg, gt, g, constrained, need)
  torch.cuda.synchronize()
  ref = tz._rowsum_ref(x, cr, lg, gt, constrained)
  refs = tz._grads_ref(x, cr, lg, gt, g, constrained, need)
  o, r = out.cpu().numpy(), ref.cpu().numpy()
  check(np.isfinite(o).all(), f"{name}: forward not finite")
  np.testing.assert_allclose(o, r, rtol=FWD_RTOL, err_msg=f"{name}: forward")
  fwd_err = float(np.abs(o - r).max())
  bwd_err = 0.0
  params = (cr, lg, gt)
  terms = tz._zinb_grads_elem(x, *(tz._widen(p) for p in params),
                              constrained)
  bf16_full = tz._write_dtype(params) == torch.bfloat16
  for field, a, b, t, p in zip(("theta", "logits", "gate"), grads, refs,
                               terms, params):
    if b is None:
      check(a is None, f"{name}: unneeded {field} gradient written")
      continue
    check(a.shape == b.shape and a.dtype == b.dtype == p.dtype,
          f"{name}: {field} {tuple(a.shape)} {a.dtype}")
    atol, rtol = GRAD_TOL["atol"], GRAD_TOL["rtol"]
    if b.shape[0] == 1 < x.shape[0]:  # per-gene: a sum over the rows
      atol = atol + SUM_ULPS * (g[:, None] * t).abs().sum(0).cpu().numpy()
    elif bf16_full:
      check(torch.equal(a, a.to(torch.bfloat16).to(a.dtype)),
            f"{name}: {field} written wider than bf16")
      rtol = BF16_GRAD_RTOL
    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
    bad = ~(np.abs(a - b) <= atol + rtol * np.abs(b))
    check(not bad.any(), f"{name}: d{field} {bad.sum()} of {bad.size} "
          f"off, worst |Δ| {np.abs(a - b)[bad].max() if bad.any() else 0}")
    bwd_err = max(bwd_err, float(np.abs(a - b).max()))
  check(torch.equal(out, tz._fwd_launch(x, cr, lg, gt, constrained)),
        f"{name}: forward not bitwise reproducible")
  twice = tz._bwd_launch(x, cr, lg, gt, g, constrained, need)
  check(all(u is None or torch.equal(u, v) for u, v in zip(grads, twice)),
        f"{name}: backward not bitwise reproducible")
  return fwd_err, bwd_err


def kernel_bounds(x, cr, lg, gt, need):
  """Least µs the card could take for each kernel's work on these inputs:
  the larger of bytes (each input read once, each output written once)
  over HBM_BYTES_PER_S and this data's operations (OPS, by the nonzero
  share) over F32_OPS_PER_S. Returns {"fwd"|"bwd": (µs, "bytes"|
  "operations")}."""
  from sisua_tpu_torch.ops import zinb as tz
  b = x.shape[0]
  reads = sum(t.numel() * t.element_size() for t in (x, cr, lg, gt))
  full = tz._write_dtype((cr, lg, gt)).itemsize
  written = {"fwd": 4 * b, "bwd": sum(
      p.numel() * (4 if p.shape[0] == 1 < b else full)
      for p, n in zip((cr, lg, gt), need) if n)}
  read = {"fwd": reads, "bwd": reads + 4 * b}  # + the row cotangent
  nz = int((x > 0).sum())
  out = {}
  for k, (ops_zero, ops_count) in OPS.items():
    t_bytes = (read[k] + written[k]) / HBM_BYTES_PER_S * 1e6
    t_ops = ((x.numel() - nz) * ops_zero + nz * ops_count) \
        / F32_OPS_PER_S * 1e6
    out[k] = ((t_bytes, "bytes") if t_bytes >= t_ops
              else (t_ops, "operations"))
  return out


def _kernel_case(torch, tz, name, x, cr, lg, gt, g, constrained, pg,
                 results):
  """Check, time and log one phase-3 case into ``results``."""
  need = (True, True, name not in NB_GATE_CASES)  # no NB gate gradient
  fwd_err, bwd_err = check_kernels(torch, tz, name, x, cr, lg, gt, g,
                                   constrained, need)
  t_fwd = _time_turns(torch, {
      "plain": lambda: tz._rowsum_ref(x, cr, lg, gt, constrained),
      "kernel": lambda: tz._fwd_launch(x, cr, lg, gt, constrained)})
  t_bwd = _time_turns(torch, {
      "plain": lambda: tz._grads_ref(x, cr, lg, gt, g, constrained, need),
      "kernel": lambda: tz._bwd_launch(x, cr, lg, gt, g, constrained,
                                       need)})
  bounds = kernel_bounds(x, cr, lg, gt, need)
  results[name] = dict(fwd_err=fwd_err, bwd_err=bwd_err, t_fwd=t_fwd,
                       t_bwd=t_bwd, bounds=bounds)
  big = float((cr > 1e6).float().mean()) if constrained else 0.0
  nz = float((x > 0).float().mean())
  shares = {k: bounds[k][0] / t["kernel"] for k, t in
            (("fwd", t_fwd), ("bwd", t_bwd))}
  log(f"[3 kernels] {name} {tuple(x.shape)} constrained={constrained} "
      f"per_gene={pg} θ>1e6 {big:.4f} nonzero {nz:.4f}: fwd max|Δ| "
      f"{fwd_err:.3e} kernel {t_fwd['kernel']:.1f} µs plain "
      f"{t_fwd['plain']:.1f} µs bound {bounds['fwd'][0]:.1f} µs "
      f"({bounds['fwd'][1]}) share {shares['fwd']:.1%} | bwd max|Δ| "
      f"{bwd_err:.3e} kernel {t_bwd['kernel']:.1f} µs plain "
      f"{t_bwd['plain']:.1f} µs bound {bounds['bwd'][0]:.1f} µs "
      f"({bounds['bwd'][1]}) share {shares['bwd']:.1%}; both bitwise "
      f"reproducible")


def phase_kernels(torch):
  """Phase 3: the float32 cases, then the bf16 modes (``BF16_CASES``) on
  the same operands."""
  from sisua_tpu_torch.ops import zinb as tz
  gen = torch.Generator(device=DEVICE).manual_seed(SEED)
  results, cases = {}, {}
  for name, rows, cols, constrained, pg in CASES:
    if name == "extreme":
      x, cr, lg, gt = _extreme_case(torch)
    else:
      x, cr, lg, gt = _case(torch, gen, name, rows, cols, constrained, pg)
    g = torch.randn((x.shape[0],), generator=gen, device=DEVICE)
    _kernel_case(torch, tz, name, x, cr, lg, gt, g, constrained, pg,
                 results)
    cases[name] = (x, cr, lg, gt, g, constrained, pg)
  for name, src, mode in BF16_CASES:
    x, cr, lg, gt, g, constrained, pg = cases[src]
    if mode == "operands":
      cr, lg, gt = _to_bf16_case(torch, name, x, cr, lg, gt)
      _kernel_case(torch, tz, name, x, cr, lg, gt, g, constrained, pg,
                   results)
      continue
    os.environ["SISUA_TPU_BWD_WRITES"] = "bf16"
    try:
      _kernel_case(torch, tz, name, x, cr, lg, gt, g, constrained, pg,
                   results)
    finally:
      os.environ.pop("SISUA_TPU_BWD_WRITES", None)
  del cases
  return results


def _scvi(torch, dispersion, seed=SEED, **kw):
  from sisua_tpu_torch.models import SCVI, RVmeta
  return SCVI(RVmeta(GENES, "zinbd", name="rna"),
              latents=RVmeta(16, "diag", name="latents"),
              encoder={"units": [128, 128], "batchnorm": True},
              decoder={"units": [128, 128], "batchnorm": True},
              dispersion=dispersion, device=DEVICE, seed=seed, **kw)


def phase_data(torch):
  """The synthetic transcriptome, training and held-out, on the card."""
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
  t0 = time.perf_counter()
  x = torch.cat([_counts(torch, gen, 1024, GENES)
                 for _ in range(CELLS // 1024)])
  held = _counts(torch, gen, HELD_OUT, GENES)
  torch.cuda.synchronize()
  log(f"[4 fit] data {tuple(x.shape)} on the card "
      f"({x.numel() * 4 / 1e9:.2f} GB f32) in "
      f"{time.perf_counter() - t0:.1f} s")
  return x, held


def _steady(h, torch):
  """Steady step ms and cells/s (median of the last window) and peak
  device memory in GiB."""
  import numpy as np
  step_ms = float(np.median(h["epoch_time"][-WINDOW:])) / (
      CELLS // BATCH) * 1e3
  return (step_ms, float(np.median(h["cells_per_sec"][-WINDOW:])),
          torch.cuda.max_memory_allocated() / 2**30)


def phase_fit(torch, x, held):
  import numpy as np
  from sisua_tpu_torch.data import get_library_size
  from sisua_tpu_torch.ops import zinb as tz
  mean, var = get_library_size(x)
  library = torch.cat([mean, var], dim=1)
  log(f"[4 fit] library mean {float(mean[0]):.4f} var {float(var[0]):.4f}")
  model = _scvi(torch, "full")
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated() / 2**30
  tz.reset_launches()
  t0 = time.perf_counter()
  model.fit(x, epochs=EPOCHS, batch_size=BATCH, learning_rate=1e-3,
            clipnorm=100.0, metrics_interval=WINDOW, device_cache=True)
  fit_s = time.perf_counter() - t0
  steps = EPOCHS * (CELLS // BATCH)
  fit_launches = dict(tz.launches)
  h = model.history
  losses = np.asarray(h["loss"])
  check(len(losses) == EPOCHS and model.step == steps,
        f"ran {len(losses)} epochs / {model.step} steps")
  check(np.isfinite(losses).all(), f"non-finite loss {losses}")
  first, last = losses[:WINDOW].mean(), losses[-WINDOW:].mean()
  check(last < first, f"last window loss {last} !< first {first}")
  check(fit_launches == {"zinb_rowsum_fwd": steps,
                         "zinb_rowsum_bwd": steps},
        f"launches {fit_launches} != {steps} steps")
  step_ms, cells_s, peak = _steady(h, torch)
  PHASE4["step_ms"] = step_ms
  log(f"[4 fit] {steps} steps in {fit_s:.1f} s; loss first window "
      f"{first:.2f} last window {last:.2f}; steady step {step_ms:.3f} ms, "
      f"{cells_s:.0f} cells/s (last window); peak memory "
      f"{peak:.2f} GiB ({resident:.2f} GiB resident before the fit); "
      f"launches {fit_launches}")
  ev = model.evaluate(held, batch_size=BATCH)
  eval_fwd = tz.launches["zinb_rowsum_fwd"] - steps
  check(all(np.isfinite(v) for v in ev.values()), f"evaluate {ev}")
  check(eval_fwd == HELD_OUT // BATCH
        and tz.launches["zinb_rowsum_bwd"] == steps,
        f"evaluate launches {tz.launches}")
  log(f"[4 fit] evaluate on {HELD_OUT} held-out cells: loss "
      f"{ev['loss']:.2f} llk_x {ev['llk_x']:.2f} klqp_z {ev['klqp_z']:.3f}; "
      f"forward launches +{eval_fwd}")
  return model, library, dict(tz.launches)


def _route_grads(torch, model, sd, batch, noise, mode):
  """Loss and parameter gradients of one train-mode step under one route,
  from the same state, dropout draws and reparameterization noise
  (``SISUA_TPU_FUSED_LIKELIHOOD``: 'auto' takes the kernels on the card,
  'off' the distribution math)."""
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    model.module.load_state_dict(sd)
    model.generator.manual_seed(SEED + 7)
    model.module.zero_grad(set_to_none=True)
    loss, _, _ = model._loss(batch, True, 1.0, noise=noise)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: p.grad.detach().clone()
                         for k, p in model.module.named_parameters()}
  finally:
    os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD", None)


def _batchnormed_biases(module):
  """The biases of the Dense layers a BatchNorm follows: BatchNorm takes
  out any constant shift, so their gradient is zero but for rounding."""
  names = dict(module.named_modules())
  return {f"{owner}.dense{i}.bias" for owner, m in names.items()
          for i in range(len(getattr(getattr(m, "conf", None), "units", ())))
          if f"{owner}.bn{i}" in names}


def _compare_routes(torch, phase, label, model, sd, batch, noise, expect,
                    grad_bound=None, vanishing_floor=None):
  """Kernel route vs plain route of one step: each kernel launched
  ``expect`` times on the kernel route and never on the plain one; loss
  within ROUTE_LOSS_RTOL; every parameter gradient's max|Δ| within
  ``grad_bound`` (ROUTE_GRAD_BOUND unless given) of its max|g| plus 1e-3
  times the largest gradient G. With ``vanishing_floor`` (a bf16 model,
  whose rounding leaves noise where a gradient vanishes) the biases ahead
  of a BatchNorm are held instead to max|g| ≤ vanishing_floor·G on both
  routes. Returns the kernel route's loss."""
  grad_bound = ROUTE_GRAD_BOUND if grad_bound is None else grad_bound
  vanishing = (_batchnormed_biases(model.module)
               if vanishing_floor is not None else set())
  from sisua_tpu_torch.ops import zinb as tz
  before = dict(tz.launches)
  lk, gk = _route_grads(torch, model, sd, batch, noise, "auto")
  mid = dict(tz.launches)
  check(all(mid[k] - before[k] == expect for k in mid),
        f"{label}: kernel route launches {before} → {mid}, expected "
        f"+{expect} each")
  lp, gp = _route_grads(torch, model, sd, batch, noise, "off")
  check(tz.launches == mid, f"{label}: plain route launched a kernel")
  check(abs(lk - lp) <= ROUTE_LOSS_RTOL * abs(lp),
        f"{label}: loss kernel {lk} plain {lp}")
  scale = max(float(g.abs().max()) for g in gp.values())
  worst, worst_key, noise_max = 0.0, None, 0.0
  for k in vanishing:
    noise_max = max(noise_max, float(gp[k].abs().max()),
                    float(gk[k].abs().max()))
  check(noise_max <= (vanishing_floor or 0.0) * scale,
        f"{label}: a bias ahead of a BatchNorm has gradient {noise_max:.2e}"
        f" > {vanishing_floor}·G")
  for k, g in gp.items():
    if k in vanishing:
      continue
    bound = float(g.abs().max()) + 1e-3 * scale
    ratio = float((gk[k] - g).abs().max()) / bound
    if ratio > worst:
      worst, worst_key = ratio, k
  check(worst <= grad_bound,
        f"{label}: gradient {worst_key} off by {worst:.2e}")
  log(f"[{phase}] {label}: loss kernel {lk:.4f} plain {lp:.4f} "
      f"(rel {abs(lk - lp) / abs(lp):.2e}); worst gradient "
      f"max|Δ|/(max|g|+1e-3·G) {worst:.2e} at {worst_key} "
      f"(bound {grad_bound})"
      + (f"; the {len(vanishing)} biases ahead of a BatchNorm max|g| "
         f"{noise_max / scale:.2e}·G (bound {vanishing_floor:.2g})"
         if vanishing else "") + f"; kernel launches +{expect} each")
  return lk


def _converted(model, src):
  """``model``'s state_dict from ``src``'s weights, through the JAX layout
  and back (every leaf must map)."""
  from sisua_tpu_torch import convert
  params, stats = convert.torch_to_jax(src.module)
  return convert.jax_to_torch(model.module, params, stats)


def phase_routes(torch, trained, x, library):
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
  rows = torch.arange(BATCH, device=DEVICE)
  batch = {"inputs": [x[rows]], "library": library[rows],
           "mask": torch.ones(BATCH, device=DEVICE)}
  noise = [torch.randn((BATCH, 16), generator=gen, device=DEVICE),
           torch.randn((BATCH, 1), generator=gen, device=DEVICE)]
  for dispersion in ("full", "single"):
    src = trained if dispersion == "full" else _scvi(torch, "single")
    model = _scvi(torch, dispersion)
    _compare_routes(torch, "5 routes", dispersion, model,
                    _converted(model, src), batch, noise, 1)


def _sisua_outputs():
  from sisua_tpu_torch.models import RVmeta
  return [RVmeta(GENES, "zinb", name="rna"),
          RVmeta(PROTEINS, "nb", name="adt")]


def phase_sisua(torch, x, held):
  """SISUA at the JAX package's defaults: encoder (64, 64) with batchnorm
  and input dropout 0.3, decoder (64, 64) with batchnorm, latent 10
  'diag'."""
  import numpy as np
  from sisua_tpu_torch.models import SISUA
  from sisua_tpu_torch.ops import zinb as tz
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
  y, held_y = _proteins(torch, gen, CELLS), _proteins(torch, gen, HELD_OUT)
  model = SISUA(_sisua_outputs(), alpha=ALPHA, device=DEVICE, seed=SEED)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated() / 2**30
  tz.reset_launches()
  t0 = time.perf_counter()
  model.fit([x, y], valid=[held, held_y], epochs=EPOCHS, batch_size=BATCH,
            learning_rate=1e-3, labels_percent=LABELS_PERCENT,
            metrics_interval=WINDOW, device_cache=True)
  fit_s = time.perf_counter() - t0
  fit_launches = dict(tz.launches)
  steps = EPOCHS * (CELLS // BATCH)
  val_batches = (EPOCHS // WINDOW) * -(-HELD_OUT // BATCH)
  h = model.history
  losses = np.asarray(h["loss"])
  check(len(losses) == EPOCHS and model.step == steps,
        f"ran {len(losses)} epochs / {model.step} steps")
  check(np.isfinite(losses).all(), f"non-finite loss {losses}")
  first, last = losses[:WINDOW].mean(), losses[-WINDOW:].mean()
  check(last < first, f"last window loss {last} !< first {first}")
  check("llk_x1" in h and len(h.get("val_loss", ())) == EPOCHS // WINDOW
        and np.isfinite(h["val_loss"]).all(),
        f"history keys {sorted(h)}, val_loss {h.get('val_loss')}")
  check(fit_launches == {"zinb_rowsum_fwd": 2 * (steps + val_batches),
                         "zinb_rowsum_bwd": 2 * steps},
        f"launches {fit_launches}: expected 2 × ({steps} steps + "
        f"{val_batches} validation batches) forward, 2 × {steps} backward")
  step_ms, cells_s, peak = _steady(h, torch)
  PHASE6["step_ms"] = step_ms
  log(f"[6 sisua] {steps} steps in {fit_s:.1f} s; loss first window "
      f"{first:.2f} last window {last:.2f}; llk_x1 {h['llk_x1'][-1]:.2f}; "
      f"val_loss {h['val_loss'][0]:.2f} → {h['val_loss'][-1]:.2f}; steady "
      f"step {step_ms:.3f} ms, {cells_s:.0f} cells/s (last window); peak "
      f"memory {peak:.2f} GiB ({resident:.2f} GiB resident before the "
      f"fit); launches {fit_launches}")
  ev = model.evaluate([held, held_y], batch_size=BATCH)
  eval_fwd = tz.launches["zinb_rowsum_fwd"] - fit_launches["zinb_rowsum_fwd"]
  check(all(np.isfinite(v) for v in ev.values()), f"evaluate {ev}")
  check(eval_fwd == 2 * -(-HELD_OUT // BATCH)
        and tz.launches["zinb_rowsum_bwd"] == 2 * steps,
        f"evaluate launches {tz.launches}")
  log(f"[6 sisua] evaluate on {HELD_OUT} held-out cells: loss "
      f"{ev['loss']:.2f} llk_x {ev['llk_x']:.2f} llk_x1 {ev['llk_x1']:.2f} "
      f"klqp_z {ev['klqp_z']:.3f}; forward launches +{eval_fwd}")
  return model, y, held_y, fit_launches


def phase_model_routes(torch, trained, x, y):
  from sisua_tpu_torch.models import MISA, SISUA, DeepCountAutoencoder
  from sisua_tpu_torch.models import RVmeta
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
  rows = torch.arange(BATCH, device=DEVICE)
  mask = (torch.rand((BATCH,), generator=gen, device=DEVICE)
          < 0.5).to(torch.float32)
  batch = {"inputs": [x[rows], y[rows]], "mask": mask}
  z = [torch.randn((BATCH, 10), generator=gen, device=DEVICE)]
  cases = (
      ("SISUA", trained, SISUA(_sisua_outputs(), alpha=ALPHA,
                               device=DEVICE, seed=SEED), z, 2),
      ("DCA", None, DeepCountAutoencoder(RVmeta(GENES, "zinb", name="rna"),
                                         device=DEVICE, seed=SEED),
       [None], 1),
      ("MISA", None, MISA([RVmeta(GENES, "zinb", name="rna"),
                           RVmeta(PROTEINS, "nbd", name="adt")],
                          alpha=ALPHA, device=DEVICE, seed=SEED), z, 1))
  for name, src, model, noise, expect in cases:
    sd = _converted(model, src or model)
    lk = _compare_routes(torch, "7 routes", name, model, sd, batch, noise,
                         expect)
    if name == "SISUA":
      ones = dict(batch, mask=torch.ones_like(mask))
      l1, _ = _route_grads(torch, model, sd, ones, noise, "auto")
      check(abs(lk - l1) > 1e-4 * abs(l1),
            f"SISUA: the mask does not gate the loss ({lk} vs {l1})")
      log(f"[7 routes] SISUA: mixed mask ({int(mask.sum())} of {BATCH} "
          f"labeled) loss {lk:.4f}, all-ones mask loss {l1:.4f}")


def _save_trained(torch, model, held_data, root):
  """Before a trained model goes: its evaluate on the held-out cells at a
  fixed noise seed, its weights and history, then ``save_weights``."""
  model.generator.manual_seed(SEED + 8)
  ev = model.evaluate(held_data, batch_size=BATCH)
  path = os.path.join(root, type(model).__name__)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  model.save_weights(path)
  save_s = time.perf_counter() - t0
  size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
  n_params = sum(p.numel() for p in model.module.parameters())
  return dict(path=path, ev=ev, save_s=save_s, bytes=size,
              n_params=n_params,
              history={k: list(v) for k, v in model.history.items()},
              state={k: v.detach().to("cpu", copy=True)
                     for k, v in model.module.state_dict().items()})


def _dist_rel_err(torch, a, b):
  """Max relative difference over every parameter tensor of two
  distributions (or tuples of them) of the same structure."""
  from sisua_tpu_torch import dist as D
  worst = [0.0]

  def leaf(u, v):
    check(u.shape == v.shape, f"leaf shapes {tuple(u.shape)} {tuple(v.shape)}")
    den = v.abs().clamp_min(1e-6)
    worst[0] = max(worst[0], float(((u - v).abs() / den).max()))
    return u
  for u, v in zip(a if isinstance(a, tuple) else (a,),
                  b if isinstance(b, tuple) else (b,)):
    D.tree_map(leaf, u, v)
  return worst[0]


def _elbo_rna(ev):
  """ELBO of the RNA head from evaluate's metrics: llk_x less every KL."""
  return ev["llk_x"] - sum(v for k, v in ev.items() if k.startswith("klqp"))


def _serve_model(torch, tag, saved, x, held_data, smi):
  """Phase 8 for one saved model; returns the forward launches of its
  reloaded evaluate."""
  import numpy as np
  from sisua_tpu_torch.models import load_model
  from sisua_tpu_torch.ops import zinb as tz
  heads = 2 if tag == "SISUA" else 1
  held = held_data[0]
  t0 = time.perf_counter()
  m = load_model(saved["path"], device=DEVICE)
  torch.cuda.synchronize()
  load_s = time.perf_counter() - t0
  sd = m.module.state_dict()
  check(sd.keys() == saved["state"].keys()
        and all(torch.equal(sd[k].cpu(), v) for k, v in saved["state"].items()),
        f"{tag}: reloaded weights differ from the saved ones")
  check(m.history == saved["history"], f"{tag}: history not restored")
  log(f"[8 serve] {tag}: {saved['n_params']:,} parameters, checkpoint "
      f"{saved['bytes']:,} bytes; save {saved['save_s']:.3f} s, load_model "
      f"onto the card {load_s:.3f} s; weights bitwise equal, history of "
      f"{len(m.history['loss'])} epochs restored | {smi}")

  # evaluate: the reloaded model at the trained model's noise
  before = tz.launches["zinb_rowsum_fwd"]
  m.generator.manual_seed(SEED + 8)
  ev = m.evaluate(held_data, batch_size=BATCH)
  fwd = tz.launches["zinb_rowsum_fwd"] - before
  check(fwd == heads * -(-HELD_OUT // BATCH),
        f"{tag}: evaluate launched the forward {fwd} times")
  for k, v in saved["ev"].items():
    check(abs(ev[k] - v) <= EVAL_RTOL * abs(v),
          f"{tag}: evaluate {k} {ev[k]} vs trained {v}")
  log(f"[8 serve] {tag}: evaluate of the reloaded model = the trained "
      f"model's (loss {ev['loss']:.4f}, rtol {EVAL_RTOL}); forward "
      f"launches +{fwd}")
  serving_start = dict(tz.launches)

  # predict: streaming vs device-cached on the RNA matrix alone
  outs = {}
  for dc in (False, True):
    m.generator.manual_seed(SEED + 9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs[dc] = m.predict(held, batch_size=BATCH, device_cache=dc)
    outs[dc] += (time.perf_counter() - t0,)
  (pX, qZ, t_s), (pX2, qZ2, t_d) = outs[False], outs[True]
  err = max(_dist_rel_err(torch, pX2, pX), _dist_rel_err(torch, qZ2, qZ))
  check(err <= SERVE_RTOL, f"{tag}: predict paths differ by {err:.3e}")
  px0 = pX[0] if isinstance(pX, tuple) else pX
  z0 = qZ[0] if isinstance(qZ, tuple) else qZ
  check(tuple(px0.mean().shape) == (HELD_OUT, GENES)
        and tuple(z0.mean().shape)[0] == HELD_OUT
        and px0.mean().device.type == "cpu",
        f"{tag}: predict shapes {tuple(px0.mean().shape)} "
        f"{tuple(z0.mean().shape)}")
  log(f"[8 serve] {tag}: predict({HELD_OUT} cells, RNA matrix alone) "
      f"streaming {t_s:.3f} s, device_cache {t_d:.3f} s, max rel Δ "
      f"{err:.2e}; leaves full-batch, on the host | {smi}")
  del outs, pX, pX2, qZ2, px0

  # predict_mean on the training cells: cells/s to the host fetch
  rates = {}
  torch.cuda.reset_peak_memory_stats()
  m.predict_mean(x[:BATCH], batch_size=BATCH)  # warm-up
  for shape in ((), (MC,)):
    m.generator.manual_seed(SEED + 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xm, zm = m.predict_mean(x, sample_shape=shape, batch_size=BATCH)
    rates[shape] = CELLS / (time.perf_counter() - t0)
    check(all(np.isfinite(a).all() for a in xm + zm)
          and xm[0].shape == (CELLS, GENES) and zm[0].shape[0] == CELLS,
          f"{tag}: predict_mean{shape} not finite or misshapen")
    if shape == ():
      ref_x, ref_z = xm, zm
  peak = torch.cuda.max_memory_allocated() / 2**30
  m.generator.manual_seed(SEED + 10)
  t0 = time.perf_counter()
  bx, bz = m.predict_mean(x, batch_size=BATCH, fetch_dtype="bfloat16")
  bf16_rate = CELLS / (time.perf_counter() - t0)
  for a, b in zip(bx + bz, ref_x + ref_z):
    np.testing.assert_allclose(a, b, rtol=BF16_RTOL, atol=1e-30,
                               err_msg=f"{tag}: bf16 fetch")
  host = x.cpu().numpy()
  m.generator.manual_seed(SEED + 10)
  t0 = time.perf_counter()
  hx, _ = m.predict_mean(host, batch_size=BATCH)
  host_rate = CELLS / (time.perf_counter() - t0)
  np.testing.assert_allclose(hx[0], ref_x[0], rtol=SERVE_RTOL,
                             err_msg=f"{tag}: int16 host upload")
  del host, hx, bx, bz
  _, qz_all = m.predict(x, batch_size=BATCH, device_cache=True)
  for z, q in zip(ref_z, qz_all if isinstance(qz_all, tuple) else (qz_all,)):
    np.testing.assert_allclose(z, q.mean().numpy(), rtol=1e-6, atol=1e-7,
                               err_msg=f"{tag}: latent means vs predict")
  del qz_all
  log(f"[8 serve] {tag}: predict_mean on {CELLS} card-resident cells "
      f"({CELLS * GENES * 4 / 1e9:.2f} GB f32 means): sample_shape () "
      f"{rates[()]:.0f} cells/s, ({MC},) {rates[(MC,)]:.0f} cells/s, bf16 "
      f"fetch {bf16_rate:.0f} cells/s (within {BF16_RTOL:.0%}); from host "
      f"numpy (int16 upload) {host_rate:.0f} cells/s; peak memory "
      f"{peak:.2f} GiB; latent means = predict's | {smi}")

  # forced chunking: three or more chunks give the same means
  bpr = 4 * GENES
  os.environ["SISUA_TPU_SERVING_BUDGET"] = str(2 * bpr * (CELLS // 4))
  try:
    n_chunks = len(m._serving_chunks([x], BATCH))
    m.generator.manual_seed(SEED + 10)
    cx, cz = m.predict_mean(x, batch_size=BATCH)
  finally:
    os.environ.pop("SISUA_TPU_SERVING_BUDGET")
  check(n_chunks >= 3, f"{tag}: {n_chunks} chunks")
  for a, b in zip(cx + cz, ref_x + ref_z):
    np.testing.assert_allclose(a, b, rtol=SERVE_RTOL,
                               err_msg=f"{tag}: chunked predict_mean")
  del cx, cz, ref_x, ref_z, xm, zm
  log(f"[8 serve] {tag}: forced budget → {n_chunks} chunks, predict_mean "
      f"equal within rtol {SERVE_RTOL}")

  if tag == "SCVI":
    scale = m.get_normalized_expression(held, sample_shape=(MC,),
                                        batch_size=BATCH)
    rows = scale.astype(np.float64).sum(1)
    check(scale.shape == (HELD_OUT, GENES)
          and np.abs(rows - 1).max() <= 1e-5,
          f"{tag}: normalized rows sum to {rows.min()}..{rows.max()}")
    log(f"[8 serve] {tag}: get_normalized_expression ({MC},) rows sum to 1 "
        f"within {np.abs(rows - 1).max():.2e}")

  llk = m.compute_llk(held, {"dataorg": list(held_data)},
                      sample_shape=(MC,), batch_size=BATCH)
  check(all(np.isfinite(v) for v in llk.values()), f"{tag}: llk {llk}")
  bound = ev["llk_x"] - BOUND_SLACK * abs(ev["llk_x"])
  check(llk["dataorg_output0"] >= bound,
        f"{tag}: compute_llk {llk['dataorg_output0']} < llk_x {ev['llk_x']}")

  sub = [a[:IW_CELLS] for a in held_data]
  m.generator.manual_seed(SEED + 11)
  elbo = _elbo_rna(m.evaluate(sub, batch_size=BATCH))
  t0 = time.perf_counter()
  iw = m.marginal_log_prob(held[:IW_CELLS], sample_shape=IW_SAMPLES,
                           batch_size=IW_BATCH)
  iw_s = time.perf_counter() - t0
  check(iw.shape == (IW_CELLS,) and np.isfinite(iw).all()
        and iw.mean() >= elbo - BOUND_SLACK * abs(elbo),
        f"{tag}: marginal_log_prob mean {iw.mean()} vs ELBO {elbo}")
  served = {k: tz.launches[k] - serving_start[k] for k in tz.launches}
  # compute_llk: the fused forward once per head and batch (the draws as
  # members); the ELBO's evaluate: once per head and batch
  llk_fwd = heads * -(-HELD_OUT // BATCH)
  check(served == {"zinb_rowsum_fwd": llk_fwd
                   + heads * -(-IW_CELLS // BATCH), "zinb_rowsum_bwd": 0},
        f"{tag}: serving launched kernels {served}")
  log(f"[8 serve] {tag}: compute_llk ({MC},) "
      + " ".join(f"{k} {v:.2f}" for k, v in sorted(llk.items()))
      + f" ≥ evaluate llk_x {ev['llk_x']:.2f}; marginal_log_prob "
      f"(S={IW_SAMPLES}, batch {IW_BATCH}, {IW_CELLS} cells) mean "
      f"{iw.mean():.2f} ≥ ELBO {elbo:.2f}, {iw_s:.2f} s | {smi}")
  return fwd + llk_fwd + heads * -(-IW_CELLS // BATCH)


def phase_per_gene_leaf(torch, held):
  """SCVI 'single' dispersion: both predict paths keep the (1, D) leaf."""
  m = _scvi(torch, "single")
  for dc in (False, True):
    pX, _ = m.predict(held, batch_size=BATCH, device_cache=dc)
    disp = pX.base.count_distribution.disp
    check(tuple(disp.shape) == (1, GENES)
          and tuple(pX.mean().shape) == (HELD_OUT, GENES),
          f"per-gene leaf {tuple(disp.shape)} (device_cache={dc})")
  log(f"[8 serve] SCVI 'single': per-gene dispersion kept as one (1, "
      f"{GENES}) row by both predict paths over {HELD_OUT // BATCH} batches")


def phase_serving(torch, saved, x, held, held_y, smi):
  """Reload both models from disk and serve them; returns the forward
  launches of this phase (counted from 0)."""
  from sisua_tpu_torch.ops import zinb as tz
  tz.reset_launches()
  fwd = _serve_model(torch, "SCVI", saved["SCVI"], x, [held], smi)
  fwd += _serve_model(torch, "SISUA", saved["SISUA"], x, [held, held_y],
                      smi)
  check(tz.launches == {"zinb_rowsum_fwd": fwd, "zinb_rowsum_bwd": 0},
        f"serving launches {tz.launches}")
  phase_per_gene_leaf(torch, held)
  return dict(tz.launches)


# phase 9: the zoo's fits, in order, and each one's ZINB/NB heads
ZOO = {"FVAE": 1, "SCALAR": 2, "SCALE": 1, "LDVAE": 1}
GAMMA = 6.0           # FVAE's TC weight (sisua_tpu/models/fvae.py default)
N_COMPONENTS = 10     # SCALE's mixture latent (sisua_tpu/models/scale.py)


def _zoo_model(name, seed=SEED):
  """The JAX package's default nets and latent for each model."""
  from sisua_tpu_torch import models as T
  rna = T.RVmeta(GENES, "nbd" if name == "LDVAE" else "zinb", name="rna")
  kw = dict(device=DEVICE, seed=seed)
  if name == "FVAE":
    return T.FVAE(rna, gamma=GAMMA, **kw)
  if name == "SCALAR":
    return T.SCALAR(_sisua_outputs(), alpha=ALPHA, n_components=N_COMPONENTS,
                    **kw)
  if name == "SCALE":
    return T.SCALE(rna, n_components=N_COMPONENTS, **kw)
  return T.LDVAE(rna, dispersion="single", **kw)


def _latent_noise(torch, model, gen, rows):
  """Reparameterization noise for each latent: a standard-normal draw, or
  (component indices, component noise) for a 'mixgaus' latent."""
  noise = []
  for rv in model.latents:
    k = rv.kw.get("n_components")
    if rv.posterior == "mixgaus":
      noise.append((torch.randint(0, k, (rows,), generator=gen,
                                  device=DEVICE),
                    torch.randn((rows, k, rv.dim), generator=gen,
                                device=DEVICE)))
    else:
      noise.append(torch.randn((rows, rv.dim), generator=gen, device=DEVICE))
  return noise


def _zoo_fit(torch, name, data, smi):
  """One phase 9 fit from launch counts set to 0; returns the model and
  the counts read right after it."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  model = _zoo_model(name)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  model.fit(data, epochs=EPOCHS, batch_size=BATCH, learning_rate=1e-3,
            labels_percent=LABELS_PERCENT, metrics_interval=WINDOW,
            device_cache=True)
  fit_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  steps = EPOCHS * (CELLS // BATCH)
  h = model.history
  losses = np.asarray(h["loss"])
  check(len(losses) == EPOCHS and model.step == steps,
        f"{name}: ran {len(losses)} epochs / {model.step} steps")
  check(np.isfinite(losses).all(), f"{name}: non-finite loss {losses}")
  first, last = losses[:WINDOW].mean(), losses[-WINDOW:].mean()
  check(last < first, f"{name}: last window loss {last} !< first {first}")
  extra = ""
  if name == "FVAE":
    check(all(k in h and np.isfinite(h[k]).all() for k in ("tc",
                                                           "disc_loss")),
          f"FVAE: history keys {sorted(h)}")
    extra = (f"; tc {h['tc'][0]:.3f} → {h['tc'][-1]:.3f}, disc_loss "
             f"{h['disc_loss'][0]:.4f} → {h['disc_loss'][-1]:.4f}")
  heads = ZOO[name]
  check(launches == {"zinb_rowsum_fwd": heads * steps,
                     "zinb_rowsum_bwd": heads * steps},
        f"{name}: launches {launches}, expected {heads} × {steps} steps")
  step_ms, cells_s, peak = _steady(h, torch)
  log(f"[9 zoo] {name}: {steps} steps in {fit_s:.1f} s; loss first window "
      f"{first:.2f} last window {last:.2f}{extra}; launches {launches}")
  SINGLE_MS[name] = step_ms
  log(f"[9 zoo] {name}: steady step {step_ms:.3f} ms, {cells_s:.0f} "
      f"cells/s (last window), peak memory {peak:.2f} GiB | {smi}")
  return model, launches


def _zoo_round_trip(torch, name, model, held_data, root, heads, phase="9 zoo",
                    check_loaded=None):
  """save_weights → load_model: weights (and FVAE's discriminator)
  bitwise equal, evaluate equal within EVAL_RTOL at the same noise;
  ``check_loaded`` (if given) is called with the loaded model. Returns the
  forward launches of the two evaluates."""
  from sisua_tpu_torch.models import load_model
  from sisua_tpu_torch.ops import zinb as tz
  before = tz.launches["zinb_rowsum_fwd"]
  saved = _save_trained(torch, model, held_data, root)
  aux = (None if model.aux is None else
         {k: v.detach().cpu().clone() for k, v in model.aux.state_dict().items()})
  t0 = time.perf_counter()
  m = load_model(saved["path"], device=DEVICE)
  torch.cuda.synchronize()
  load_s = time.perf_counter() - t0
  if check_loaded is not None:
    check_loaded(m)
  sd = m.module.state_dict()
  check(sd.keys() == saved["state"].keys()
        and all(torch.equal(sd[k].cpu(), v) for k, v in saved["state"].items()),
        f"{name}: reloaded weights differ from the saved ones")
  if aux is not None:
    got = m.aux.state_dict()
    check(got.keys() == aux.keys()
          and all(torch.equal(got[k].cpu(), v) for k, v in aux.items()),
          f"{name}: reloaded discriminator differs from the saved one")
  m.generator.manual_seed(SEED + 8)
  ev = m.evaluate(held_data, batch_size=BATCH)
  for k, v in saved["ev"].items():
    check(abs(ev[k] - v) <= EVAL_RTOL * abs(v),
          f"{name}: evaluate {k} {ev[k]} vs trained {v}")
  fwd = tz.launches["zinb_rowsum_fwd"] - before
  check(fwd == 2 * heads * -(-HELD_OUT // BATCH),
        f"{name}: the two evaluates launched the forward {fwd} times")
  log(f"[{phase}] {name}: save_weights → load_model ({saved['bytes']:,} "
      f"bytes{', aux_params.msgpack' if aux is not None else ''}; save "
      f"{saved['save_s']:.2f} s, load {load_s:.2f} s): weights"
      f"{' and discriminator' if aux is not None else ''} bitwise equal, "
      f"evaluate loss {ev['loss']:.4f} = trained (rtol {EVAL_RTOL})")
  return fwd


def phase_zoo(torch, x, held, y, held_y, library, root, smi):
  """Phase 9; returns the launches of its fits and round trips."""
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
  rows = torch.arange(BATCH, device=DEVICE)
  mask = (torch.rand((BATCH,), generator=gen, device=DEVICE)
          < 0.5).to(torch.float32)
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  for name in ZOO:
    two = name == "SCALAR"
    model, launches = _zoo_fit(torch, name, [x, y] if two else x, smi)
    fwd = _zoo_round_trip(torch, name, model, [held, held_y] if two
                          else [held], root, ZOO[name])
    total = {k: v + launches[k] for k, v in total.items()}
    total["zinb_rowsum_fwd"] += fwd
    batch = {"inputs": [x[rows], y[rows]] if two else [x[rows]],
             "mask": mask}
    if model.uses_library:
      batch["library"] = library[rows]
    fresh = _zoo_model(name)
    _compare_routes(torch, "9 zoo", name, fresh, _converted(fresh, model),
                    batch, _latent_noise(torch, fresh, gen, BATCH), ZOO[name])
    del model, fresh
  return total


# phase 10: each fit and its ZINB/NB heads (TotalVI's protein mixture and
# SCANVI's cell-type head take plain math)
PHASE10 = {"SCVI_batch": 2, "TotalVI": 1, "SCANVI": 1}
N_BATCHES = 4
CELL_TYPES = 10
SCANVI_ALPHA = 50.0          # sisua_tpu/models/scanvi.py default
TOTALVI_LABELS_PERCENT = 0.5


def _phase10_model(name, seed=SEED):
  """Phase 4's nets for SCVI; the JAX package's default nets for TotalVI
  and SCANVI."""
  from sisua_tpu_torch import models as T
  kw = dict(device=DEVICE, seed=seed)
  rna = T.RVmeta(GENES, "zinbd", name="rna")
  if name == "SCVI_batch":
    return T.SCVI([rna, T.RVmeta(PROTEINS, "nb", name="adt")],
                  latents=T.RVmeta(16, "diag", name="latents"),
                  encoder={"units": [128, 128], "batchnorm": True},
                  decoder={"units": [128, 128], "batchnorm": True},
                  n_batch=N_BATCHES, alpha=ALPHA, **kw)
  if name == "TotalVI":
    return T.TotalVI([rna, T.RVmeta(PROTEINS, "nbd", name="adt")],
                     n_batch=N_BATCHES, mask_protein=True, **kw)
  return T.SCANVI([rna, T.RVmeta(CELL_TYPES, "onehot", name="celltype")],
                  alpha=SCANVI_ALPHA, **kw)


def _phase10_inputs(name, x, y, b, ct):
  """The data matrices of a phase 10 fit: [rna, proteins, batch one-hot]
  or SCANVI's [rna, cell-type one-hot]."""
  return [x, ct] if name == "SCANVI" else [x, y, b]


def _onehots(torch, gen, rows, k):
  return torch.nn.functional.one_hot(
      torch.randint(0, k, (rows,), generator=gen, device=DEVICE), k).float()


def _phase10_noise(torch, model, gen, rows):
  """Phase 9's noise for each latent, then for the forward's second draw:
  TotalVI's log β (rows, proteins), SCANVI's z₂ (classes, rows, z)."""
  noise = _latent_noise(torch, model, gen, rows)
  if type(model).__name__ == "TotalVI":
    noise.append(torch.randn((rows, PROTEINS), generator=gen, device=DEVICE))
  elif type(model).__name__ == "SCANVI":
    noise.append(torch.randn((CELL_TYPES, rows, model.latents[0].dim),
                             generator=gen, device=DEVICE))
  return noise


def _phase10_serve(torch, name, model, held_data):
  """One served call of each model on the held-out cells."""
  import numpy as np
  held = held_data[0]
  if name == "SCVI_batch":
    outs = []
    for data in (held_data[::2], held):  # [rna, one-hot], then rna alone
      model.generator.manual_seed(SEED + 13)
      outs.append(model.predict_mean(data, batch_size=BATCH)[0][0])
    check(all(np.isfinite(o).all() and o.shape == (HELD_OUT, GENES)
              for o in outs), "SCVI_batch: predict_mean not finite")
    rel = float(np.abs(outs[0] - outs[1]).max() / np.abs(outs[1]).max())
    check(rel > 1e-4, f"SCVI_batch: the one-hot does not move the means "
          f"(max rel Δ {rel:.2e})")
    return (f"predict_mean([rna, one-hot]) differs from the uniform batch "
            f"prior's by up to {rel:.3e} of the largest mean")
  if name == "TotalVI":
    fg = model.denoised_proteins(held_data, batch_size=BATCH)
    check(fg.shape == (HELD_OUT, PROTEINS) and np.isfinite(fg).all()
          and fg.min() >= 0.0 and fg.max() <= 1.0,
          f"TotalVI: denoised_proteins {fg.shape} in "
          f"[{fg.min()}, {fg.max()}]")
    return (f"denoised_proteins {fg.shape} in [{fg.min():.4f}, "
            f"{fg.max():.4f}], mean {fg.mean():.4f}")
  probs = model.predict_labels(held, batch_size=BATCH)
  hard = model.predict_labels(held, batch_size=BATCH, hard=True)
  check(probs.shape == (HELD_OUT, CELL_TYPES)
        and np.abs(probs.sum(1) - 1).max() <= 1e-5
        and np.array_equal(hard, probs.argmax(1)),
        f"SCANVI: predict_labels {probs.shape}")
  acc = float((hard == held_data[1].argmax(1).cpu().numpy()).mean())
  return (f"predict_labels {probs.shape}, rows sum to 1; agreement with the "
          f"(random) held-out labels {acc:.3f}")


def _phase10_fit(torch, name, data, valid, smi):
  """One phase 10 fit from launch counts set to 0; returns the model and
  the counts read right after it."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  model = _phase10_model(name)
  labels = {"TotalVI": TOTALVI_LABELS_PERCENT}.get(name, LABELS_PERCENT)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  model.fit(data, valid=valid, epochs=EPOCHS, batch_size=BATCH,
            learning_rate=1e-3, labels_percent=labels,
            metrics_interval=WINDOW, device_cache=True)
  fit_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  steps = EPOCHS * (CELLS // BATCH)
  val_batches = (EPOCHS // WINDOW) * -(-HELD_OUT // BATCH)
  h = model.history
  losses = np.asarray(h["loss"])
  check(len(losses) == EPOCHS and model.step == steps,
        f"{name}: ran {len(losses)} epochs / {model.step} steps")
  check(np.isfinite(losses).all() and np.isfinite(h["val_loss"]).all(),
        f"{name}: non-finite loss {losses} / {h['val_loss']}")
  first, last = losses[:WINDOW].mean(), losses[-WINDOW:].mean()
  check(last < first, f"{name}: last window loss {last} !< first {first}")
  own = {"SCVI_batch": ("llk_x1",), "TotalVI": ("llk_x1", "klqp_z2"),
         "SCANVI": ("klqp_hierarchy", "kl_y")}[name]
  check(all(k in h and np.isfinite(h[k]).all() for k in own),
        f"{name}: history keys {sorted(h)}")
  heads = PHASE10[name]
  check(launches == {"zinb_rowsum_fwd": heads * (steps + val_batches),
                     "zinb_rowsum_bwd": heads * steps},
        f"{name}: launches {launches}, expected {heads} × ({steps} steps "
        f"+ {val_batches} validation batches) forward, {heads} × {steps} "
        "backward")
  step_ms, cells_s, peak = _steady(h, torch)
  log(f"[10 batch] {name}: {steps} steps in {fit_s:.1f} s; loss first "
      f"window {first:.2f} last window {last:.2f}; val_loss "
      f"{h['val_loss'][0]:.2f} → {h['val_loss'][-1]:.2f}; "
      + ", ".join(f"{k} {h[k][-1]:.3f}" for k in own)
      + f"; launches {launches}")
  SINGLE_MS[name] = step_ms
  log(f"[10 batch] {name}: steady step {step_ms:.3f} ms, {cells_s:.0f} "
      f"cells/s (last window), peak memory {peak:.2f} GiB | {smi}")
  return model, launches


def _batch_onehots(torch, gen):
  """Phase 10's batch one-hots over N_BATCHES, training and held-out."""
  return (_onehots(torch, gen, CELLS, N_BATCHES),
          _onehots(torch, gen, HELD_OUT, N_BATCHES))


def phase_batch(torch, x, held, y, held_y, library, root, smi):
  """Phase 10; returns the launches of its fits and round trips."""
  from sisua_tpu_torch.ops import zinb as tz
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
  b, held_b = _batch_onehots(torch, gen)
  ct, held_ct = _onehots(torch, gen, CELLS, CELL_TYPES), _onehots(
      torch, gen, HELD_OUT, CELL_TYPES)
  rows = torch.arange(BATCH, device=DEVICE)
  mask = (torch.rand((BATCH,), generator=gen, device=DEVICE)
          < 0.5).to(torch.float32)
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  for name, heads in PHASE10.items():
    data = _phase10_inputs(name, x, y, b, ct)
    held_data = _phase10_inputs(name, held, held_y, held_b, held_ct)
    model, launches = _phase10_fit(torch, name, data, held_data, smi)
    fwd = _zoo_round_trip(torch, name, model, held_data, root, heads,
                          phase="10 batch")
    total = {k: v + launches[k] for k, v in total.items()}
    total["zinb_rowsum_fwd"] += fwd
    before = dict(tz.launches)
    log(f"[10 batch] {name}: {_phase10_serve(torch, name, model, held_data)}")
    check(tz.launches == before, f"{name}: serving launched a kernel")
    batch = {"inputs": [m[rows] for m in data], "mask": mask,
             "library": library[rows]}
    fresh = _phase10_model(name)
    _compare_routes(torch, "10 batch", name, fresh, _converted(fresh, model),
                    batch, _phase10_noise(torch, fresh, gen, BATCH), heads)
    del model, fresh
  return total


# phase 11: PEAKVI and MULTIVI at Multiome width: 10x Genomics' "PBMC from
# a healthy donor, granulocytes removed through cell sorting (10k)"
# Multiome set as scvi-tools' MultiVI tutorial loads it has 108,377 peaks
# (and 36,601 genes; the RNA side keeps phase 4's 33,000)
PEAKS = 108_377
ATAC_RATE = 0.027     # Poisson scale: ~5% of (cell, peak) entries nonzero
ATAC_MAX = 4.0        # counts of 1–4
MOSAIC = 0.1          # share of ATAC-only cells, and of RNA-only cells
MULTIOME = {"PEAKVI": 0, "MULTIVI": 1}  # ZINB/NB heads of each fit


def _atac(torch, gen, rows):
  """Seeded peak counts on the card: Poisson(ATAC_RATE · depth · openness)
  capped at ATAC_MAX, with a per-cell depth exp(0.5·N(0,1)) and a per-peak
  openness exp(N(0,1)), 1,024 rows at a time."""
  opening = torch.exp(torch.randn((PEAKS,), generator=gen, device=DEVICE))
  parts = []
  for lo in range(0, rows, 1024):
    n = min(1024, rows - lo)
    depth = torch.exp(0.5 * torch.randn((n, 1), generator=gen,
                                        device=DEVICE))
    rate = ATAC_RATE * depth * opening
    parts.append(torch.clamp_max(torch.poisson(rate, generator=gen),
                                 ATAC_MAX))
    del rate
  return torch.cat(parts)


def _mosaic(torch, gen, x, a):
  """Zero, in place, the RNA rows of MOSAIC of the cells (ATAC-only) and
  the ATAC rows of another MOSAIC (RNA-only); returns (ATAC-only, RNA-only)
  row indices."""
  n = x.shape[0]
  perm = torch.randperm(n, generator=gen, device=DEVICE)
  k = int(MOSAIC * n)
  atac_only, rna_only = perm[:k], perm[k:2 * k]
  x.index_fill_(0, atac_only, 0.0)
  a.index_fill_(0, rna_only, 0.0)
  return atac_only, rna_only


def _multiome_model(name, seed=SEED):
  """The JAX package's defaults: PEAKVI's encoder (64, 64) with batchnorm
  and input dropout 0.3, decoder (64, 64), latent 10 'diag', depth (32,);
  MULTIVI's 'zinbd' RNA at n_batch = 4, latent 16 'diag', encoders and
  decoders (128, 128) with batchnorm (encoders with dropout 0.1), depth
  (32,), modality_penalty 1."""
  from sisua_tpu_torch import models as T
  kw = dict(device=DEVICE, seed=seed)
  atac = T.RVmeta(PEAKS, "bernoulli", name="atac")
  if name == "PEAKVI":
    return T.PEAKVI(atac, **kw)
  return T.MULTIVI([T.RVmeta(GENES, "zinbd", name="rna"), atac],
                   n_batch=N_BATCHES, **kw)


def _multiome_inputs(name, x, a, b):
  return [a] if name == "PEAKVI" else [x, a, b]


def _multiome_fit(torch, name, data, valid, smi):
  """One phase 11 fit from launch counts set to 0."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  model = _multiome_model(name)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated() / 2**30
  tz.reset_launches()
  t0 = time.perf_counter()
  model.fit(data, valid=valid, epochs=EPOCHS, batch_size=BATCH,
            learning_rate=1e-3, metrics_interval=WINDOW, device_cache=True)
  fit_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  steps = EPOCHS * (CELLS // BATCH)
  val_batches = (EPOCHS // WINDOW) * -(-HELD_OUT // BATCH)
  h = model.history
  losses = np.asarray(h["loss"])
  check(len(losses) == EPOCHS and model.step == steps,
        f"{name}: ran {len(losses)} epochs / {model.step} steps")
  check(np.isfinite(losses).all() and np.isfinite(h["val_loss"]).all(),
        f"{name}: non-finite loss {losses} / {h['val_loss']}")
  first, last = losses[:WINDOW].mean(), losses[-WINDOW:].mean()
  check(last < first, f"{name}: last window loss {last} !< first {first}")
  own = ("modality_penalty", "klqp_z1", "llk_x1") if name == "MULTIVI" \
      else ("llk_x", "klqp_z")
  check(all(k in h and np.isfinite(h[k]).all() for k in own),
        f"{name}: history keys {sorted(h)}")
  heads = MULTIOME[name]
  check(launches == {"zinb_rowsum_fwd": heads * (steps + val_batches),
                     "zinb_rowsum_bwd": heads * steps},
        f"{name}: launches {launches}, expected {heads} × ({steps} steps "
        f"+ {val_batches} validation batches) forward, {heads} × {steps} "
        "backward")
  step_ms, cells_s, peak = _steady(h, torch)
  log(f"[11 multiome] {name}: {steps} steps in {fit_s:.1f} s; loss first "
      f"window {first:.2f} last window {last:.2f}; val_loss "
      f"{h['val_loss'][0]:.2f} → {h['val_loss'][-1]:.2f}; "
      + ", ".join(f"{k} {h[k][-1]:.3f}" for k in own)
      + f"; launches {launches}")
  SINGLE_MS[name] = step_ms
  log(f"[11 multiome] {name}: steady step {step_ms:.3f} ms, {cells_s:.0f} "
      f"cells/s (last window), peak memory {peak:.2f} GiB ({resident:.2f} "
      f"GiB resident before the fit) | {smi}")
  return model, launches


def _multiome_serve(torch, name, model, held_data, held_atac_only):
  """Accessibility estimates over the held-out cells in [0, 1], the
  region-free ones never below; MULTIVI: the joint posterior mean of an
  ATAC-only cell does not move when its (zero) RNA block is fed as zeros,
  a paired cell's does."""
  import numpy as np
  t0 = time.perf_counter()
  est = model.get_accessibility_estimates(held_data, batch_size=BATCH)
  est_s = time.perf_counter() - t0
  free = model.get_accessibility_estimates(held_data, batch_size=BATCH,
                                           region=False)
  check(est.shape == (HELD_OUT, PEAKS) and np.isfinite(est).all()
        and est.min() >= 0.0 and est.max() <= 1.0,
        f"{name}: estimates {est.shape} in [{est.min()}, {est.max()}]")
  check(bool((free >= est).all()),
        f"{name}: region=False below region=True at "
        f"{int((free < est).sum())} entries")
  msg = (f"get_accessibility_estimates {est.shape} in [{est.min():.4f}, "
         f"{est.max():.4f}] ({HELD_OUT / est_s:.0f} cells/s), region=False "
         f"≥ region=True everywhere (mean {free.mean():.4f} vs "
         f"{est.mean():.4f})")
  if name != "MULTIVI":
    return msg
  x, a, b = held_data
  rows = torch.arange(HELD_OUT, device=DEVICE)
  paired = rows[(x.sum(1) > 0) & (a.sum(1) > 0)][:64]
  take = torch.cat([held_atac_only[:64], paired])
  k = len(held_atac_only[:64])
  with torch.no_grad():
    z = model.encode(model._module_input([x[take], a[take], b[take]]))[0]
    z0 = model.encode(model._module_input([torch.zeros_like(x[take]),
                                           a[take], b[take]]))[0]
  z, z0 = z.mean().cpu().numpy(), z0.mean().cpu().numpy()
  same = float(np.abs(z[:k] - z0[:k]).max())
  moved = float(np.abs(z[k:] - z0[k:]).max())
  check(same <= 1e-5 and moved > 1e-3,
        f"MULTIVI: joint mean of ATAC-only cells moved by {same}, of "
        f"paired cells by {moved}")
  return (msg + f"; zeroed RNA block: joint mean of {k} ATAC-only cells "
          f"moved ≤ {same:.1e}, of {len(paired)} paired cells by "
          f"{moved:.3f}")


def phase_multiome(torch, x, held, root, smi):
  """Phase 11 on phase 4's transcriptome (made mosaic in place: the last
  phase to read it) and a seeded ATAC matrix; returns the launches of its
  fits and round trips."""
  from sisua_tpu_torch.data import get_library_size
  from sisua_tpu_torch.ops import zinb as tz
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
  t0 = time.perf_counter()
  a, held_a = _atac(torch, gen, CELLS), _atac(torch, gen, HELD_OUT)
  _, rna_only = _mosaic(torch, gen, x, a)
  held_atac_only, _ = _mosaic(torch, gen, held, held_a)
  torch.cuda.synchronize()
  nz = float((a > 0).float().mean())
  log(f"[11 multiome] ATAC {tuple(a.shape)} + held-out {tuple(held_a.shape)} "
      f"on the card ({(a.numel() + held_a.numel()) * 4 / 1e9:.2f} GB f32) in "
      f"{time.perf_counter() - t0:.1f} s: {nz:.4f} nonzero, counts up to "
      f"{float(a.max()):.0f}, {float((a > 1).float().mean()):.4f} above 1; "
      f"mosaic: {int(MOSAIC * CELLS)} ATAC-only and {len(rna_only)} "
      f"RNA-only training cells")
  b, held_b = _batch_onehots(  # phase 10's
      torch, torch.Generator(device=DEVICE).manual_seed(SEED + 14))
  library = torch.cat(get_library_size(x), 1)
  rows = torch.arange(BATCH, device=DEVICE)
  kinds = ((x[rows].sum(1) > 0) & (a[rows].sum(1) > 0),
           x[rows].sum(1) == 0, a[rows].sum(1) == 0)
  check(all(bool(k.any()) for k in kinds),
        "the route batch lacks paired, ATAC-only or RNA-only cells")
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  for name, heads in MULTIOME.items():
    data = _multiome_inputs(name, x, a, b)
    held_data = _multiome_inputs(name, held, held_a, held_b)
    model, launches = _multiome_fit(torch, name, data, held_data, smi)
    fwd = _zoo_round_trip(torch, name, model, held_data, root, heads,
                          phase="11 multiome")
    total = {k: v + launches[k] for k, v in total.items()}
    total["zinb_rowsum_fwd"] += fwd
    before = dict(tz.launches)
    log(f"[11 multiome] {name}: "
        f"{_multiome_serve(torch, name, model, held_data, held_atac_only)}")
    check(tz.launches == before, f"{name}: serving launched a kernel")
    batch = {"inputs": [m[rows] for m in data], "library": library[rows],
             "mask": torch.ones(BATCH, device=DEVICE)}
    fresh = _multiome_model(name)
    _compare_routes(torch, "11 multiome", f"{name} (paired, RNA-only and "
                    f"ATAC-only rows)", fresh, _converted(fresh, model),
                    batch, _latent_noise(torch, fresh, gen, BATCH), heads)
    del model, fresh
  return total


# phase 12: the last of the zoo. AUTOZI's RNA head reaches both kernels
# (its gate composed per gene by δ); SCScope's 'nzmse' head, SOLO and
# CellAssign reach none (plain torch: the JAX package computes them in XLA)
PHASE12 = {"AUTOZI": 1, "SCScope": 0}  # ZINB/NB heads of each fit
SCSCOPE_LATENT = 50     # sisua_tpu/models/scscope.py defaults
SCSCOPE_T_STEPS = 2
# Adam's first steps move every weight of an imputer row by ~lr in one
# direction, so an imputed value by ~lr·Σ inputs: at lr 1e-3 and 33,000
# genes it overflows expm1 in the first epoch (a non-finite loss in both
# packages, as at 400 genes and lr 0.0825 in
# tests/test_torch_port_scscope_autozi.py). SCScope trains at lr·genes = 2.
SCSCOPE_LR = 2.0 / 33_000
SOLO_RATIO = 2.0        # sisua_tpu/models/solo.py defaults
SOLO_EPOCHS = 60
SOLO_BATCH = 256
CA_MARKERS = 20         # planted marker genes per cell type
CA_UNMARKED = 100       # genes marked for no type
CA_DELTA = 2.0          # a marker's planted log fold-change
CA_BETA = (-1.0, 0.5)   # per-gene baseline log rate: mean, std
CA_THETA = 5.0          # NB dispersion of the planted counts
CA_EPOCHS = 150         # sisua_tpu/models/cellassign.py defaults
CA_LR = 1e-2
CA_RECOVERY = 0.9       # share of cells whose planted type must come back


def _phase12_model(name, head="nzmse", seed=SEED):
  """The JAX package's default nets: AUTOZI as SCVI's ('zinbd', 'full'
  dispersion, latent 10); SCScope's encoder (64, 64) with batchnorm and
  input dropout 0.3, decoder (64, 64), latent 50 'linear', t_steps 2."""
  from sisua_tpu_torch import models as T
  kw = dict(device=DEVICE, seed=seed)
  if name == "AUTOZI":
    return T.AUTOZI(T.RVmeta(GENES, "zinbd", name="rna"), **kw)
  return T.SCScope(T.RVmeta(GENES, head, name="rna"),
                   latent_dim=SCSCOPE_LATENT, t_steps=SCSCOPE_T_STEPS, **kw)


def _phase12_fit(torch, name, x, held, smi):
  """One phase 12 fit from launch counts set to 0; returns the model and
  the counts read right after it."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  t0 = time.perf_counter()
  model = _phase12_model(name)
  build_s = time.perf_counter() - t0
  n_params = sum(p.numel() for p in model.module.parameters())
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated() / 2**30
  tz.reset_launches()
  t0 = time.perf_counter()
  lr = SCSCOPE_LR if name == "SCScope" else 1e-3
  model.fit(x, valid=held, epochs=EPOCHS, batch_size=BATCH,
            learning_rate=lr, metrics_interval=WINDOW, device_cache=True)
  fit_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  steps = EPOCHS * (CELLS // BATCH)
  val_batches = (EPOCHS // WINDOW) * -(-HELD_OUT // BATCH)
  h = model.history
  losses = np.asarray(h["loss"])
  check(np.isfinite(losses).all() and np.isfinite(h["val_loss"]).all(),
        f"{name}: non-finite loss {losses} / {h.get('val_loss')}")
  check(len(losses) == EPOCHS and model.step == steps,
        f"{name}: ran {len(losses)} epochs / {model.step} steps")
  first, last = losses[:WINDOW].mean(), losses[-WINDOW:].mean()
  check(last < first, f"{name}: last window loss {last} !< first {first}")
  own = {"AUTOZI": "klqp_delta", "SCScope": "llk_cycles"}[name]
  check(own in h and np.isfinite(h[own]).all(),
        f"{name}: history keys {sorted(h)}")
  heads = PHASE12[name]
  check(launches == {"zinb_rowsum_fwd": heads * (steps + val_batches),
                     "zinb_rowsum_bwd": heads * steps},
        f"{name}: launches {launches}, expected {heads} × ({steps} steps "
        f"+ {val_batches} validation batches) forward, {heads} × {steps} "
        "backward")
  if name == "AUTOZI":
    check(model.n_total_cells == CELLS,
          f"AUTOZI: n_total_cells {model.n_total_cells}")
  step_ms, cells_s, peak = _steady(h, torch)
  log(f"[12 zoo] {name}: {n_params:,} parameters (built on the host in "
      f"{build_s:.1f} s); lr {lr:.3g}; {steps} steps in {fit_s:.1f} s; "
      f"loss first window {first:.4f} last window {last:.4f}; val_loss "
      f"{h['val_loss'][0]:.4f} "
      f"→ {h['val_loss'][-1]:.4f}; {own} {h[own][-1]:.4f}; launches "
      f"{launches}")
  SINGLE_MS[name] = step_ms
  log(f"[12 zoo] {name}: steady step {step_ms:.3f} ms, {cells_s:.0f} "
      f"cells/s (last window), peak memory {peak:.2f} GiB ({resident:.2f} "
      f"GiB resident before the fit) | {smi}")
  return model, launches


def _autozi_checks(torch, model, x, library, gen):
  """AUTOZI's ZI probabilities; the kernel route against the plain route
  at converted weights with δ's two log-gamma draws as the last noise
  entry; δ's gradient from the likelihood alone (the Beta KL taken out)
  through the backward kernel's gate gradient."""
  import numpy as np
  from sisua_tpu_torch.models.autozi import _draw_log_gamma
  q = model.get_zi_probabilities()
  check(q.shape == (GENES,) and np.isfinite(q).all() and q.min() > 0.0
        and q.max() < 1.0, f"AUTOZI: ZI probabilities {q.shape} in "
        f"[{q.min()}, {q.max()}]")
  log(f"[12 zoo] AUTOZI: get_zi_probabilities {q.shape} in ({q.min():.4f}, "
      f"{q.max():.4f}), mean {q.mean():.4f}, {int((q > 0.5).sum())} genes "
      f"above 0.5")
  rows = torch.arange(BATCH, device=DEVICE)
  batch = {"inputs": [x[rows]], "library": library[rows],
           "mask": torch.ones(BATCH, device=DEVICE)}
  fresh = _phase12_model("AUTOZI")
  sd = _converted(fresh, model)
  fresh.module.load_state_dict(sd)
  a, b = fresh.module.delta_posterior()
  with torch.no_grad():
    delta = (_draw_log_gamma(a, gen), _draw_log_gamma(b, gen))
  noise = _latent_noise(torch, fresh, gen, BATCH) + [delta]
  _compare_routes(torch, "12 zoo", "AUTOZI (δ drawn as a noise entry)",
                  fresh, sd, batch, noise, 1)
  fresh._extra_loss = lambda out, batch, training: None
  _, grads = _route_grads(torch, fresh, sd, batch, noise, "auto")
  top = {k: float(grads[k].abs().max())
         for k in ("log_alpha_delta", "log_beta_delta")}
  check(all(np.isfinite(v) and v > 0 for v in top.values()),
        f"AUTOZI: δ's likelihood gradient {top}")
  log(f"[12 zoo] AUTOZI: δ's gradient through the backward kernel's gate "
      f"gradient alone (KL taken out): max|g| log_alpha_delta "
      f"{top['log_alpha_delta']:.3e}, log_beta_delta "
      f"{top['log_beta_delta']:.3e}")


def _phase12_solo(torch, autozi, x, smi):
  """SOLO on the trained AUTOZI at the JAX package's defaults; the
  model's weights bitwise unchanged, no kernel launched."""
  import numpy as np
  from sisua_tpu_torch.models import SOLO
  from sisua_tpu_torch.ops import zinb as tz
  before = {k: v.detach().clone()
            for k, v in autozi.module.state_dict().items()}
  tz.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  solo = SOLO.from_scvi_model(autozi, seed=SEED).fit(
      x, doublet_ratio=SOLO_RATIO, epochs=SOLO_EPOCHS, batch_size=SOLO_BATCH)
  fit_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  p = solo.predict_doublet_proba(x, batch_size=BATCH)
  rate = CELLS / (time.perf_counter() - t0)
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
  i, j = (torch.randint(0, CELLS, (HELD_OUT,), generator=gen, device=DEVICE)
          for _ in range(2))
  p_pairs = solo.predict_doublet_proba(x[i] + x[j], batch_size=BATCH)
  check(all(v == 0 for v in tz.launches.values()),
        f"SOLO: launched {tz.launches}")
  sd = autozi.module.state_dict()
  check(all(torch.equal(sd[k], v) for k, v in before.items()),
        "SOLO: the AUTOZI's weights changed")
  check(p.shape == (CELLS,) and np.isfinite(p).all() and p.min() >= 0.0
        and p.max() <= 1.0, f"SOLO: P(doublet) {p.shape} in "
        f"[{p.min()}, {p.max()}]")
  check(p_pairs.mean() > p.mean(), f"SOLO: summed pairs score "
        f"{p_pairs.mean():.4f}, observed cells {p.mean():.4f}")
  n_doublets = int(round(SOLO_RATIO * CELLS))
  log(f"[12 zoo] SOLO on the AUTOZI: {n_doublets:,} simulated doublets, "
      f"{SOLO_EPOCHS} epochs at batch {SOLO_BATCH}: fit {fit_s:.1f} s; "
      f"predict_doublet_proba {rate:.0f} cells/s; P(doublet) of the "
      f"observed cells mean {p.mean():.4f} ({int((p >= 0.5).sum())} ≥ 0.5), "
      f"of {HELD_OUT} fresh summed pairs {p_pairs.mean():.4f}; model bitwise "
      f"unchanged, no kernel launched | {smi}")


def _phase12_cellassign(torch, x, smi):
  """CellAssign on a planted panel of phase 10's 10 cell types:
  CA_MARKERS markers per type and CA_UNMARKED unmarked genes, NB(θ =
  CA_THETA) counts around log μ = log s + β + δ·ρ with the size factors s
  of phase 4's 33,000-gene library; at least CA_RECOVERY of the cells must
  get their planted type back."""
  import numpy as np
  from sisua_tpu_torch.models import CellAssign
  from sisua_tpu_torch.ops import zinb as tz
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
  genes = CELL_TYPES * CA_MARKERS + CA_UNMARKED
  rho = torch.zeros((genes, CELL_TYPES), device=DEVICE)
  for c in range(CELL_TYPES):
    rho[c * CA_MARKERS:(c + 1) * CA_MARKERS, c] = 1.0
  types = torch.randint(0, CELL_TYPES, (CELLS,), generator=gen,
                        device=DEVICE)
  lib = x.sum(1)
  s = lib / lib.mean()
  beta = CA_BETA[0] + CA_BETA[1] * torch.randn((genes,), generator=gen,
                                               device=DEVICE)
  mu = torch.exp(torch.log(s)[:, None] + beta[None, :]
                 + CA_DELTA * rho[:, types].T)
  lam = torch._standard_gamma(torch.full_like(mu, CA_THETA),
                              generator=gen) * mu / CA_THETA
  counts = torch.poisson(lam, generator=gen)
  del mu, lam
  tz.reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  ca = CellAssign(rho.cpu().numpy(), seed=SEED, device=DEVICE).fit(
      counts, size_factors=s, epochs=CA_EPOCHS, batch_size=BATCH,
      learning_rate=CA_LR)
  fit_s = time.perf_counter() - t0
  losses = np.asarray(ca.history["loss"])
  check(len(losses) == CA_EPOCHS and np.isfinite(losses).all(),
        f"CellAssign: losses {losses}")
  check(losses[-10:].mean() < losses[:10].mean(),
        f"CellAssign: loss {losses[:10].mean()} → {losses[-10:].mean()}")
  hard = ca.predict(counts, size_factors=s, hard=True)
  acc = float((hard == types.cpu().numpy()).mean())
  check(acc >= CA_RECOVERY, f"CellAssign: {acc:.4f} of the cells get their "
        f"planted type back (< {CA_RECOVERY})")
  check(all(v == 0 for v in tz.launches.values()),
        f"CellAssign: launched {tz.launches}")
  fc = ca.get_fold_changes()
  log(f"[12 zoo] CellAssign: {CELLS} cells × {genes} genes ({CELL_TYPES} "
      f"types × {CA_MARKERS} markers + {CA_UNMARKED} unmarked), "
      f"{CA_EPOCHS} epochs at batch {BATCH}: fit {fit_s:.1f} s; loss "
      f"{losses[0]:.4f} → {losses[-1]:.4f}; planted type recovered for "
      f"{acc:.4f} of the cells (threshold {CA_RECOVERY}); marker fold "
      f"changes {fc[fc > 0].min():.3f}–{fc.max():.3f} (planted "
      f"{CA_DELTA}); no kernel launched | {smi}")


def phase_last_zoo(torch, x, held, library, root, smi):
  """Phase 12; returns the launches of its fits and round trips."""
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  autozi, launches = _phase12_fit(torch, "AUTOZI", x, held, smi)
  fwd = _zoo_round_trip(
      torch, "AUTOZI", autozi, [held], root, PHASE12["AUTOZI"],
      phase="12 zoo", check_loaded=lambda m: check(
          m.n_total_cells == CELLS,
          f"AUTOZI: n_total_cells {m.n_total_cells} after load_model"))
  total = {k: v + launches[k] for k, v in total.items()}
  total["zinb_rowsum_fwd"] += fwd
  _autozi_checks(torch, autozi, x, library, gen)
  _phase12_solo(torch, autozi, x, smi)
  del autozi
  scscope, launches = _phase12_fit(torch, "SCScope", x, held, smi)
  check(all(v == 0 for v in launches.values()), "SCScope launched a kernel")
  fwd = _zoo_round_trip(torch, "SCScope", scscope, [held], root, 0,
                        phase="12 zoo")
  check(fwd == 0, f"SCScope: evaluate launched {fwd}")
  del scscope
  zinb = _phase12_model("SCScope", "zinb")
  sd = {k: v.detach().clone() for k, v in zinb.module.state_dict().items()}
  rows = torch.arange(BATCH, device=DEVICE)
  _compare_routes(torch, "12 zoo", "SCScope 'zinb' head (the last cycle "
                  "through the kernels, the first through the imputer)",
                  zinb, sd, {"inputs": [x[rows]],
                             "mask": torch.ones(BATCH, device=DEVICE)},
                  [None], 1)
  del zinb, sd
  _phase12_cellassign(torch, x, smi)
  return total


# ------------------------------------------------------------------ phase 13
# bf16 operands and writes: the route's gradients carry bf16's 2^-8
# relative rounding of the three (B, D) gradient fields; a gradient that
# vanishes (a bias ahead of a BatchNorm) is bf16 rounding noise on either
# route, held below one bf16 rounding (2^-8) of the largest gradient
BF16_ROUTE_GRAD_BOUND = 1e-2
BF16_ROUTE_FLOOR = 2.0 ** -8
# the A/B of the bf16 modes: SISUA_TPU_FWD_OPERANDS / SISUA_TPU_BWD_WRITES
BF16_MODES = {"bf16 operands": {"SISUA_TPU_FWD_OPERANDS": "bf16"},
              "f32 operands": {},
              "f32 operands, bf16 writes": {"SISUA_TPU_BWD_WRITES": "bf16"}}
SURFACE_EPOCHS = 4
OTHER_OPTIMIZERS = ("adamw", "sgd", "rmsprop", "adamax", "adafactor", "lion")


class _Env:
  """Environment variables set for a block, then removed."""

  def __init__(self, env):
    self.env = env

  def __enter__(self):
    os.environ.update(self.env)

  def __exit__(self, *exc):
    for k in self.env:
      os.environ.pop(k, None)


def _bf16_scvi_fit(torch, x, held, mode):
  """Phase 4's SCVI at ``compute_dtype='bfloat16'``, validated on the
  held-out cells, in one of ``BF16_MODES`` from launch counts set to 0.
  Returns (model, launches, (step ms, cells/s, peak GiB), fit s)."""
  from sisua_tpu_torch.ops import zinb as tz
  model = _scvi(torch, "full", compute_dtype="bfloat16")
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with _Env(BF16_MODES[mode]):
    tz.reset_launches()
    t0 = time.perf_counter()
    model.fit(x, valid=held, epochs=EPOCHS, batch_size=BATCH,
              learning_rate=1e-3, clipnorm=100.0, metrics_interval=WINDOW,
              device_cache=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(tz.launches)
  return model, launches, _steady(model.history, torch), fit_s


def phase_bf16(torch, x, held, library, root, smi):
  """Phase 13a, this slice's main path: SCVI 'zinbd', 'full' dispersion,
  ``compute_dtype='bfloat16'`` with SISUA_TPU_FWD_OPERANDS=bf16, through
  both kernels in their bf16 modes; then the A/B of the three modes.
  Returns (the main path's launches, the A/B)."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  mode = "bf16 operands"
  model, launches, (step_ms, cells_s, peak), fit_s = _bf16_scvi_fit(
      torch, x, held, mode)
  h = model.history
  steps = EPOCHS * (CELLS // BATCH)
  val_batches = -(-HELD_OUT // BATCH)
  losses = np.asarray(h["loss"])
  check(len(losses) == EPOCHS and np.isfinite(losses).all(),
        f"bf16 SCVI: losses {losses}")
  first, last = losses[:WINDOW].mean(), losses[-WINDOW:].mean()
  check(last < first, f"bf16 SCVI: last window loss {last} !< {first}")
  check(all(p.dtype == torch.float32 for p in model.module.parameters()),
        "bf16 SCVI: a parameter left float32")
  windows = EPOCHS // WINDOW
  check(launches == {"zinb_rowsum_fwd": steps + windows * val_batches,
                     "zinb_rowsum_bwd": steps},
        f"bf16 SCVI: launches {launches}, expected {steps} steps + "
        f"{windows} × {val_batches} validation batches")
  with _Env(BF16_MODES[mode]):
    ev = model.evaluate(held, batch_size=BATCH)
    check(tz.launches["zinb_rowsum_fwd"] - launches["zinb_rowsum_fwd"]
          == val_batches, f"bf16 SCVI: evaluate launches {tz.launches}")
    log(f"[13 bf16] SCVI compute_dtype='bfloat16', "
        f"SISUA_TPU_FWD_OPERANDS=bf16: {steps} steps in {fit_s:.1f} s; "
        f"loss first window {first:.2f} last window {last:.2f}; val_loss "
        f"{h['val_loss'][0]:.2f} → {h['val_loss'][-1]:.2f}; evaluate loss "
        f"{ev['loss']:.2f}; parameters float32; launches {launches} + "
        f"{val_batches} forward (evaluate)")
    rows = torch.arange(BATCH, device=DEVICE)
    batch = {"inputs": [x[rows]], "library": library[rows],
             "mask": torch.ones(BATCH, device=DEVICE)}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    noise = [torch.randn((BATCH, 16), generator=gen, device=DEVICE),
             torch.randn((BATCH, 1), generator=gen, device=DEVICE)]
    twin = _scvi(torch, "full", compute_dtype="bfloat16")
    _compare_routes(torch, "13 bf16", "SCVI bf16 (kernels in their bf16 "
                    "modes vs the distribution math in f32)", twin,
                    _converted(twin, model), batch, noise, 1,
                    grad_bound=BF16_ROUTE_GRAD_BOUND,
                    vanishing_floor=BF16_ROUTE_FLOOR)
    del twin
    fwd = _zoo_round_trip(
        torch, "SCVI bf16", model, [held], root, 1, phase="13 bf16",
        check_loaded=lambda m: check(
            m.compute_dtype == "bfloat16"
            and m.module.MeanScale.compute_dtype == torch.bfloat16,
            f"bf16 SCVI: load_model gave compute_dtype {m.compute_dtype}"))
  # the path: the fit, its evaluate and the round trip's two evaluates
  main = {"zinb_rowsum_fwd": launches["zinb_rowsum_fwd"] + val_batches + fwd,
          "zinb_rowsum_bwd": launches["zinb_rowsum_bwd"]}
  del model
  # the A/B: each mode twice, in turns, the first run above included
  ab = {mode: [(step_ms, cells_s, peak)]}
  for m in ("f32 operands", "f32 operands, bf16 writes",
            "f32 operands, bf16 writes", "f32 operands", "bf16 operands"):
    model, _, numbers, _ = _bf16_scvi_fit(torch, x, held, m)
    check(np.isfinite(model.history["loss"]).all(), f"{m}: non-finite loss")
    ab.setdefault(m, []).append(numbers)
    del model
  for m, runs in ab.items():
    log(f"[13 bf16] A/B {m}: steady step "
        f"{' / '.join(f'{r[0]:.3f}' for r in runs)} ms, "
        f"{' / '.join(f'{r[1]:.0f}' for r in runs)} cells/s, peak "
        f"{' / '.join(f'{r[2]:.2f}' for r in runs)} GiB | {smi}")
  return main, ab


class _CallCounter:
  """Counts a fit's callback calls (the port's TrainingCallback protocol)."""

  def __init__(self):
    self.counts = {"set_model": 0, "on_epoch_begin": 0, "on_epoch_end": 0,
                   "on_train_end": 0}

  def set_model(self, model):
    self.counts["set_model"] += 1

  def on_epoch_begin(self, epoch, logs):
    self.counts["on_epoch_begin"] += 1

  def on_epoch_end(self, epoch, logs):
    self.counts["on_epoch_end"] += 1
    logs["seen_by_callback"] = float(epoch)

  def on_train_end(self, logs):
    self.counts["on_train_end"] += 1


def phase_fit_surface(torch, x, held, root, smi):
  """Phase 13b: the rest of ``fit`` on phase 4's f32 SCVI at full width.
  Returns the launches of its fits."""
  import numpy as np
  from sisua_tpu_torch import convert
  from sisua_tpu_torch.ops import zinb as tz
  from sisua_tpu_torch.train import Trainer
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}

  def add():
    for k in total:
      total[k] += tz.launches[k]

  steps = CELLS // BATCH
  model = None
  for name in OTHER_OPTIMIZERS:
    model = _scvi(torch, "full")
    before = {k: v.detach().clone() for k, v in
              model.module.named_parameters()}
    tz.reset_launches()
    model.fit(x, epochs=SURFACE_EPOCHS, batch_size=BATCH, optimizer=name,
              learning_rate=1e-3, metrics_interval=SURFACE_EPOCHS,
              device_cache=True)
    add()
    losses = np.asarray(model.history["loss"])
    moved = sum(not torch.equal(v, before[k]) for k, v in
                model.module.named_parameters())
    check(np.isfinite(losses).all() and moved == len(before),
          f"{name}: losses {losses}, {moved} of {len(before)} moved")
    check(tz.launches == {"zinb_rowsum_fwd": SURFACE_EPOCHS * steps,
                          "zinb_rowsum_bwd": SURFACE_EPOCHS * steps},
          f"{name}: launches {tz.launches}")
    step_ms = float(np.median(model.history["epoch_time"])) / steps * 1e3
    log(f"[13 surface] optimizer {name}: {SURFACE_EPOCHS} epochs, loss "
        f"{losses[0]:.2f} → {losses[-1]:.2f}, every parameter moved; step "
        f"{step_ms:.3f} ms | {smi}")
  # fit_query on the last of them: the generative side bitwise frozen
  query = held
  params = dict(model.module.named_parameters())
  frozen = {k for k in params if not convert.flax_param_path(
      model.module, k)[0].startswith(("encoder", "latent_head"))}
  before = {k: v.detach().clone() for k, v in params.items()}
  tz.reset_launches()
  model.fit_query(query, epochs=2, batch_size=BATCH, device_cache=True)
  add()
  check(frozen and all(torch.equal(params[k], before[k]) for k in frozen),
        "fit_query: a frozen tensor moved")
  check(all(not torch.equal(params[k], before[k]) for k in params
            if k not in frozen), "fit_query: a trainable tensor stayed")
  log(f"[13 surface] fit_query on {HELD_OUT} query cells: "
      f"{len(frozen)} frozen tensors ({sorted(model._last_freeze)}) bitwise "
      f"unchanged, {len(params) - len(frozen)} trainable ones moved")
  del model
  # mc_samples: the distribution math in training, the kernels in evaluate
  model = _scvi(torch, "full")
  tz.reset_launches()
  torch.cuda.reset_peak_memory_stats()
  model.fit(x, epochs=1, batch_size=BATCH, mc_samples=3, device_cache=True)
  trained = dict(tz.launches)
  model.evaluate(held, batch_size=BATCH)
  add()
  loss = model.history["loss"][-1]
  check(np.isfinite(loss) and trained == {"zinb_rowsum_fwd": 0,
                                          "zinb_rowsum_bwd": 0},
        f"mc_samples=3: loss {loss}, training launched {trained}")
  check(tz.launches["zinb_rowsum_fwd"] == -(-HELD_OUT // BATCH),
        f"mc_samples=3: evaluate launched {tz.launches}")
  log(f"[13 surface] mc_samples=3: {steps} steps, loss {loss:.2f}, step "
      f"{model.history['epoch_time'][-1] / steps * 1e3:.3f} ms, peak "
      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no kernel in "
      f"training (sample dims take the distribution math), "
      f"{tz.launches['zinb_rowsum_fwd']} forward launches in evaluate")
  del model
  # callbacks, track_gradient_norms and checkpoint_path in one validated fit
  path = os.path.join(root, "scvi_checkpoint")
  counter = _CallCounter()
  model = _scvi(torch, "full")
  tz.reset_launches()
  model.fit(x, valid=held, epochs=SURFACE_EPOCHS, batch_size=BATCH,
            metrics_interval=2, callbacks=[counter], checkpoint_path=path,
            track_gradient_norms=True, device_cache=True)
  add()
  h = model.history
  want = {"set_model": 1, "on_epoch_begin": SURFACE_EPOCHS,
          "on_epoch_end": SURFACE_EPOCHS, "on_train_end": 1}
  check(counter.counts == want, f"callbacks {counter.counts} != {want}")
  check(h.get("seen_by_callback") == [float(e) for e in range(
      SURFACE_EPOCHS)], f"callback metric {h.get('seen_by_callback')}")
  norms = np.asarray(h["grad_norm"])
  check(len(norms) == SURFACE_EPOCHS and np.isfinite(norms).all()
        and (norms > 0).all(), f"grad_norm {norms}")
  check(h["val_loss"][-1] < h["val_loss"][0],
        f"val_loss {h['val_loss']}: the last window must be the best")
  reloaded = _scvi(torch, "full").load_weights(path, raise_notfound=True)
  sd = reloaded.module.state_dict()
  check(all(torch.equal(sd[k], v) for k, v in
            model.module.state_dict().items()),
        "checkpoint_path: the file differs from the best (last) state")
  log(f"[13 surface] callbacks {counter.counts} (a metric injected at "
      f"epoch end is in the history); grad_norm per epoch "
      f"{', '.join(f'{v:.1f}' for v in norms)}; checkpoint_path written at "
      f"each new best reloads bitwise to the best state (val_loss "
      f"{h['val_loss'][0]:.2f} → {h['val_loss'][-1]:.2f})")
  del model, reloaded
  # device_dtype: int16 storage halves the resident bytes, same bits
  (x16,) = Trainer(device_dtype="int16").resident([x])
  check(x16.dtype == torch.int16
        and 2 * x16.numel() * x16.element_size()
        == x.numel() * x.element_size(), "int16: bytes not halved")
  del x16
  hists = {}
  for dd in ("float32", "int16"):
    m = _scvi(torch, "full")
    tz.reset_launches()
    m.fit(x, epochs=2, batch_size=BATCH, device_dtype=dd, device_cache=True)
    add()
    hists[dd] = np.asarray(m.history["loss"])
    del m
  check(np.allclose(hists["int16"], hists["float32"], rtol=1e-6, atol=0),
        f"int16 history {hists['int16']} vs float32 {hists['float32']}")
  log(f"[13 surface] device_dtype='int16': resident "
      f"{x.numel() * 2 / 1e9:.2f} GB for {x.numel() * 4 / 1e9:.2f} GB "
      f"float32; losses {hists['int16'].tolist()} vs float32 "
      f"{hists['float32'].tolist()} "
      f"({'bitwise equal' if np.array_equal(hists['int16'], hists['float32']) else 'within rtol 1e-6'})")
  return total


# phase 14: the probe kernels and the host data path
PROBE_ROWS = 1024        # benchmarks/kernel_probe.py's B (its D is GENES)
PROBE_REPS, PROBE_LAUNCHES = 3, 32
OOC_CELLS = 65_536
OOC_SLICE = 8192         # rows made on the card at a time
OOC_EPOCHS = 3
OOC_BUDGET = 2 ** 31
# what _plan_out_of_core must give for 65,536 × 33,000 under OOC_BUDGET
OOC_PLANS = {"float32": {"chunk_rows": 1536, "n_chunks": 43,
                         "n_resident": 8},
             "int16": {"chunk_rows": 3584, "n_chunks": 19,
                       "n_resident": 7}}
SPARSE_BUDGET = 2 ** 30
SPARSE_EPOCHS = 2
STREAM_VALID_FREQ = 64
PROFILE_STEPS = 32       # streamed steps under torch.profiler
ATLAS_CELLS = 1_000_000  # planned, not trained


def _probe_check(name, got, ref, elems):
  """A probe kernel's row sums against its plain version: FWD_RTOL plus
  SUM_ULPS of the row's Σ|element| (the two sum in another order, and the
  kernel fuses the multiply-adds that the plain version rounds twice).
  Returns max|Δ|."""
  import numpy as np
  g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
  e = elems.abs().sum(-1).double().cpu().numpy()
  err = np.abs(g - r)
  check(np.isfinite(g).all(), f"{name}: row sums not finite")
  check(bool((err <= FWD_RTOL * np.abs(r) + SUM_ULPS * e).all()),
        f"{name}: max|Δ| {err.max():.3e} against its plain version")
  return float(err.max())


def phase_probes(torch):
  """Phase 14a: both probe kernels against their plain versions at
  1024 × 33,000, then ``ops/probe.run_probe`` from launch counts of 0.
  Returns (the kernels-line numbers of both kernels, the ZINB launches of
  the run)."""
  from sisua_tpu_torch.ops import probe as P
  from sisua_tpu_torch.ops import zinb as tz
  x, a, b, c = ops = P.probe_operands(PROBE_ROWS, GENES,
                                      torch.device(DEVICE), SEED)
  # a 64- or 256-long chain over θ = exp(0.5·N) overflows to inf and NaN
  # in both versions, which would compare nothing: a in (0, 1) instead
  ua = torch.rand(x.shape, device=DEVICE,
                  generator=torch.Generator(device=DEVICE).manual_seed(SEED))
  errs = {"elemwise_probe": 0.0, "lgamma_probe": 0.0}
  for n in P.N_FMA:
    aa = a if n == 1 else ua
    got = P.elemwise_probe(x, aa, b, c, n)
    acc = x
    for _ in range(n):
      acc = acc * aa + b
    errs["elemwise_probe"] = max(errs["elemwise_probe"], _probe_check(
        f"elemwise n_fma={n}", got, P.elemwise_probe_ref(x, aa, b, c, n),
        acc))
    check(torch.equal(got, P.elemwise_probe(x, aa, b, c, n)),
          f"elemwise n_fma={n}: not bitwise reproducible")
    del acc
  for w in P.LGAMMA:
    got = P.lgamma_probe(x, a, b, c, w)
    errs["lgamma_probe"] = max(errs["lgamma_probe"], _probe_check(
        f"lgamma {w}", got, P.lgamma_probe_ref(x, a, b, c, w),
        torch.lgamma(x + a + 1.0)))
    check(torch.equal(got, P.lgamma_probe(x, a, b, c, w)),
          f"lgamma {w}: not bitwise reproducible")
  # every stream is read: a NaN planted in c (and in b) reaches its row
  c2, b2 = c.clone(), b.clone()
  c2[5, GENES - 1] = float("nan")
  b2[7, 0] = float("nan")
  nan_rows = lambda t: torch.isnan(t).nonzero().flatten().tolist()  # noqa
  check(nan_rows(P.elemwise_probe(x, a, b, c2, 1)) == [5]
        and nan_rows(P.lgamma_probe(x, a, b2, c2, "lgammaf")) == [5, 7],
        "a probe does not read every operand")
  del c2, b2, ua
  log(f"[14a probes] {PROBE_ROWS} × {GENES}: elemwise n_fma {P.N_FMA} "
      f"max|Δ| {errs['elemwise_probe']:.3e}, lgamma {P.LGAMMA} max|Δ| "
      f"{errs['lgamma_probe']:.3e} against the plain versions (rtol "
      f"{FWD_RTOL} + {SUM_ULPS}·Σ|elem|); bitwise reproducible; a NaN in "
      f"c or b reaches its row (all four streams read)")
  # kernel against plain version in turns (comparison launches: not
  # counted below)
  t_el = _time_turns(torch, {
      "plain": lambda: P.elemwise_probe_ref(x, a, b, c, 1),
      "kernel": lambda: P.elemwise_probe(x, a, b, c, 1)}, reps=5, rounds=2)
  t_lg = _time_turns(torch, {
      "plain": lambda: P.lgamma_probe_ref(x, a, b, c, "lgammaf"),
      "kernel": lambda: P.lgamma_probe(x, a, b, c, "lgammaf")}, reps=5,
      rounds=2)
  P.reset_launches()
  tz.reset_launches()
  rows = P.run_probe(PROBE_ROWS, GENES, reps=PROBE_REPS,
                     launches=PROBE_LAUNCHES, ops=ops,
                     hbm_bytes_per_s=HBM_BYTES_PER_S,
                     f32_ops_per_s=F32_OPS_PER_S)
  launches = dict(P.launches)
  zinb_launches = dict(tz.launches)
  check(all(v > 0 for v in launches.values()),
        f"probe path launched {launches}")
  for r in rows[:-1]:
    log(f"[14a probes] {r['variant']}: {r['ms'] * 1e3:.1f} µs (passes "
        f"{', '.join(f'{t * 1e3:.1f}' for t in r['ms_passes'])}), "
        f"{r['gb_per_s']:.0f} GB/s, {r['gelem_per_s']:.1f} Gelem/s; bound "
        f"{r['bound_ms'] * 1e3:.1f} µs ({r['bound_by']}; bytes "
        f"{r['bytes_bound_ms'] * 1e3:.1f}, operations "
        f"{r['ops_bound_ms'] * 1e3:.1f}), share {r['share']:.1%}")
  log(f"[14a probes] derived: {json.dumps(rows[-1])}")
  log(f"[14a probes] plain versions: elemwise n_fma 1 "
      f"{t_el['plain']:.1f} µs (kernel {t_el['kernel']:.1f}), lgammaf "
      f"{t_lg['plain']:.1f} µs (kernel {t_lg['kernel']:.1f}); launches "
      f"{launches}, ZINB {zinb_launches}")
  by = {r["variant"]: r for r in rows}
  result = {}
  for name, variant, t in (("elemwise_probe", "sol_mem", t_el),
                           ("lgamma_probe", "lg_lgammaf", t_lg)):
    r = by[variant]
    result[name] = {"launches": launches[name], "max_abs_err": errs[name],
                    "ms": r["ms"], "plain_ms": t["plain"] / 1e3,
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
  return result, zinb_launches


def _host_csr(torch, parts, n_cols):
  """Card tensors, row blocks of one matrix, as one host scipy CSR matrix
  (int32 indices: every count here has fewer than 2^31 nonzeros)."""
  import numpy as np
  import scipy.sparse as sp
  data, indices, indptr, nnz = [], [], [np.zeros(1, np.int64)], 0
  rows = 0
  for t in parts:
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
      warnings.simplefilter("ignore", UserWarning)
      c = t.to_sparse_csr()
    indptr.append(c.crow_indices()[1:].cpu().numpy() + nnz)
    indices.append(c.col_indices().to(torch.int32).cpu().numpy())
    data.append(c.values().cpu().numpy())
    nnz += data[-1].size
    rows += t.shape[0]
    del c
  check(nnz < 2 ** 31, f"{nnz} nonzeros overflow int32 indices")
  return sp.csr_matrix((np.concatenate(data), np.concatenate(indices),
                        np.concatenate(indptr).astype(np.int32)),
                       shape=(rows, n_cols))


def _ooc_fit(torch, data, dd, budget, epochs, base):
  """An SCVI ('full', phase 4's nets) fit out of core from launch counts
  of 0; returns (model, launches, seconds, peak bytes above ``base``)."""
  from sisua_tpu_torch.ops import zinb as tz
  model = _scvi(torch, "full")
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  model.fit(data, epochs=epochs, batch_size=BATCH, learning_rate=1e-3,
            device_cache=True, hbm_budget_bytes=budget, device_dtype=dd)
  torch.cuda.synchronize()
  return (model, dict(tz.launches), time.perf_counter() - t0,
          torch.cuda.max_memory_allocated() - base)


def phase_out_of_core(torch, x, smi):
  """Phase 14b/c: SCVI out of core at 33,000 genes. Returns (the 65,536-cell
  CSR, the trained float32 model, the ZINB launches)."""
  import numpy as np
  import scipy.sparse as sp
  from sisua_tpu_torch.data import DataFeeder
  from sisua_tpu_torch.train import Trainer
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
  t0 = time.perf_counter()
  big = _host_csr(torch, (_counts(torch, gen, OOC_SLICE, GENES)
                          for _ in range(OOC_CELLS // OOC_SLICE)), GENES)
  dense_gb = OOC_CELLS * GENES * 4 / 1e9
  log(f"[14b out of core] {OOC_CELLS} × {GENES} counts made on the card in "
      f"{OOC_SLICE}-row slices → host CSR, {big.nnz:,} nonzeros "
      f"({big.nnz / (OOC_CELLS * GENES):.2%}; {dense_gb:.2f} GB dense f32) "
      f"in {time.perf_counter() - t0:.1f} s")
  trained = None
  for dd, plan_ref in OOC_PLANS.items():
    # the model's own footprint (parameters, optimizer state, the best
    # state's snapshot, a step's activations): a resident fit of the same
    # model and device_dtype on 1,024 of the cells for two epochs (the
    # second runs beside a snapshot), less their resident bytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    itemsize = 4 if dd == "float32" else 2
    _, _, _, footprint = _ooc_fit(torch, big[:2 * BATCH], dd, None, 2,
                                  base + 2 * BATCH * GENES * itemsize)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    model, launches, fit_s, peak = _ooc_fit(torch, big, dd, OOC_BUDGET,
                                            OOC_EPOCHS, base)
    reserved = torch.cuda.max_memory_reserved() - reserved
    for k in total:
      total[k] += launches[k]
    plan = model.trainer._oc_plan
    check({k: plan[k] for k in plan_ref} == plan_ref
          and plan["sparse_sources"] == [True],
          f"{dd}: plan {plan} != {plan_ref}, all sparse")
    R, S, K = plan["chunk_rows"], plan["n_chunks"], plan["n_resident"]
    steps_epoch = S * (R // BATCH)
    h = model.history
    losses = np.asarray(h["loss"])
    check(len(losses) == OOC_EPOCHS and np.isfinite(losses).all()
          and losses[-1] < losses[0], f"{dd}: losses {losses}")
    check(model.step == OOC_EPOCHS * steps_epoch
          and launches == {"zinb_rowsum_fwd": model.step,
                           "zinb_rowsum_bwd": model.step},
          f"{dd}: {model.step} steps, launches {launches}")
    check(peak <= OOC_BUDGET + footprint,
          f"{dd}: peak {peak / 2**30:.3f} GiB > budget "
          f"{OOC_BUDGET / 2**30:.3f} + footprint {footprint / 2**30:.3f}")
    waits = model.trainer._oc_wait_s
    log(f"[14b out of core] device_dtype={dd}: plan {R} rows × {S} chunks, "
        f"{K} resident, {S - K} streamed (sparse upload) each epoch, as "
        f"expected; {model.step} steps in {fit_s:.1f} s; losses "
        f"{[round(float(v), 2) for v in losses]}; steady "
        f"{h['epoch_time'][-1] / steps_epoch * 1e3:.3f} ms a step, "
        f"{h['cells_per_sec'][-1]:.0f} cells/s (last epoch; epochs "
        f"{', '.join(f'{t:.2f}' for t in h['epoch_time'])} s); waited for "
        f"streamed chunks {', '.join(f'{w:.3f}' for w in waits)} s an epoch; "
        f"peak {peak / 2**30:.3f} GiB ≤ budget {OOC_BUDGET / 2**30:.0f} + "
        f"footprint {footprint / 2**30:.3f} GiB (a resident fit of the model "
        f"on {2 * BATCH} cells, data excluded; the allocator's reserve grew "
        f"{reserved / 2**30:.3f} GiB); launches {launches}")
    if dd == "float32":
      trained = model
    del model
    torch.cuda.empty_cache()
  atlas = DataFeeder([sp.csr_matrix((ATLAS_CELLS, GENES), dtype=np.float32)],
                     batch_size=BATCH)
  tr = Trainer(device_cache=True, device=torch.device(DEVICE))
  log(f"[14b out of core] scale cut: {OOC_CELLS} cells trained; "
      f"{ATLAS_CELLS:,} × {GENES} f32 ({ATLAS_CELLS * GENES * 4 / 1e9:.0f} GB "
      f"dense) under the card's default budget "
      f"({tr._device_budget() / 1e9:.1f} GB) would plan "
      f"{tr._plan_out_of_core(atlas)} (not trained)")
  # 14c: dense host rows and their CSR, the same seed: the same losses
  xh = x.cpu().numpy()
  hists, plans = {}, {}
  for kind, data in (("dense", xh), ("csr", _host_csr(torch, [x], GENES))):
    base = torch.cuda.memory_allocated()
    model, launches, _, _ = _ooc_fit(torch, data, "float32", SPARSE_BUDGET,
                                     SPARSE_EPOCHS, base)
    for k in total:
      total[k] += launches[k]
    hists[kind] = np.asarray(model.history["loss"])
    plans[kind] = model.trainer._oc_plan
    del model
  check(plans["dense"]["sparse_sources"] == [False]
        and plans["csr"]["sparse_sources"] == [True],
        f"sparse = dense: plans {plans}")
  check(np.allclose(hists["csr"], hists["dense"], rtol=1e-6, atol=0),
        f"sparse upload {hists['csr']} vs dense {hists['dense']}")
  del xh
  same = np.array_equal(hists["csr"], hists["dense"])
  log(f"[14c sparse = dense] {CELLS} × {GENES} out of core at "
      f"{SPARSE_BUDGET / 2**30:.0f} GiB (plan {plans['csr']}): CSR losses "
      f"{hists['csr'].tolist()} vs dense {hists['dense'].tolist()} "
      f"({'bitwise equal' if same else 'within rtol 1e-6'})")
  return big, trained, total


def _union_us(ranges) -> float:
  """Length of the union of time intervals, µs (tools/step_profile.py)."""
  total, end = 0.0, None
  for r in sorted(ranges, key=lambda r: r.start):
    if end is None or r.start > end:
      total += r.end - r.start
      end = r.end
    elif r.end > end:
      total += r.end - end
      end = r.end
  return total


def phase_streaming(torch, big, held, smi):
  """Phase 14d: the default ``fit`` (streaming) on the 65,536-cell CSR,
  validated every STREAM_VALID_FREQ steps on the held-out cells; float32
  and int16 transfers; the device's idle share over PROFILE_STEPS
  streamed steps under ``torch.profiler``. Returns the ZINB launches."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from sisua_tpu_torch.ops import zinb as tz
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  held_csr = _host_csr(torch, [held], GENES)
  steps = OOC_CELLS // BATCH
  n_val = max(1, steps // STREAM_VALID_FREQ)  # else once at the epoch's end
  ms = {}
  for td in (None, "int16"):
    model = _scvi(torch, "full")
    tz.reset_launches()
    model.fit(big, valid=held_csr, epochs=1, batch_size=BATCH,
              learning_rate=1e-3, valid_freq=STREAM_VALID_FREQ,
              transfer_dtype=td)
    torch.cuda.synchronize()
    for k in total:
      total[k] += tz.launches[k]
    h = model.history
    val_batches = -(-HELD_OUT // BATCH)
    check(model.step == steps and np.isfinite(h["loss"]).all()
          and np.isfinite(h["val_loss"]).all(),
          f"streaming {td}: {model.step} steps, {h['loss']}")
    check(tz.launches == {"zinb_rowsum_fwd": steps + n_val * val_batches,
                          "zinb_rowsum_bwd": steps},
          f"streaming {td}: launches {tz.launches}")
    ms[td] = h["epoch_time"][0] / steps * 1e3
    log(f"[14d streaming] transfer_dtype={td}: {steps} steps in "
        f"{h['epoch_time'][0]:.2f} s, {ms[td]:.3f} ms a step, "
        f"{h['cells_per_sec'][0]:.0f} cells/s, validated {n_val}× on "
        f"{HELD_OUT} held-out cells (val_loss {h['val_loss'][0]:.2f}); "
        f"launches {dict(tz.launches)}")
    del model
  model = _scvi(torch, "full")
  tz.reset_launches()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as prof:
    model.fit(big, epochs=1, batch_size=BATCH, max_iter=PROFILE_STEPS)
    torch.cuda.synchronize()
  for k in total:
    total[k] += tz.launches[k]
  dev = [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA]
  ops = [e for e in dev if not (e.is_user_annotation or "#" in e.name)]
  busy = _union_us([e.time_range for e in ops]) / 1e3 / PROFILE_STEPS
  copies = sum(e.time_range.elapsed_us() for e in ops
               if "Memcpy" in e.name) / 1e3 / PROFILE_STEPS
  log(f"[14d streaming] device busy {busy:.3f} ms a step over "
      f"{PROFILE_STEPS} streamed steps (host→device copies {copies:.3f} ms "
      f"of it), idle {1 - busy / ms[None]:.1%} of the unprofiled "
      f"{ms[None]:.3f} ms step; {len(ops) / PROFILE_STEPS:.0f} device "
      f"operations a step")
  del model
  return total


def phase_sparse_serving(torch, model, held):
  """Phase 14e: ``predict_mean`` of the held-out cells as CSR (triplets
  uploaded, densified on the card) equals the dense call bitwise under the
  same generator state."""
  import numpy as np
  from sisua_tpu_torch.models import base
  held_np = held.cpu().numpy()
  held_csr = _host_csr(torch, [held], GENES)
  calls = []
  real = base.csr_row_triplets
  base.csr_row_triplets = lambda *a, **k: calls.append(1) or real(*a, **k)
  try:
    state = model.generator.get_state()
    xd, zd = model.predict_mean(held_np, batch_size=BATCH, input_dtype=None)
    model.generator.set_state(state)
    xs, zs = model.predict_mean(held_csr, batch_size=BATCH,
                                input_dtype=None)
  finally:
    base.csr_row_triplets = real
  check(calls and np.array_equal(xs[0], xd[0])
        and np.array_equal(zs[0], zd[0]),
        "sparse serving differs from dense serving")
  log(f"[14e sparse serving] predict_mean of {HELD_OUT} held-out cells: "
      f"CSR (triplets, {held_csr.nnz:,} nonzeros) bitwise equal to dense")


FLEET = 4                # members of phase 15's ensembles
FLEET_EPOCHS = 4
FLEET_WINDOW = 2         # metrics_interval of the fleet's fit
FLEET_LR, FLEET_CLIP = 1e-3, 100.0
HYPER_LRS = (1e-4, 3e-4, 1e-3, 3e-3)  # fit_hyper_vmap's defaults
HYPER_EPOCHS = 2
SCAN_K = 4
# phase-15a cases: name, x shared by the members, per-gene θ, bf16 operands
MEMBER_CASES = (
    ("fleet_full_shared", True, False, False),
    ("fleet_full_member", False, False, False),
    ("fleet_gene_shared", True, True, False),
    ("fleet_full_shared_bf16", True, False, True),
)


def _member_case(torch, gen, x_shared, per_gene, bf16):
  """FLEET members' operands at 512 × 33,000: x (1 or FLEET, B, D), θ
  per element as log θ ('full') or per gene as θ ('single'), logits and
  gate per element, the row cotangents (FLEET, B)."""
  m = FLEET
  x = torch.stack([_counts(torch, gen, BATCH, GENES)
                   for _ in range(1 if x_shared else m)])
  rows = 1 if per_gene else BATCH
  cr = torch.randn((m, rows, GENES), generator=gen, device=DEVICE)
  if per_gene:
    cr = torch.exp(0.5 + 0.7 * cr)
  lg = torch.randn((m, BATCH, GENES), generator=gen, device=DEVICE) - 2.0
  gt = torch.randn((m, BATCH, GENES), generator=gen, device=DEVICE) - 1.0
  if bf16:
    lg, gt = lg.to(torch.bfloat16), gt.to(torch.bfloat16)
    if not per_gene:
      cr = cr.to(torch.bfloat16)
  g = torch.randn((m, BATCH), generator=gen, device=DEVICE)
  return x, cr, lg, gt, g, per_gene


def member_bounds(x, cr, lg, gt, need):
  """``kernel_bounds`` for a member-batched call: every operand's bytes
  read once (a shared x once for all members), each member's outputs
  written once, and the operations of every member's elements."""
  from sisua_tpu_torch.ops import zinb as tz
  m, b, d = lg.shape
  reads = sum(t.numel() * t.element_size() for t in (x, cr, lg, gt))
  full = tz._write_dtype((cr, lg, gt)).itemsize
  written = {"fwd": 4 * m * b, "bwd": sum(
      p.numel() * (4 if p.shape[1] == 1 else full)
      for p, n in zip((cr, lg, gt), need) if n)}
  read = {"fwd": reads, "bwd": reads + 4 * m * b}
  nz = int((x > 0).sum()) * (m // x.shape[0])
  out = {}
  for k, (ops_zero, ops_count) in OPS.items():
    t_bytes = (read[k] + written[k]) / HBM_BYTES_PER_S * 1e6
    t_ops = ((m * b * d - nz) * ops_zero + nz * ops_count) \
        / F32_OPS_PER_S * 1e6
    out[k] = ((t_bytes, "bytes") if t_bytes >= t_ops
              else (t_ops, "operations"))
  return out


def _check_members(torch, tz, name, x, cr, lg, gt, g, constrained):
  """One member-batched case against the plain versions over the member
  axis (phase 3's tolerances, a bf16-written field within 1 bf16 ulp),
  run twice for the same bits. Returns (forward, gradient) max|Δ|."""
  import numpy as np
  m, need = FLEET, (True, True, True)
  out = tz._fwd_launch(x, cr, lg, gt, constrained, members=m)
  grads = tz._bwd_launch(x, cr, lg, gt, g, constrained, need, members=m)
  torch.cuda.synchronize()
  xm = x.expand(m, -1, -1)
  o = out.cpu().numpy()
  r = tz._rowsum_ref(xm, cr, lg, gt, constrained).cpu().numpy()
  check(out.shape == (m, BATCH) and np.isfinite(o).all(),
        f"{name}: forward {tuple(out.shape)} not finite")
  np.testing.assert_allclose(o, r, rtol=FWD_RTOL, err_msg=f"{name}: fwd")
  params = (cr, lg, gt)
  refs = tz._grads_ref(xm, cr, lg, gt, g, constrained, need)
  terms = tz._zinb_grads_elem(xm, *(tz._widen(p) for p in params),
                              constrained)
  bf16_full = tz._write_dtype(params) == torch.bfloat16
  bwd_err = 0.0
  for field, a, b, t, p in zip(("theta", "logits", "gate"), grads, refs,
                               terms, params):
    check(a.shape == b.shape == p.shape and a.dtype == p.dtype,
          f"{name}: {field} {tuple(a.shape)} {a.dtype}")
    atol, rtol = GRAD_TOL["atol"], GRAD_TOL["rtol"]
    if p.shape[1] == 1:  # per-gene: a sum over each member's rows
      atol = atol + SUM_ULPS * (g[..., None] * t).abs().sum(
          1, keepdim=True).cpu().numpy()
    elif bf16_full:
      check(torch.equal(a, a.to(torch.bfloat16).to(a.dtype)),
            f"{name}: {field} written wider than bf16")
      rtol = BF16_GRAD_RTOL
    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
    bad = ~(np.abs(a - b) <= atol + rtol * np.abs(b))
    check(not bad.any(), f"{name}: d{field} {bad.sum()} of {bad.size} off")
    bwd_err = max(bwd_err, float(np.abs(a - b).max()))
  del refs, terms
  check(torch.equal(out, tz._fwd_launch(x, cr, lg, gt, constrained,
                                        members=m)),
        f"{name}: forward not bitwise reproducible")
  twice = tz._bwd_launch(x, cr, lg, gt, g, constrained, need, members=m)
  check(all(torch.equal(u, v) for u, v in zip(grads, twice)),
        f"{name}: backward not bitwise reproducible")
  # one member in the member-batched launch: the (B, D) launch's bits
  one = [t[:1] for t in (x, cr, lg, gt, g)]
  check(torch.equal(tz._fwd_launch(*one[:4], constrained, members=1)[0],
                    tz._fwd_launch(*(t[0] for t in one[:4]), constrained)),
        f"{name}: M = 1 forward differs from the (B, D) launch")
  got = tz._bwd_launch(*one, constrained, need, members=1)
  ref1 = tz._bwd_launch(*(t[0] for t in one), constrained, need)
  check(all(torch.equal(u[0], v) for u, v in zip(got, ref1)),
        f"{name}: M = 1 backward differs from the (B, D) launch")
  return float(np.abs(o - r).max()), bwd_err


def phase_member_kernels(torch):
  """Phase 15a: both kernels with FLEET members in one launch, against
  their plain versions; µs per call beside the bound."""
  from sisua_tpu_torch.ops import zinb as tz
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
  results = {}
  for name, x_shared, per_gene, bf16 in MEMBER_CASES:
    x, cr, lg, gt, g, constrained = _member_case(torch, gen, x_shared,
                                                 per_gene, bf16)
    need = (True, True, True)
    fwd_err, bwd_err = _check_members(torch, tz, name, x, cr, lg, gt, g,
                                      constrained)
    xm = x.expand(FLEET, -1, -1)
    t_fwd = _time_turns(torch, {
        "plain": lambda: tz._rowsum_ref(xm, cr, lg, gt, constrained),
        "kernel": lambda: tz._fwd_launch(x, cr, lg, gt, constrained,
                                         members=FLEET)}, reps=5, rounds=2)
    t_bwd = _time_turns(torch, {
        "plain": lambda: tz._grads_ref(xm, cr, lg, gt, g, constrained,
                                       need),
        "kernel": lambda: tz._bwd_launch(x, cr, lg, gt, g, constrained,
                                         need, members=FLEET)},
        reps=5, rounds=2)
    bounds = member_bounds(x, cr, lg, gt, need)
    results[name] = dict(fwd_err=fwd_err, bwd_err=bwd_err, t_fwd=t_fwd,
                         t_bwd=t_bwd, bounds=bounds)
    log(f"[15a members] {name} {FLEET} × {BATCH} × {GENES} x "
        f"{'shared' if x_shared else 'per member'} θ "
        f"{'per gene' if per_gene else '(B, D)'}"
        f"{' bf16 operands' if bf16 else ''}: fwd max|Δ| {fwd_err:.3e} "
        f"kernel {t_fwd['kernel']:.1f} µs plain {t_fwd['plain']:.1f} µs "
        f"bound {bounds['fwd'][0]:.1f} µs ({bounds['fwd'][1]}) share "
        f"{bounds['fwd'][0] / t_fwd['kernel']:.1%} | bwd max|Δ| "
        f"{bwd_err:.3e} kernel {t_bwd['kernel']:.1f} µs plain "
        f"{t_bwd['plain']:.1f} µs bound {bounds['bwd'][0]:.1f} µs "
        f"({bounds['bwd'][1]}) share "
        f"{bounds['bwd'][0] / t_bwd['kernel']:.1%}; bitwise reproducible; "
        f"M = 1 bitwise equal to the (B, D) launch")
    del x, cr, lg, gt, g, xm
  torch.cuda.empty_cache()
  return results


# A ReLU whose input lies within rounding of 0 can take the other side in a
# fleet step than in its single step (their rounding differs by ~1e-7
# there) and move its row's share of a gradient. The single step takes the
# fleet's side of such a unit (its input set to the fleet's value, its
# gradient path kept), so the bounds hold as they are; a unit whose two
# inputs differ by more than KINK_BAND is a real difference and fails.
KINK_BAND = 1e-5


@contextlib.contextmanager
def _relu_hooks(module, hook):
  """``hook(output)`` on the layer that feeds each ReLU of ``module``'s
  MLPs (its Dense, Conv or BatchNorm), in forward order, while the
  context is open; a tensor it returns replaces the output."""
  from sisua_tpu_torch.nn import MLP
  handles = []
  for mlp in module.modules():
    if isinstance(mlp, MLP) and mlp.conf.activation == "relu":
      kind = "bn" if mlp.conf.batchnorm else (
          "conv" if mlp.conf.use_conv else "dense")
      for j in range(len(mlp.conf.units)):
        handles.append(getattr(mlp, f"{kind}{j}").register_forward_hook(
            lambda mod, inp, out: hook(out)))
  try:
    yield
  finally:
    for h in handles:
      h.remove()


@contextlib.contextmanager
def _fleet_relu_inputs(model):
  """The fleet step's ReLU inputs: while open, the template ``model``'s
  loss returns beside its metrics the input of every ReLU of its forward
  (``relu<j>`` in forward order), which the vmapped step hands back with
  the member axis first."""
  base = type(model)._loss

  def loss(batch, training, beta, **kw):
    seen = []
    with _relu_hooks(model.module, lambda out: seen.append(out.detach())):
      value, metrics, rest = base(model, batch, training, beta, **kw)
    return value, dict(metrics, **{f"relu{j}": v for j, v in
                                   enumerate(seen)}), rest
  model._loss = loss
  try:
    yield
  finally:
    del model._loss


@contextlib.contextmanager
def _fleet_sides(torch, module, fleet):
  """A single step's forward of ``module`` takes the fleet's side of every
  ReLU whose input lies on the other side of 0 in ``fleet`` (that
  member's ReLU inputs in forward order): the input becomes the fleet's
  value, its gradient kept. Yields [(units switched, max|Δ| of their
  inputs)] per ReLU layer."""
  inputs, seen = iter(fleet), []

  def align(out):
    f = next(inputs)
    flip = (f > 0) != (out > 0)
    gap = (f - out.detach()).abs()[flip]
    seen.append((gap.numel(), float(gap.max()) if gap.numel() else 0.0))
    return out + torch.where(flip, f - out, torch.zeros_like(out)).detach()
  with _relu_hooks(module, align):
    yield seen


def _fleet_against_singles(torch, label, name, ens, batch, heads=1,
                           vanishing_floor=None):
  """One fleet step of ``ens`` against FLEET single-model steps (each its
  own ClippedAdam) on ``batch`` with the same noise, dropout masks,
  Gumbel draws, δ pairs and permutations: loss and metrics rtol
  ROUTE_LOSS_RTOL; every gradient's max|Δ| within ROUTE_GRAD_BOUND of its
  max|g| + 1e-3·G, each single step on the fleet's side of every ReLU
  (``_fleet_sides``); parameters after the step within 2·lr (Adam's
  first step moves an element by at most lr, and by ±lr wherever the
  gradient is rounding noise: the biases ahead of a BatchNorm). With
  ``vanishing_floor`` those biases are held to max|g| ≤ vanishing_floor·G
  on both sides instead, as in ``_compare_routes``. For FactorVAE the
  discriminator step too, each member's from the fleet's updated state:
  its loss rtol ROUTE_LOSS_RTOL, its parameters within 2·lr of the
  fleet's. ``heads`` launches of each kernel for the step. Returns the
  step's launches."""
  import numpy as np
  from sisua_tpu_torch.nn import DropoutMasks
  from sisua_tpu_torch.ops import zinb as tz
  from sisua_tpu_torch.train import ClippedAdam
  ens._stacked = ens._stack_states()
  plan = ens._draw_plan(batch)
  step_fn = ens._make_step(True, True, plan)
  aux_fn = ens._make_aux_step(True, True, plan)
  noise, masks = ens._draws(plan)
  aux_draws = None if aux_fn is None else ens._aux_draws(plan)
  tz.reset_launches()
  with _fleet_relu_inputs(ens.model):
    loss, metrics, grads = ens._train_step(
        step_fn, batch, noise, masks, FLEET_LR, FLEET_CLIP,
        None if aux_fn is None else (aux_fn, aux_draws))
  torch.cuda.synchronize()
  launches = dict(tz.launches)
  check(launches == {"zinb_rowsum_fwd": heads, "zinb_rowsum_bwd": heads},
        f"{name} fleet step launches {launches}, expected {heads} each")
  relu = [metrics.pop(f"relu{j}") for j in range(
      sum(1 for k in list(metrics) if k.startswith("relu")))]
  st = ens._stacked
  vanishing = (set() if vanishing_floor is None
               else _batchnormed_biases(ens.model.module))
  worst_loss = worst_metric = worst_p = noise_max = kink_gap = 0.0
  ratios, keys, switched, off, total = [], [], [], 0, 0
  for i, m in enumerate(ens.models):
    m.optimizer = ClippedAdam(m.module.parameters(), FLEET_LR, FLEET_CLIP)
    with _fleet_sides(torch, m.module, [v[i] for v in relu]) as sides:
      li, mi, _ = m._loss(batch, True, m.beta(m.step),
                          noise=ens._member_draws(noise, i),
                          masks=DropoutMasks([k[i] for k in masks]))
    check(len(sides) == len(relu),
          f"{name}: {len(sides)} ReLU layers in a single step's forward, "
          f"{len(relu)} in the fleet's")
    switched.append(sum(n for n, _ in sides))
    kink_gap = max([kink_gap] + [d for _, d in sides])
    m.module.zero_grad(set_to_none=True)
    li.backward()
    gi = {k: p.grad.detach().clone() for k, p in m.module.named_parameters()}
    m.optimizer.step()
    li = float(li.detach())
    worst_loss = max(worst_loss, abs(float(loss[i]) - li) / abs(li))
    for k, v in mi.items():
      v = float(v.detach())
      worst_metric = max(worst_metric, abs(float(metrics[k][i]) - v)
                         / max(abs(v), 1e-6))
    scale = max(float(g.abs().max()) for g in gi.values())
    ratio, key = 0.0, None
    for k, g in gi.items():
      if k in vanishing:
        noise_max = max(noise_max, float(g.abs().max()) / scale,
                        float(grads[k][i].abs().max()) / scale)
        continue
      r = float((grads[k][i] - g).abs().max()) / (
          float(g.abs().max()) + 1e-3 * scale)
      if r >= ratio:
        ratio, key = r, k
    ratios.append(ratio)
    keys.append(key)
    for k, p in m.module.named_parameters():
      d = (st["params"][k][i] - p.detach()).abs()
      worst_p = max(worst_p, float(d.max()))
      off += int((d > 1e-2 * FLEET_LR).sum())
      total += d.numel()
  worst = int(np.argmax(ratios))
  check(worst_loss <= ROUTE_LOSS_RTOL and worst_metric <= ROUTE_LOSS_RTOL,
        f"{name} fleet loss off by {worst_loss}, a metric by {worst_metric}")
  check(kink_gap <= KINK_BAND,
        f"{name}: a ReLU input on the other side of 0 in the fleet differs "
        f"by {kink_gap:.2e} > {KINK_BAND}")
  check(ratios[worst] <= ROUTE_GRAD_BOUND,
        f"{name} fleet gradient {keys[worst]} of member {worst} off by "
        f"{ratios[worst]:.2e} of max|g| + 1e-3·G (by member "
        f"{[f'{r:.2e}' for r in ratios]}; ReLUs switched {switched})")
  check(noise_max <= (vanishing_floor or 0.0),
        f"{name}: a bias ahead of a BatchNorm has gradient {noise_max:.2e}·G")
  check(worst_p <= 2 * FLEET_LR * (1 + 1e-6),
        f"{name} fleet parameter off by {worst_p:.3e} > 2·lr")
  disc = ""
  if aux_fn is not None:
    worst_d = worst_a = 0.0
    lr = ens._aux_adam[0]
    for i, m in enumerate(ens.models):
      with torch.no_grad():
        for k, p in m.module.named_parameters():
          p.copy_(st["params"][k][i])
        for k, b in m.module.named_buffers():
          b.copy_(st["buffers"][k][i])
      m.aux_optimizer = m._make_aux_optimizer()
      d = ens._member_draws(aux_draws, i)
      di = float(m._aux_step(batch, {}, noise=d[:-1],
                             perms=d[-1])["disc_loss"])
      worst_d = max(worst_d, abs(float(metrics["disc_loss"][i]) - di)
                    / abs(di))
      for k, p in m.aux.named_parameters():
        worst_a = max(worst_a, float((st["aux"]["params"][k][i]
                                      - p.detach()).abs().max()))
    check(worst_d <= ROUTE_LOSS_RTOL and worst_a <= 2 * lr * (1 + 1e-6),
          f"{name} discriminator step: disc_loss off by {worst_d}, "
          f"parameters by {worst_a:.3e}")
    disc = (f"; the discriminator step from the fleet's state: disc_loss "
            f"rel {worst_d:.2e}, parameters max|Δ| {worst_a / lr:.3f}·lr")
  floor = ("" if vanishing_floor is None else
           f"; the {len(vanishing)} biases ahead of a BatchNorm max|g| "
           f"{noise_max:.2e}·G (bound {vanishing_floor:.2e})")
  log(f"[{label}] {name}: one fleet step vs {FLEET} single steps "
      f"({len(plan.noise)} noise entries, {len(plan.masks)} dropout masks"
      f"{'' if plan.aux is None else f', {len(plan.aux)} discriminator draws'}"
      f"; {heads} launch(es) of each kernel for the fleet): loss rel "
      f"{worst_loss:.2e}, metrics rel {worst_metric:.2e} (bound "
      f"{ROUTE_LOSS_RTOL}); gradient max|Δ|/(max|g|+1e-3·G) by member "
      f"{[f'{r:.2e}' for r in ratios]} (bound {ROUTE_GRAD_BOUND}), the "
      f"largest at {keys[worst]}; ReLU units on the other side of 0 in the "
      f"fleet, by member {switched} over {len(relu)} ReLU layers (their "
      f"inputs within {kink_gap:.2e}; the single step takes the fleet's "
      f"side){floor}; parameters max|Δ| {worst_p / FLEET_LR:.3f}·lr (bound "
      f"2·lr), {off} of {total} beyond 1e-2·lr{disc}")
  del grads, relu
  return launches


def phase_fleet(torch, x, held, library, smi):
  """Phase 15b–d: VmapEnsemble and fit_hyper_vmap at 33,000 genes on
  phase 4's counts. Returns the main path's ZINB launches."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from sisua_tpu_torch.models.hyper_params import fit_hyper_vmap
  from sisua_tpu_torch.ops import zinb as tz
  from sisua_tpu_torch.train import VmapEnsemble
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  steps_epoch = CELLS // BATCH
  make = lambda s: _scvi(torch, "full", seed=SEED + s)  # noqa: E731
  _fleet_against_singles(torch, "15b fleet", "SCVI", VmapEnsemble(
      make, n_models=FLEET), {"inputs": [x[:BATCH]],
                              "mask": torch.ones(BATCH, device=DEVICE),
                              "library": library[:BATCH]})
  torch.cuda.empty_cache()
  ens = VmapEnsemble(make, n_models=FLEET)
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  ens.fit(x, epochs=FLEET_EPOCHS, batch_size=BATCH, learning_rate=FLEET_LR,
          clipnorm=FLEET_CLIP, metrics_interval=FLEET_WINDOW)
  torch.cuda.synchronize()
  fit_s = time.perf_counter() - t0
  steps = FLEET_EPOCHS * steps_epoch
  check(tz.launches == {"zinb_rowsum_fwd": steps, "zinb_rowsum_bwd": steps},
        f"fleet launches {tz.launches} != {steps} fleet steps")
  for k in total:
    total[k] += tz.launches[k]
  loss = ens.history["loss"]
  check(loss.shape == (FLEET_EPOCHS, FLEET) and np.isfinite(loss).all()
        and (loss[-1] < loss[0]).all(), f"fleet losses {loss}")
  check(len(np.unique(loss[-1])) == FLEET, f"members alike: {loss[-1]}")
  epoch_s = float(np.median(ens.history["epoch_time"][-FLEET_WINDOW:]))
  step_ms = epoch_s / steps_epoch * 1e3
  peak = torch.cuda.max_memory_allocated() / 2**30
  tz.reset_launches()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as prof:
    ens.fit(x, epochs=1, batch_size=BATCH, learning_rate=FLEET_LR,
            clipnorm=FLEET_CLIP)
    torch.cuda.synchronize()
  for k in total:
    total[k] += tz.launches[k]
  ops = _device_ops(torch, prof)
  busy = _union_us([e.time_range for e in ops]) / 1e3 / steps_epoch
  log(f"[15b fleet] VmapEnsemble of {FLEET} SCVI ('zinbd', full "
      f"dispersion, phase 4's nets) on {CELLS} × {GENES}, batch {BATCH}, "
      f"shared batches, {FLEET_EPOCHS} epochs in windows of "
      f"{FLEET_WINDOW}: {steps} fleet steps in {fit_s:.1f} s; losses first "
      f"epoch {[round(float(v), 2) for v in loss[0]]} last "
      f"{[round(float(v), 2) for v in loss[-1]]}; steady {step_ms:.3f} ms a "
      f"fleet "
      f"step ({PHASE4.get('step_ms', float('nan')):.3f} ms a single-model "
      f"step in phase 4), {FLEET * CELLS / epoch_s:.0f} cells/s summed over "
      f"members; device busy {busy:.3f} ms a step, idle "
      f"{1 - busy / step_ms:.1%} (one profiled epoch, "
      f"{len(ops) / steps_epoch:.0f} device operations a step); peak "
      f"memory {peak:.2f} GiB; launches {steps} each, once per fleet step")
  # 15c: one window with each member's own batches
  tz.reset_launches()
  ens.fit(x, epochs=FLEET_WINDOW, batch_size=BATCH, learning_rate=FLEET_LR,
          clipnorm=FLEET_CLIP, shared_batches=False,
          metrics_interval=FLEET_WINDOW)
  torch.cuda.synchronize()
  n = FLEET_WINDOW * steps_epoch
  check(tz.launches == {"zinb_rowsum_fwd": n, "zinb_rowsum_bwd": n}
        and np.isfinite(ens.history["loss"]).all(),
        f"own batches: launches {tz.launches}, {ens.history['loss']}")
  for k in total:
    total[k] += tz.launches[k]
  log(f"[15c fleet] one window of {FLEET_WINDOW} epochs with "
      f"shared_batches=False: losses "
      f"{[round(float(v), 2) for v in ens.history['loss'][-1]]}, "
      f"{float(np.median(ens.history['epoch_time'])) / steps_epoch * 1e3:.3f}"
      f" ms a fleet step; launches {n} each")
  del ens
  torch.cuda.empty_cache()
  # 15d: the on-card hyper-parameter search
  tz.reset_launches()
  t0 = time.perf_counter()
  res = fit_hyper_vmap(lambda s: _scvi(torch, "full", seed=s), x,
                       learning_rates=HYPER_LRS, epochs=HYPER_EPOCHS,
                       batch_size=BATCH)
  torch.cuda.synchronize()
  hyper_s = time.perf_counter() - t0
  n = HYPER_EPOCHS * steps_epoch
  check(tz.launches == {"zinb_rowsum_fwd": n, "zinb_rowsum_bwd": n},
        f"fit_hyper_vmap launches {tz.launches}")
  for k in total:
    total[k] += tz.launches[k]
  check(len(res["trials"]) == len(HYPER_LRS)
        and all(np.isfinite(t["loss"]) for t in res["trials"]),
        f"trials {res['trials']}")
  best_i = int(np.argmin([t["loss"] for t in res["trials"]]))
  best = res["ensemble"].extract(best_i)
  t0 = time.perf_counter()
  xm, zm = best.predict_mean(held, batch_size=BATCH)
  serve_s = time.perf_counter() - t0
  check(xm[0].shape == (HELD_OUT, GENES) and np.isfinite(xm[0]).all()
        and np.isfinite(zm[0]).all(), "the best trial's predict_mean")
  trials = [(t["config"]["learning_rate"], round(t["loss"], 2))
            for t in res["trials"]]
  log(f"[15d hyper] fit_hyper_vmap over lr {HYPER_LRS}, {HYPER_EPOCHS} "
      f"epochs: {hyper_s:.1f} s; trials {trials}"
      f"; best {res['best']}; its predict_mean of {HELD_OUT} held-out cells "
      f"finite in {serve_s:.2f} s; launches {n} each")
  del res, best
  torch.cuda.empty_cache()
  return total


# phase 19: the rest of the zoo as fleets of FLEET members, each class at
# its phases 9–12 nets; SemiFVAE (no single-model phase) at FVAE's with
# SISUA's outputs
FLEET_ZOO = {"FVAE": 1, "SemiFVAE": 2, "SCALE": 1, "SCALAR": 2, "TotalVI": 1,
             "SCANVI": 1, "AUTOZI": 1, "MULTIVI": 1}  # ZINB/NB heads of each
# epochs and metrics window of each fleet: MULTIVI's loss spikes in its
# first epochs at this width (its single fits too) and falls from the
# first window of 8 to the second, as phase 11 checks it
FLEET_ZOO_EPOCHS = {"MULTIVI": (LONG_EPOCHS, LONG_WINDOW)}
FLEET_ZOO_SHORT = (2, 2)
# a gradient that vanishes but for rounding (a bias ahead of a BatchNorm),
# on the fleet and on the single step: max|g| below 2^-14 of the largest
FLEET_VANISHING_FLOOR = 2.0 ** -14
PROFILE_AUX_STEPS = 8    # the discriminator step alone under the profiler


def _fleet_zoo_model(name, seed):
  from sisua_tpu_torch import models as T
  if name == "SemiFVAE":
    return T.SemiFVAE(_sisua_outputs(), alpha=ALPHA, gamma=GAMMA,
                      device=DEVICE, seed=seed)
  if name in ZOO:
    return _zoo_model(name, seed)
  if name in PHASE10:
    return _phase10_model(name, seed)
  if name in MULTIOME:
    return _multiome_model(name, seed)
  return _phase12_model(name, seed=seed)


def _fleet_zoo_inputs(name, x, y, b, ct, a):
  """The data of a phase 19 fleet; MULTIVI's ``x`` and ``a`` are phase
  11's mosaic pair."""
  if name in ("SemiFVAE", "SCALAR"):
    return [x, y]
  if name in PHASE10:
    return _phase10_inputs(name, x, y, b, ct)
  if name in MULTIOME:
    return _multiome_inputs(name, x, a, b)
  return [x]


def _profile_fvae_fleet(torch, ens, data, library, labels, step_ms):
  """One profiled epoch of the FVAE fleet (device busy ms a step, its
  idle share of 19b's unprofiled ``step_ms``, device operations a step),
  then PROFILE_AUX_STEPS discriminator steps alone (what the batched
  step adds). Returns the launches."""
  from torch.profiler import ProfilerActivity, profile
  from sisua_tpu_torch.ops import zinb as tz
  steps_epoch = CELLS // BATCH
  tz.reset_launches()
  t0 = time.perf_counter()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as prof:
    ens.fit(data if len(data) > 1 else data[0], epochs=1, batch_size=BATCH,
            learning_rate=FLEET_LR, clipnorm=FLEET_CLIP,
            labels_percent=labels)
    torch.cuda.synchronize()
  wall = (time.perf_counter() - t0) / steps_epoch * 1e3
  launches = dict(tz.launches)
  check(launches == {"zinb_rowsum_fwd": steps_epoch,
                     "zinb_rowsum_bwd": steps_epoch},
        f"FVAE's profiled epoch launched {launches}")
  ops = _device_ops(torch, prof)
  busy = _union_us([e.time_range for e in ops]) / 1e3 / steps_epoch
  rows = torch.arange(BATCH, device=DEVICE)
  batch = {"inputs": [m[rows] for m in data], "library": library[rows],
           "mask": torch.ones(BATCH, device=DEVICE)}
  plan = ens._draw_plan(batch)
  aux_fn = ens._make_aux_step(True, True, plan)
  draws = [ens._aux_draws(plan) for _ in range(PROFILE_AUX_STEPS)]
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as prof:
    for d in draws:
      ens._aux_train_step(aux_fn, d, batch)
    torch.cuda.synchronize()
  aux_ops = _device_ops(torch, prof)
  aux_busy = _union_us([e.time_range for e in aux_ops]) / 1e3
  log(f"[19b fleet zoo] FVAE: one profiled epoch ({wall:.3f} ms a fleet "
      f"step under the profiler): device busy {busy:.3f} ms a step, idle "
      f"{1 - busy / step_ms:.1%} of 19b's {step_ms:.3f} ms, "
      f"{len(ops) / steps_epoch:.0f} device "
      f"operations a step; the batched discriminator step alone adds "
      f"{len(aux_ops) / PROFILE_AUX_STEPS:.0f} device operations and "
      f"{aux_busy / PROFILE_AUX_STEPS:.3f} ms of device time a step "
      f"(mean of {PROFILE_AUX_STEPS})")
  return launches


def _device_ops(torch, prof):
  """The device operations of a profile, without annotation spans."""
  return [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not (e.is_user_annotation or "#" in e.name)]


def _fleet_zoo_fit(torch, name, ens, data, labels, smi):
  """19b: the class's epochs and window (FLEET_ZOO_EPOCHS) from 19a's
  stacked state: finite losses, distinct across members, each member's
  mean over the last window below its mean over the first; one launch of
  each kernel per head and fleet step; the ms a fleet step (median of the
  last window), summed cells/s, peak memory. Returns the launches and the
  ms a fleet step."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  epochs, window = FLEET_ZOO_EPOCHS.get(name, FLEET_ZOO_SHORT)
  steps_epoch = CELLS // BATCH
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  ens.fit(data, epochs=epochs, batch_size=BATCH, learning_rate=FLEET_LR,
          clipnorm=FLEET_CLIP, labels_percent=labels, metrics_interval=window)
  torch.cuda.synchronize()
  fit_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  heads, steps = FLEET_ZOO[name], epochs * steps_epoch
  check(launches == {"zinb_rowsum_fwd": heads * steps,
                     "zinb_rowsum_bwd": heads * steps},
        f"{name} fleet launches {launches} != {heads} × {steps} fleet steps")
  loss = ens.history["loss"]
  half = epochs // 2
  first, last = loss[:half].mean(0), loss[-half:].mean(0)
  check(loss.shape == (epochs, FLEET) and np.isfinite(loss).all()
        and (last < first).all(), f"{name} fleet losses {loss}")
  check(len(np.unique(loss[-1])) == FLEET, f"{name} members alike: {loss}")
  epoch_s = float(np.median(ens.history["epoch_time"][-window:]))
  step_ms = epoch_s / steps_epoch * 1e3
  single = SINGLE_MS.get(name)
  per = ("no single-model phase" if single is None else
         f"{single:.3f} ms a single-model step in phases 9–12, "
         f"{step_ms / FLEET / single:.2f}× it per member")
  log(f"[19b fleet zoo] {name}: {FLEET} members, {epochs} epochs in "
      f"windows of {window}: {steps} fleet steps in {fit_s:.1f} s; mean "
      f"loss of the first {half} epoch(s) {[round(float(v), 2) for v in first]}"
      f" → of the last {half} {[round(float(v), 2) for v in last]}; "
      f"{step_ms:.3f} ms a fleet step (median of the last window; {per}); "
      f"{FLEET * CELLS / epoch_s:.0f} cells/s "
      f"summed over members; peak memory "
      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
      f"{launches} | {smi}")
  return launches, step_ms


def phase_fleet_zoo(torch, x, y, library, smi):
  """Phase 19: FVAE, SemiFVAE, SCALE, SCALAR, TotalVI, SCANVI, AUTOZI and
  MULTIVI as fleets at 33,000 genes (19a, 19b; FVAE's fleet profiled),
  then ``fit_hyper_vmap`` of AUTOZI (19c). Returns the launches, every one
  with the member axis."""
  import numpy as np
  from sisua_tpu_torch.models.autozi import _stacked_log_gamma_pairs
  from sisua_tpu_torch.models.hyper_params import fit_hyper_vmap
  from sisua_tpu_torch.ops import zinb as tz
  from sisua_tpu_torch.train import VmapEnsemble
  t_phase = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
  b, _ = _batch_onehots(  # phase 10's
      torch, torch.Generator(device=DEVICE).manual_seed(SEED + 14))
  ct = _onehots(torch, gen, CELLS, CELL_TYPES)
  t0 = time.perf_counter()
  a, xm = _atac(torch, gen, CELLS), x.clone()
  _mosaic(torch, gen, xm, a)  # phase 11's ATAC-only and RNA-only cells
  torch.cuda.synchronize()
  log(f"[19 fleet zoo] ATAC {tuple(a.shape)} on the card "
      f"({a.numel() * 4 / 1e9:.2f} GB f32) and a mosaic copy of the counts "
      f"in {time.perf_counter() - t0:.1f} s")
  total = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}

  def add(launches):
    for k in total:
      total[k] += launches[k]
  for name in FLEET_ZOO:
    t0 = time.perf_counter()
    data = _fleet_zoo_inputs(name, xm if name in MULTIOME else x, y, b, ct,
                             a)
    labels = {"TotalVI": TOTALVI_LABELS_PERCENT}.get(name, LABELS_PERCENT)
    ens = VmapEnsemble(lambda s: _fleet_zoo_model(name, SEED + s),
                       n_models=FLEET)
    rows = torch.arange(BATCH, device=DEVICE)
    add(_fleet_against_singles(
        torch, "19a fleet zoo", name, ens,
        {"inputs": [m[rows] for m in data], "library": library[rows],
         "mask": (torch.rand((BATCH,), generator=gen, device=DEVICE)
                  < 0.5).to(torch.float32)},
        FLEET_ZOO[name], FLEET_VANISHING_FLOOR))
    launches, step_ms = _fleet_zoo_fit(
        torch, name, ens, data if len(data) > 1 else data[0], labels, smi)
    add(launches)
    if name == "FVAE":
      add(_profile_fvae_fleet(torch, ens, data, library, labels, step_ms))
    del ens
    torch.cuda.empty_cache()
    log(f"[19 fleet zoo] {name}: {time.perf_counter() - t0:.1f} s")
  del a, xm
  torch.cuda.empty_cache()
  # 19c: the hyper-parameter search of AUTOZI; δ from each member's α, β
  t0 = time.perf_counter()
  tz.reset_launches()
  res = fit_hyper_vmap(lambda s: _phase12_model("AUTOZI", seed=s), x,
                       learning_rates=HYPER_LRS, epochs=1, batch_size=BATCH)
  torch.cuda.synchronize()
  hyper_s = time.perf_counter() - t0
  n = CELLS // BATCH
  check(tz.launches == {"zinb_rowsum_fwd": n, "zinb_rowsum_bwd": n},
        f"AUTOZI fit_hyper_vmap launches {tz.launches}")
  add(tz.launches)
  trials = [t["loss"] for t in res["trials"]]
  check(len(trials) == len(HYPER_LRS) and np.isfinite(trials).all()
        and len(set(trials)) == len(trials), f"AUTOZI trials {trials}")
  st = res["ensemble"]._stacked["params"]
  m = len(HYPER_LRS)
  sign = torch.tensor([5.0 if i % 2 == 0 else -5.0 for i in range(m)],
                      device=DEVICE)[:, None]
  la, lb = _stacked_log_gamma_pairs(m, gen, {
      "log_alpha_delta": torch.ones_like(st["log_alpha_delta"]) * sign,
      "log_beta_delta": -torch.ones_like(st["log_beta_delta"]) * sign})
  check(all(bool(((la[i] > lb[i]) if i % 2 == 0 else (la[i] < lb[i])).all())
            for i in range(m)),
        "δ's pairs do not follow each member's own α, β")
  log(f"[19c fleet zoo] fit_hyper_vmap of AUTOZI over lr {HYPER_LRS}, 1 "
      f"epoch: {hyper_s:.1f} s; trials "
      f"{[(t['config']['learning_rate'], round(t['loss'], 2)) for t in res['trials']]}"
      f"; δ's pairs drawn on the card for {m} members at ±5 log α, ∓5 log β "
      f"follow each member's own; launches {n} each")
  del res
  torch.cuda.empty_cache()
  log(f"[19 fleet zoo] phase 19 in {time.perf_counter() - t_phase:.1f} s")
  return total


def phase_scan_steps(torch, big):
  """Phase 15e: the streamed fit of phase 14d with ``scan_steps`` = 4 on
  all but one batch of the CSR cells (127 batches: 124 steps), against
  k = 1 stopped at the same step: the same batches and noise give the
  same loss (rtol ROUTE_LOSS_RTOL); ms a step of each."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  data = big[:OOC_CELLS - BATCH]
  batches = data.shape[0] // BATCH
  steps = SCAN_K * (batches // SCAN_K)
  runs = {}
  for k in (1, SCAN_K):
    model = _scvi(torch, "full")
    tz.reset_launches()
    model.fit(data, epochs=1, batch_size=BATCH, learning_rate=1e-3,
              scan_steps=k, max_iter=steps)
    torch.cuda.synchronize()
    check(model.step == steps and tz.launches == {
        "zinb_rowsum_fwd": steps, "zinb_rowsum_bwd": steps},
        f"scan_steps={k}: {model.step} steps, launches {tz.launches}")
    runs[k] = (float(model.history["loss"][0]),
               model.history["epoch_time"][0] / steps * 1e3,
               {n: p.detach().clone()
                for n, p in model.module.named_parameters()})
    del model
  (l1, ms1, p1), (lk, msk, pk) = runs[1], runs[SCAN_K]
  check(np.isfinite(lk) and abs(lk - l1) <= ROUTE_LOSS_RTOL * abs(l1),
        f"scan_steps loss {lk} vs {l1}")
  same = ("parameters bitwise equal"
          if all(torch.equal(p1[n], pk[n]) for n in p1)
          else f"rel {abs(lk - l1) / abs(l1):.2e}")
  log(f"[15e scan_steps] streamed SCVI on {data.shape[0]} CSR cells "
      f"({batches} batches): scan_steps={SCAN_K} runs {steps} steps (a "
      f"multiple of {SCAN_K}), loss {lk:.4f} vs k = 1 {l1:.4f} over the "
      f"same {steps} steps ({same}); {msk:.3f} ms a step at k = {SCAN_K}, "
      f"{ms1:.3f} at k = 1")
  return {"zinb_rowsum_fwd": 2 * steps, "zinb_rowsum_bwd": 2 * steps}


# phase 16: the analysis path on a fitted model
ANALYSIS_EPOCHS = 4
CB_BATCH = 256           # the callbacks' serving batch (the JAX default)
CB_DRAWS = 2             # their MC draws (sisua_tpu/analysis/sc_metrics.py)
DE_GROUPS = 4            # 4 × 2,048 cells
DE_PLANTED = 200         # genes scaled in each group's cells
DE_BASE = 0.5            # their rate outside the group
DE_FOLD = 4.0
DE_HITS = 150            # planted genes among a group's top 200 lfc_median
DE_SPEARMAN = 0.5        # tests/test_de.py:42
DE_CHECK_GENES = 4096    # columns held against the numpy statistics
MI_GENES = 2000
MI_CELLS = 4096
MI_CPU_GENES = 64
MI_ATOL = 1e-5           # nats
MI_BUDGET = 2 << 30      # knn_mutual_information's mem_budget_bytes default
PHASE6 = {}              # phase 6's steady SISUA step ms, beside phase 16a


def _marker_names():
  """33,000 gene names with the marker genes of the first 10 proteins of
  the marker table first, and those 10 protein names."""
  from sisua_tpu_torch.data import MARKER_ADT_GENE, MARKER_ADTS
  prots = MARKER_ADTS[:PROTEINS]
  genes = [MARKER_ADT_GENE[p] for p in prots]
  check(len(set(genes)) == PROTEINS, f"marker genes {genes}")
  return genes + [f"Gene{i:05d}" for i in range(PROTEINS, GENES)], prots


def _timed_callbacks(torch, cbs):
  """Each callback's ``on_epoch_end`` timed (synchronized) into
  ``seconds[name]``, and a recorder of the metric keys each epoch logs."""
  from sisua_tpu_torch.train import TrainingCallback
  seconds = {cb.name: [] for cb in cbs}
  for cb in cbs:
    def timed(epoch, logs, run=cb.on_epoch_end, name=cb.name):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      run(epoch, logs)
      torch.cuda.synchronize()
      seconds[name].append(time.perf_counter() - t0)
    cb.on_epoch_end = timed

  class Keys(TrainingCallback):
    def __init__(self):
      self.seen = []

    def on_epoch_end(self, epoch, logs):
      self.seen.append((epoch, sorted(k for k in logs if k.split("_")[0]
                                      in seconds)))
  return seconds, Keys()


def _nll_routes(torch, model, cb):
  """``nllk``/``nllk1`` of one pass over the callback's corrupted data,
  the kernel route (``mc_row_log_prob``: one member-axis forward launch
  per head per batch) and the plain route (the distribution math) on the
  same draws; rows the per-cell max relative difference."""
  import math
  import numpy as np
  from sisua_tpu_torch.analysis.sc_metrics import _rows
  from sisua_tpu_torch.models.objective import mc_row_log_prob
  from sisua_tpu_torch.ops import zinb as tz
  y_true = cb._targets(model.device)
  lse = lambda lp: torch.logsumexp(lp, 0) - math.log(lp.shape[0])  # noqa
  kern, plain = [[], []], [[], []]
  before = tz.launches["zinb_rowsum_fwd"]
  with torch.no_grad():
    for out, lo, nv in model._served_batches(cb._prepare(), (CB_DRAWS,),
                                             CB_BATCH):
      b = out.outputs[0].batch_shape[-1]
      for i, (dist, y) in enumerate(zip(out.outputs, y_true)):
        yb = _rows(y, lo, nv, b)
        kern[i].append(lse(mc_row_log_prob(dist, yb))[:nv])
        plain[i].append(lse(dist.log_prob(yb))[:nv])
  torch.cuda.synchronize()
  launched = tz.launches["zinb_rowsum_fwd"] - before
  res = []
  for k, p in zip(kern, plain):
    k, p = torch.cat(k).cpu().numpy(), torch.cat(p).cpu().numpy()
    res.append((-float(k.mean()), -float(p.mean()),
                float(np.max(np.abs(k - p) / np.abs(p)))))
  return res, launched


def phase_callbacks(torch, x, held, y, held_y):
  """Phase 16a: SISUA at phase 6's configuration for ANALYSIS_EPOCHS
  epochs with the three metric callbacks on the held-out cells. Returns
  the ZINB launches, the model and the ImputationError callback."""
  import numpy as np
  from sisua_tpu_torch.analysis import (CorrelationScores, ImputationError,
                                        NegativeLogLikelihood)
  from sisua_tpu_torch.models import SISUA
  from sisua_tpu_torch.ops import zinb as tz
  genes, prots = _marker_names()
  data = [held, held_y]
  nll = NegativeLogLikelihood(data=data, freq=1)
  imp = ImputationError(data=data, freq=1)
  corr = CorrelationScores(data=data, var_names=[genes, prots], freq=2)
  seconds, keys = _timed_callbacks(torch, [nll, imp, corr])
  model = SISUA(_sisua_outputs(), alpha=ALPHA, device=DEVICE, seed=SEED)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  model.fit([x, y], epochs=ANALYSIS_EPOCHS, batch_size=BATCH,
            learning_rate=1e-3, labels_percent=LABELS_PERCENT,
            metrics_interval=1, device_cache=True,
            callbacks=[nll, imp, corr, keys])
  torch.cuda.synchronize()
  fit_s = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated() / 2**30
  steps = ANALYSIS_EPOCHS * (CELLS // BATCH)
  served = ANALYSIS_EPOCHS * -(-HELD_OUT // CB_BATCH)  # NLL batches
  launches = dict(tz.launches)
  check(launches == {"zinb_rowsum_fwd": 2 * (steps + served),
                     "zinb_rowsum_bwd": 2 * steps},
        f"launches {launches}: expected 2 × ({steps} steps + {served} "
        f"served NLL batches, the draws as members) forward, 2 × {steps} "
        f"backward")
  want = {e: sorted(
      [f"NegativeLogLikelihood_{k}" for k in ("nllk", "nllk1")]
      + [f"ImputationError_{k}" for k in ("med", "mean")]
      + ([f"CorrelationScores_{k}" for k in ("pearson", "spearman")]
         if e % 2 == 0 else [])) for e in range(ANALYSIS_EPOCHS)}
  check(keys.seen == sorted(want.items()),
        f"metric keys by epoch {keys.seen}")
  h = model.history
  for k in {k for _, ks in keys.seen for k in ks}:
    check(np.isfinite(h[k]).all(), f"{k} {h[k]}")
  # the NLL's kernel route against the plain route on the same draws
  ((nk, npl, nrow), (ak, apl, arow)), routed = _nll_routes(torch, model,
                                                           nll)
  check(routed == 2 * -(-HELD_OUT // CB_BATCH),
        f"NLL kernel route: {routed} forward launches")
  check(abs(nk - npl) <= NLL_RTOL * abs(npl)
        and abs(ak - apl) <= NLL_RTOL * abs(apl),
        f"nllk kernel {nk} plain {npl}; nllk1 kernel {ak} plain {apl}")
  # med/mean from the fetched imputed mean, recomputed with numpy
  org = held.cpu().numpy()
  cor = imp._prepare()[0]
  t1 = time.perf_counter()
  med = float(np.median(np.abs(org - imp.imputed)))
  mask = (org != cor).any(axis=1)
  mean = float(np.mean(np.median(np.abs(org[mask] - imp.imputed[mask]),
                                 axis=1)))
  host_s = time.perf_counter() - t1
  card_med, card_mean = h["ImputationError_med"][-1], \
      h["ImputationError_mean"][-1]
  check(card_med == med and abs(card_mean - mean) <= 1e-5 * abs(mean),
        f"ImputationError med {card_med} vs numpy {med}, mean {card_mean} "
        f"vs {mean}")
  step_ms = float(np.median(h["epoch_time"][1:])) / (CELLS // BATCH) * 1e3
  per_epoch = [round(sum(s[e] for s in seconds.values()), 3)
               for e in range(ANALYSIS_EPOCHS)]
  log(f"[16a callbacks] SISUA (phase 6's configuration) {ANALYSIS_EPOCHS} "
      f"epochs in {fit_s:.1f} s with NegativeLogLikelihood(freq=1), "
      f"ImputationError(freq=1), CorrelationScores(freq=2) on the "
      f"{HELD_OUT} held-out cells ({CB_DRAWS} draws, batch {CB_BATCH}): "
      f"keys at epochs {[(e, len(k)) for e, k in keys.seen]}; last epoch "
      f"nllk {h['NegativeLogLikelihood_nllk'][-1]:.3f} nllk1 "
      f"{h['NegativeLogLikelihood_nllk1'][-1]:.3f} med {card_med:.4f} mean "
      f"{card_mean:.4f} spearman "
      f"{h['CorrelationScores_spearman'][-1]:.4f} pearson "
      f"{h['CorrelationScores_pearson'][-1]:.4f}")
  log(f"[16a callbacks] steady step {step_ms:.3f} ms (epochs 2–4; phase 6: "
      f"{PHASE6.get('step_ms', float('nan')):.3f} ms), callbacks "
      f"{per_epoch} s an epoch, outside the epoch timing (NLL "
      f"{[round(s, 3) for s in seconds[nll.name]]}, ImputationError "
      f"{[round(s, 3) for s in seconds[imp.name]]}, CorrelationScores "
      f"{[round(s, 3) for s in seconds[corr.name]]}); peak memory "
      f"{peak:.2f} GiB; launches {launches}")
  log(f"[16a callbacks] nllk kernel route {nk:.6f} plain {npl:.6f} (rel "
      f"{abs(nk - npl) / abs(npl):.2e}, worst cell {nrow:.2e}), nllk1 "
      f"{ak:.6f} / {apl:.6f} (rel {abs(ak - apl) / abs(apl):.2e}, worst "
      f"cell {arow:.2e}) on the same draws (rtol {NLL_RTOL}); med/mean "
      f"equal to numpy on the fetched {imp.imputed.shape} imputed mean "
      f"({host_s:.2f} s on the host)")
  return launches, model, imp


def _planted(torch, x):
  """A copy of phase 4's counts in DE_GROUPS groups of contiguous cells.
  DE_PLANTED genes of each group are redrawn as Poisson(DE_BASE) in every
  cell, scaled ×DE_FOLD in the group's own cells."""
  import numpy as np
  gen = torch.Generator(device="cpu").manual_seed(SEED + 16)
  genes = torch.randperm(GENES, generator=gen)[:DE_GROUPS * DE_PLANTED]
  planted = genes.view(DE_GROUPS, DE_PLANTED).numpy()
  xd = x.clone()
  per = CELLS // DE_GROUPS
  gdev = torch.Generator(device=xd.device).manual_seed(SEED + 16)
  for g in range(DE_GROUPS):
    rate = torch.full((CELLS, DE_PLANTED), DE_BASE, device=xd.device)
    rate[g * per:(g + 1) * per] *= DE_FOLD
    xd[:, torch.as_tensor(planted[g], device=xd.device)] = torch.poisson(
        rate, generator=gdev)
  labels = np.repeat([f"group{g}" for g in range(DE_GROUPS)], per)
  return xd, labels, planted


def phase_de(torch, x):
  """Phase 16b: phase 4's SCVI fit (16 epochs in two windows of 8; 8
  left a group unresolved) on planted groups, then
  ``differential_expression`` one-vs-rest at the JAX defaults and once in
  'vanilla' mode. Returns the ZINB launches of its fit, the latent means
  of the planted counts and their group labels."""
  import numpy as np
  from scipy import stats
  from sisua_tpu_torch.models import base
  from sisua_tpu_torch.ops import zinb as tz
  xd, labels, planted = _planted(torch, x)
  rng = np.random.default_rng(SEED + 17)
  rest = np.setdiff1d(np.arange(GENES), planted.reshape(-1))
  cols = np.sort(np.concatenate([planted.reshape(-1), rng.choice(
      rest, DE_CHECK_GENES - planted.size, replace=False)]))
  idx = torch.as_tensor(cols, device=DEVICE)
  model = _scvi(torch, "full")
  tz.reset_launches()
  model.fit(xd, epochs=LONG_EPOCHS, batch_size=BATCH, learning_rate=1e-3,
            clipnorm=100.0, metrics_interval=LONG_WINDOW, device_cache=True)
  launches = dict(tz.launches)
  losses = np.asarray(model.history["loss"])
  check(np.isfinite(losses).all(), f"planted SCVI losses {losses}")
  # time the draws and the statistics apart; keep the first group's draws
  # and pairs at the checked columns for the numpy statistics
  timing = {"draws": [], "stats": []}
  kept = []
  draws, stats_fn = model._normalized_draws, base._de_stats_torch

  def timed_draws(*a, **kw):
    t0 = time.perf_counter()
    out = list(draws(*a, **kw))
    torch.cuda.synchronize()
    timing["draws"].append(time.perf_counter() - t0)
    return iter(out)

  def timed_stats(s1, s2, i1, i2, mode, delta):
    t0 = time.perf_counter()
    out = stats_fn(s1, s2, i1, i2, mode, delta)
    timing["stats"].append(time.perf_counter() - t0)
    if not kept:
      kept.append((s1[:, idx], s2[:, idx], i1, i2, mode, delta,
                   {k: v[cols] for k, v in out.items()}))
    return out
  model._normalized_draws = timed_draws
  base._de_stats_torch = timed_stats
  try:
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    de = model.differential_expression(xd, labels)
    de_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    _check_de_stats(kept.pop())
    t0 = time.perf_counter()
    van = model.differential_expression(xd, labels, group1="group0",
                                        mode="vanilla")
    van_s = time.perf_counter() - t0
    _check_de_stats(kept.pop())
  finally:
    base._de_stats_torch = stats_fn
    del model._normalized_draws
  n = GENES
  check(len(de["group1"]) == DE_GROUPS * n
        and list(dict.fromkeys(de["group1"])) == list(dict.fromkeys(labels)),
        "one-vs-rest levels")
  for k in ("scale1", "scale2", "proba_de", "bayes_factor", "lfc_mean",
            "lfc_median", "lfc_std"):
    check(np.isfinite(de[k]).all(), f"DE {k} not finite")
  check(((de["proba_de"] >= 0) & (de["proba_de"] <= 1)).all()
        and ((van["proba_m1"] >= 0) & (van["proba_m1"] <= 1)).all()
        and np.isfinite(van["bayes_factor"]).all(), "DE probabilities")
  xh = xd.cpu().numpy()
  hits, rho_planted, rho_all = [], [], []
  union = planted.reshape(-1)
  for g in range(DE_GROUPS):
    med = de["lfc_median"][g * n:(g + 1) * n]
    top = np.argsort(-med)[:DE_PLANTED]
    hits.append(len(np.intersect1d(top, planted[g])))
    m1 = labels == f"group{g}"
    emp = np.log2(xh[m1].mean(0) + 1.0) - np.log2(xh[~m1].mean(0) + 1.0)
    rho_planted.append(stats.spearmanr(emp[union], med[union]).statistic)
    rho_all.append(stats.spearmanr(emp, med).statistic)
  check(min(hits) >= DE_HITS, f"planted genes in each group's top "
        f"{DE_PLANTED}: {hits} (need {DE_HITS})")
  check(min(rho_all) > DE_SPEARMAN, f"Spearman against the empirical "
        f"lfc {rho_all}")
  log(f"[16b de] SCVI (phase 4's nets) {EPOCHS} epochs on {CELLS} × "
      f"{GENES} counts in {DE_GROUPS} groups, {DE_PLANTED} genes each at "
      f"Poisson({DE_BASE:g}) ×{DE_FOLD:g} in the group: loss "
      f"{losses[0]:.2f} → {losses[-1]:.2f}; "
      f"differential_expression one-vs-rest (sample_shape (25,), n_pairs "
      f"5000, max_cells 256) in {de_s:.2f} s: draws "
      f"{[round(s, 3) for s in timing['draws'][:2 * DE_GROUPS]]} s, "
      f"statistics {[round(s, 3) for s in timing['stats'][:DE_GROUPS]]} s "
      f"per group; peak {peak:.2f} GiB above the resident "
      f"{base_mem / 2**30:.2f} GiB; vanilla group0 vs rest {van_s:.2f} s")
  log(f"[16b de] planted genes in each group's top {DE_PLANTED} "
      f"lfc_median: {hits} (need ≥ {DE_HITS}); Spearman against the "
      f"empirical log2 fold change over all {GENES} genes "
      f"{[round(float(r), 4) for r in rho_all]} (need > {DE_SPEARMAN}), "
      f"over the {len(union)} planted genes "
      f"{[round(float(r), 4) for r in rho_planted]}")
  # phase 17b's latents: the fitted model's latent means of every cell
  z = model.predict_mean(xd)[1][0]
  del xd
  return launches, z, labels


def _de_scale(want, k):
  """What a statistic's error is relative to: its value, or the size of
  the terms it is a difference or a signed sum of, where that is larger
  (a value near 0 keeps their rounding): the pairs' RMS lfc for the lfc
  mean and median (each lfc a difference of two log2 of ~−15), both
  logarithms for the Bayes factor."""
  import numpy as np
  w = np.abs(want[k])
  if k in ("lfc_mean", "lfc_median"):
    return np.maximum(w, np.hypot(want["lfc_mean"], want["lfc_std"]))
  if k == "bayes_factor":
    p = want.get("proba_de", want.get("proba_m1"))
    return np.maximum(w, np.abs(np.log(p + 1e-10))
                      + np.abs(np.log1p(1e-10 - p)))
  return w


def _check_de_stats(kept):
  """One group's statistics on the card against the numpy statements on
  the same draws, fetched at the checked columns (each gene's statistics
  are its own): rtol 1e-10 of ``_de_scale``, proba_* exact."""
  import numpy as np
  from sisua_tpu_torch.models import base
  s1, s2, i1, i2, mode, delta, got = kept
  t0 = time.perf_counter()
  want = base._de_stats_numpy(s1.cpu().numpy(), s2.cpu().numpy(), i1, i2,
                              mode, delta)
  host_s = time.perf_counter() - t0
  worst = 0.0
  for k, w in want.items():
    if k.startswith("proba"):
      check(np.array_equal(got[k], w), f"DE {mode} {k}: card != numpy")
      continue
    err = np.abs(got[k] - w) / np.maximum(_de_scale(want, k), 1e-300)
    worst = max(worst, float(err.max()))
    check(err.max() <= 1e-10, f"DE {mode} {k}: rel {err.max():.2e}")
  log(f"[16b de] {mode}: the card's statistics against numpy on the same "
      f"float64 draws ({s1.shape[0]} and {s2.shape[0]} draw rows) at "
      f"{s1.shape[1]} genes (the planted and a seeded sample): proba "
      f"exact, worst rel {worst:.2e} (bound 1e-10; n_pairs {len(i1)}"
      + (", even: lfc_median averages two middle values"
         if mode == "change" else "") + f"); numpy {host_s:.2f} s")


def phase_knn_mi(torch, model, imp, x, y):
  """Phase 16c: the gene × protein kNN mutual information on the card, on
  the SISUA model's imputed mean of the MI_GENES most variable genes of
  phase 16a's held-out imputation, over MI_CELLS training cells."""
  import numpy as np
  from sisua_tpu_torch.analysis.posterior import _dist_mean, _unwrap_imputed
  from sisua_tpu_torch.ops import knn_mi
  cols = np.sort(np.argsort(-imp.imputed.var(axis=0))[:MI_GENES])
  idx = torch.as_tensor(cols, device=DEVICE)
  with torch.no_grad():
    parts = [_dist_mean(_unwrap_imputed(out.outputs[0]))[:nv][:, idx]
             for out, _, nv in model._served_batches(
                 [x[:MI_CELLS], y[:MI_CELLS]], (), BATCH)]
  X = torch.cat(parts)
  Y = y[:MI_CELLS]
  torch.cuda.synchronize()
  base_mem = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  mi = knn_mi.knn_mutual_information(X, Y, device=DEVICE)
  torch.cuda.synchronize()
  card_s = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated() - base_mem
  check(mi.shape == (MI_GENES, PROTEINS) and np.isfinite(mi).all()
        and (mi >= 0).all(), f"MI {mi.shape}, min {mi.min()}")
  check(peak <= MI_BUDGET, f"MI peak {peak / 2**30:.2f} GiB > budget")
  # the same jittered operands on the CPU, for MI_CPU_GENES of the genes
  Xh, Yh = knn_mi._host64(X), knn_mi._host64(Y)
  rng = np.random.RandomState(8)
  Xs, Ys = knn_mi._prep(Xh, rng, 1e-5), knn_mi._prep(Yh, rng, 1e-5)
  sel = np.sort(np.random.default_rng(SEED + 18).choice(
      MI_GENES, MI_CPU_GENES, replace=False))
  qblock = min(MI_CELLS, 2048)  # the defaults of knn_mutual_information
  chunk = max(1, min(MI_GENES, MI_BUDGET // (16 * qblock * MI_CELLS)))
  t0 = time.perf_counter()
  cpu = knn_mi._mi_prepared(Xs[:, sel], Ys, 3, min(chunk, MI_CPU_GENES),
                            qblock, torch.device("cpu"))
  cpu_s = time.perf_counter() - t0
  err = float(np.abs(mi[sel] - cpu).max())
  check(err <= MI_ATOL, f"MI card vs CPU max |Δ| {err:.2e} nats")
  log(f"[16c knn_mi] knn_mutual_information of {MI_GENES} imputed genes × "
      f"{PROTEINS} proteins over {MI_CELLS} cells on the card in "
      f"{card_s:.2f} s (chunk {chunk} genes × qblock {qblock} cells, "
      f"{-(-MI_GENES // chunk)} chunks), peak "
      f"{peak / 2**30:.2f} GiB above the resident (budget "
      f"{MI_BUDGET / 2**30:.0f} GiB); MI max {mi.max():.4f} nats, mean "
      f"{mi.mean():.4f}; the CPU on {MI_CPU_GENES} of the genes in "
      f"{cpu_s:.1f} s: max |Δ| {err:.2e} nats (atol {MI_ATOL})")


def phase_analysis(torch, x, held, y, held_y):
  """Phases 16, 17 and 22: the metric callbacks, the kNN mutual
  information, the posterior hub on 16a's SISUA, the figures' data of
  that hub (22), differential expression, and the latent-space scores of
  16b's SCVI. Returns the ZINB launches of 16a, 16b, 17a and 22, and
  16b's latent means."""
  launches, model, imp = phase_callbacks(torch, x, held, y, held_y)
  phase_knn_mi(torch, model, imp, x, y)
  del imp
  torch.cuda.empty_cache()
  hub_launches, unplanted, hubs = phase_posterior(torch, model, x, y,
                                                  held, held_y)
  torch.cuda.empty_cache()
  fig_launches = phase_figures(torch, model, x, y, held, held_y, *hubs)
  del model, hubs
  torch.cuda.empty_cache()
  de_launches, z, labels = phase_de(torch, x)
  torch.cuda.empty_cache()
  phase_latent_scores(torch, z, labels, *unplanted)
  return {k: v + de_launches[k] + hub_launches[k] + fig_launches[k]
          for k, v in launches.items()}, z


# phase 17: the posterior hub
HUB_DRAWS = 10           # create_posterior's sample_shape (the JAX default)
HUB_BATCH = 256          # its batch_size (the JAX default)
HUB_LLK_RTOL = 1e-5      # cal_llk: kernel route vs distribution math
HUB_CARD_TOL = 1e-9      # 17b: the card's scores vs the CPU's
HUB_FAMILIES = ("cal_llk", "cal_imputation_scores", "cal_spearman",
                "cal_pearson", "cal_protein_prediction",
                "cal_mutual_information", "cal_protein_classification",
                "cal_mig", "cal_dci", "cal_clustering_scores")
CRT_FAMILIES = ("cal_clustering_scores", "cal_dci_scores",
                "cal_mutual_info_gap", "cal_total_correlation",
                "cal_separated_attr_predictability",
                "cal_relative_disentanglement_strength",
                "cal_relative_mutual_strength", "cal_betavae_score",
                "cal_factorvae_score")
CRT_KEYS = ("ASW", "ARI", "NMI", "UCA", "disentanglement", "completeness",
            "informativeness", "dci", "mig", "tc", "sap", "rds", "rms",
            "betavae", "factorvae")


def _timed_methods(torch, obj, names):
  """Each method of ``obj`` timed (synchronized) into ``seconds[name]``,
  through an instance attribute that its callers find first."""
  seconds = {}
  for name in names:
    def timed(*a, run=getattr(obj, name), name=name, **kw):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = run(*a, **kw)
      torch.cuda.synchronize()
      seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
      return out
    setattr(obj, name, timed)
  return seconds


def _host_bytes(dists):
  """Bytes of the tensors held by (a tuple of) host distributions."""
  import sisua_tpu_torch.dist as TD
  seen = []
  for d in dists if isinstance(dists, tuple) else (dists,):
    TD.tree_map(lambda t: seen.append(t.nbytes) or t, d)
  return sum(seen)


def _hub_keys(post, prots):
  """The keys ``save_scores`` must give for SISUA with the 10 proteins,
  by family (the JAX package's names)."""
  pairs = [f"{p}/{g}" for p, g in zip(prots, _marker_names()[0])]
  outs, f = post.output_omics, "proteomic"
  f1 = sorted(k for k in post.cal_protein_classification())
  return {
      "cal_llk": {f"llk_{o}_pred{a}_data{b}" for o in outs
                  for a in ("cor", "org") for b in ("org", "cor")},
      "cal_imputation_scores": {"imputation_med", "imputation_mean",
                                "imputation_std"},
      "cal_spearman": {f"spearman_{p}" for p in pairs} | {"spearman_mean"},
      "cal_pearson": {f"pearson_{p}" for p in pairs} | {"pearson_mean"},
      "cal_protein_prediction": (
          {f"protein_{m}_{p}" for m in ("pearson", "spearman")
           for p in prots} | {"protein_pearson_mean",
                              "protein_spearman_mean"}),
      "cal_mutual_information": {f"mi_{f}"},
      "cal_protein_classification": set(f1) | {"f1_F1micro",
                                              "f1_F1macro"},
      "cal_mig": {f"mig_{f}"},
      "cal_dci": {f"{k}_{f}" for k in ("disentanglement", "completeness",
                                       "informativeness", "dci")},
      "cal_clustering_scores": {f"{k}_{f}" for k in ("ASW", "ARI", "NMI",
                                                     "UCA")},
  }


def phase_posterior(torch, model, x, y, held, held_y):
  """Phase 17a: the posterior hub at full width, the JAX experimenter's
  ``on_eval``: ``create_posterior`` of 16a's SISUA on the held-out cells
  at the JAX defaults with ``device_cache=True``, ``save_scores()``, the
  proteins' ``cal_all_scores()``; then ``create_posterior`` at every
  default (``device_cache=False``) and its ``cal_llk``. Returns the ZINB
  launches, for 17b the model's latent means of all cells with their
  protein bins' labels (the first positive protein), which hold no
  planted groups, and for phase 22 the two hubs."""
  import math
  import numpy as np
  from sisua_tpu_torch.models import base
  from sisua_tpu_torch.ops import zinb as tz
  genes, prots = _marker_names()
  data = {"transcriptomic": held, "proteomic": held_y}
  names = {"transcriptomic": genes, "proteomic": prots}
  torch.cuda.synchronize()
  base_mem = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  post = model.create_posterior(data, var_names=names, device_cache=True,
                                sample_shape=HUB_DRAWS,
                                batch_size=HUB_BATCH)
  torch.cuda.synchronize()
  build_s = time.perf_counter() - t0
  host = _host_bytes(post.pX_cor) + _host_bytes(post.pX_org)
  seconds = _timed_methods(torch, post, HUB_FAMILIES)
  state = model.generator.get_state()  # cal_llk draws first
  scores = post.save_scores()
  crt = post.criticizers["proteomic"]
  crt_seconds = _timed_methods(torch, crt, CRT_FAMILIES)
  crt_scores = crt.cal_all_scores()
  torch.cuda.synchronize()
  total_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
  check(not post.failures, f"families skipped: {post.failures}")
  want = _hub_keys(post, prots)
  missing = {fam: sorted(keys - set(scores)) for fam, keys in want.items()
             if keys - set(scores)}
  check(not missing, f"save_scores lacks {missing}")
  check(set(scores) == set().union(*want.values()),
        f"save_scores has extra keys "
        f"{sorted(set(scores) - set().union(*want.values()))}")
  check(all(math.isfinite(v) for v in scores.values()),
        f"non-finite scores {[k for k, v in scores.items() if not math.isfinite(v)]}")
  check(set(crt_scores) == set(CRT_KEYS)
        and all(math.isfinite(v) for v in crt_scores.values()),
        f"cal_all_scores {crt_scores}")
  # 2 sources × served batches × 2 target sets × 2 heads (RNA, proteins),
  # the draws as the member axis: one forward launch each
  batches = -(-HELD_OUT // HUB_BATCH)
  check(launches == {"zinb_rowsum_fwd": 2 * batches * 2 * 2,
                     "zinb_rowsum_bwd": 0},
        f"hub launches {launches}: expected 2 sources × {batches} batches "
        f"× 2 target sets × 2 heads forward")
  # cal_llk's kernel route against the distribution math at the same draws
  model.generator.set_state(state)
  fused = base.mc_row_log_prob
  base.mc_row_log_prob = lambda dist, x: dist.log_prob(x)
  try:
    tz.reset_launches()
    plain = post._cal_llk_on_device()
    torch.cuda.synchronize()
    plain_launches = tz.launches["zinb_rowsum_fwd"]
  finally:
    base.mc_row_log_prob = fused
  llk = post.cal_llk()
  rel = max(abs(llk[k] - plain[k]) / abs(plain[k]) for k in plain)
  check(list(plain) == list(llk) and plain_launches == 0
        and rel <= HUB_LLK_RTOL,
        f"cal_llk kernel route vs distribution math: rel {rel:.2e}, "
        f"plain route launched {plain_launches}")
  log(f"[17a posterior] create_posterior(SISUA, {HELD_OUT} held-out cells "
      f"× {GENES} genes + {PROTEINS} proteins, dropout 0.2 / retain 0.2 "
      f"binomial, sample_shape {HUB_DRAWS}, batch {HUB_BATCH}, "
      f"device_cache=True) {build_s:.2f} s; pX_cor + pX_org hold "
      f"{host / 1e9:.3f} GB on the host; save_scores() {len(scores)} keys "
      f"and cal_all_scores() {len(crt_scores)} keys, all finite, no family "
      f"skipped; {total_s:.2f} s in all; peak {peak:.2f} GiB above the "
      f"resident {base_mem / 2**30:.2f} GiB; launches {launches}")
  log(f"[17a posterior] seconds by family: "
      + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
      + "; criticizer: "
      + ", ".join(f"{k} {v:.3f}" for k, v in crt_seconds.items()))
  log(f"[17a posterior] cal_llk through the fused forward (draws as "
      f"members) vs the distribution math at the same draws: worst rel "
      f"{rel:.2e} (bound {HUB_LLK_RTOL}); "
      + ", ".join(f"{k} {v:.4f}" for k, v in llk.items()))
  log(f"[17a posterior] imputation_med {scores['imputation_med']:.4f} "
      f"mean {scores['imputation_mean']:.4f}; spearman_mean "
      f"{scores['spearman_mean']:.4f} pearson_mean "
      f"{scores['pearson_mean']:.4f}; protein_pearson_mean "
      f"{scores['protein_pearson_mean']:.4f}; f1_F1micro "
      f"{scores['f1_F1micro']:.4f}; mi_proteomic "
      f"{scores['mi_proteomic']:.4f}; dci {crt_scores['dci']:.4f} "
      f"betavae {crt_scores['betavae']:.4f} factorvae "
      f"{crt_scores['factorvae']:.4f} ASW {crt_scores['ASW']:.4f}")
  embedding = post._protein_embedding()
  default_launches, post_default = _posterior_at_defaults(torch, model,
                                                          data, names)
  zs = model.predict_mean([x, y], batch_size=HUB_BATCH)[1][0]
  bins = embedding.predict(y)
  return ({k: v + default_launches[k] for k, v in launches.items()},
          (zs, np.argmax(bins, 1)), (post, post_default))


def _posterior_at_defaults(torch, model, data, names):
  """17a at ``create_posterior``'s own defaults (``device_cache=False``:
  the predictions streamed to the host): ``cal_llk`` takes each 256
  cells of the host distributions to the card, through the fused
  forward (the draws as members), and equals their distribution math
  there (rel ≤ HUB_LLK_RTOL). Returns the ZINB launches and the hub."""
  from sisua_tpu_torch.ops import zinb as tz
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  post = model.create_posterior(data, var_names=names)
  build_s = time.perf_counter() - t0
  check(not post.device_cache and post.sample_shape == HUB_DRAWS
        and post.batch_size == HUB_BATCH, "create_posterior's defaults")
  tz.reset_launches()
  t0 = time.perf_counter()
  llk = post.cal_llk()
  torch.cuda.synchronize()
  llk_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  batches = -(-HELD_OUT // HUB_BATCH)
  check(launches == {"zinb_rowsum_fwd": 2 * batches * 2 * 2,
                     "zinb_rowsum_bwd": 0},
        f"default hub launches {launches}: expected 2 sources × {batches} "
        f"batches × 2 target sets × 2 heads forward")
  tz.reset_launches()
  plain = post._cal_llk_of_predictions(lambda dist, m: dist.log_prob(m))
  torch.cuda.synchronize()
  rel = max(abs(llk[k] - plain[k]) / abs(plain[k]) for k in plain)
  check(list(plain) == list(llk) and len(llk) == 8
        and tz.launches["zinb_rowsum_fwd"] == 0 and rel <= HUB_LLK_RTOL,
        f"default cal_llk vs distribution math: rel {rel:.2e}")
  log(f"[17a posterior] at the defaults (device_cache=False): "
      f"create_posterior {build_s:.2f} s, cal_llk on the card {llk_s:.2f} s "
      f"({launches['zinb_rowsum_fwd']} forward launches on the host "
      f"distributions' draws), vs the distribution math at those draws: "
      f"worst rel {rel:.2e} (bound {HUB_LLK_RTOL})")
  return launches, post


def _card_vs_cpu(torch, z, ids):
  """``clustering_scores`` of latents ``z`` against label ids on the card
  and on the CPU (the same host draws), and KMeans (10 restarts) and the
  full GMM on both: identical partitions up to relabeling, inertia and
  lower bound within HUB_CARD_TOL relative, every score within
  HUB_CARD_TOL. Returns (card scores, worst |Δ| of the scores, worst rel
  of inertia and lower bound, seconds by name)."""
  from sisua_tpu_torch.analysis import clustering_scores
  from sisua_tpu_torch.analysis.estimators import (GaussianMixture, KMeans,
                                                   adjusted_rand_score)
  k = int(ids.max() + 1)
  zc = torch.as_tensor(z, dtype=torch.float64, device=DEVICE)
  zh = zc.cpu()
  timing = {}

  def timed(name, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    timing[name] = time.perf_counter() - t0
    return out
  card = timed("card", lambda: clustering_scores(zc, ids, seed=8))
  cpu = timed("cpu", lambda: clustering_scores(zh, ids, seed=8,
                                               device="cpu"))
  worst = max(abs(card[key] - cpu[key]) for key in cpu)
  check(list(card) == list(cpu) == ["ASW", "ARI", "NMI", "UCA"]
        and worst <= HUB_CARD_TOL,
        f"clustering_scores card {card} vs cpu {cpu}")
  # the fits themselves: the same host draws on both devices
  rel = 0.0
  for name, est, value in (
      ("kmeans", lambda d: KMeans(k, n_init=10, random_state=8, device=d),
       lambda m: m.inertia_),
      ("gmm", lambda d: GaussianMixture(k, random_state=8, device=d),
       lambda m: m.lower_bound_)):
    mc, mh = est(DEVICE).fit(zc), est("cpu").fit(zh)
    pc = mc.labels_ if name == "kmeans" else mc.predict(zc)
    ph = mh.labels_ if name == "kmeans" else mh.predict(zh)
    check(adjusted_rand_score(pc.cpu(), ph, device="cpu") == 1.0,
          f"{name} partition differs between card and CPU")
    rel = max(rel, abs(value(mc) / value(mh) - 1))
    check(rel <= HUB_CARD_TOL, f"{name} card {value(mc)!r} vs cpu "
          f"{value(mh)!r}: rel {rel:.2e}")
  return card, worst, rel, timing


def phase_latent_scores(torch, z, labels, zs, protein_ids):
  """Phase 17b: the latent-space scores at an evaluation set's size: 16b's
  SCVI latent means of all 8,192 cells against their 4 planted groups,
  ``clustering_scores`` and the criticizer on the card, the clustering
  held against the port's own CPU path on the same host draws; the same
  card-vs-CPU check on 16a's SISUA latent means of the 8,192 cells
  against their protein bins, where no clusters are planted."""
  import math
  import numpy as np
  from sisua_tpu_torch.analysis import Criticizer
  ids = np.unique(labels, return_inverse=True)[1]
  k = int(ids.max() + 1)
  card, worst, rel, timing = _card_vs_cpu(torch, z, ids)
  pids = np.unique(protein_ids, return_inverse=True)[1]
  card2, worst2, rel2, timing2 = _card_vs_cpu(torch, zs, pids)
  crt = Criticizer(torch.as_tensor(z, dtype=torch.float64, device=DEVICE),
                   np.eye(k)[ids], seed=8)
  seconds = _timed_methods(torch, crt, CRT_FAMILIES)
  t0 = time.perf_counter()
  scores = crt.cal_all_scores()
  crt_s = time.perf_counter() - t0
  check(set(scores) == set(CRT_KEYS)
        and all(math.isfinite(v) for v in scores.values()),
        f"cal_all_scores {scores}")
  log(f"[17b latent scores] {len(ids)} SCVI latent means × {z.shape[1]} "
      f"against {k} planted groups: clustering_scores on the card "
      f"{timing['card']:.3f} s (KMeans 10 restarts, full GMM, ASW over "
      f"{len(ids)}² pairs), the CPU {timing['cpu']:.3f} s; card vs CPU "
      f"worst |Δ| {worst:.2e}, inertia / lower bound worst rel {rel:.2e} "
      f"(bound {HUB_CARD_TOL}); KMeans and GMM partitions identical up to "
      f"relabeling; " + ", ".join(f"{key} {v:.6f}"
                                  for key, v in card.items()))
  log(f"[17b latent scores] {len(pids)} SISUA latent means × "
      f"{zs.shape[1]} against {int(pids.max() + 1)} protein-bin labels "
      f"(no planted groups): card {timing2['card']:.3f} s, CPU "
      f"{timing2['cpu']:.3f} s; card vs CPU worst |Δ| {worst2:.2e}, "
      f"inertia / lower bound worst rel {rel2:.2e}; partitions identical; "
      + ", ".join(f"{key} {v:.6f}" for key, v in card2.items()))
  log(f"[17b latent scores] Criticizer.cal_all_scores() {crt_s:.2f} s: "
      + ", ".join(f"{key} {v:.3f}" for key, v in seconds.items())
      + "; dci {dci:.4f} mig {mig:.4f} betavae {betavae:.4f} factorvae "
      "{factorvae:.4f}".format(**scores))


# phase 20: the data analyzer (``SingleCellOMIC``'s ``data/analysis.py``)
P20_HVG = 2000           # filter_highly_variable_genes(n_top_genes=...)
P20_PCS = 100            # dimension_reduce's default n_components
# seconds of the card-side methods at full size (120 until phase 21 joined
# the run: the trees fill what the budget leaves)
P20_BUDGET = 90.0
P20_CHECK_STEP = 4       # the card-vs-CPU subset: every 4th cell (2,048)
P20_MI_CPU_GENES = 64    # genes of the MI's card-vs-CPU check
# get_mutual_information's max_cells: 2,048 since phase 21 joined the run
# (4,096 took 29 s in sklearn's O(N²) backend, 13 s in 'jax')
P20_MI_CELLS = 2048
P20_TREES_MAX = 80       # get_importance_matrix's default n_estimators
P20_IMP_GENES = 250      # its genes: the trees' host time grows with them
P20_TOL = {              # card vs CPU on the subset
    "float32": 1e-6,     # relative: QC, normalize, rank scores/p-values
    "pca_sv": 1e-4,      # relative: singular values (float32 SVDs)
    "pca": 1e-2,         # of the range: the leading 3 score columns
    "graph": 1e-9,       # relative: kNN distances, fuzzy-set weights
    "umap_start": 1e-4,  # the spectral start, absolute
    "umap_p99": 1e-5,    # one SGD epoch from one graph and start: 99% of
    "umap_max": 1e-2,    # the coordinates within 1e-5, all within 1e-2
    "pearson": 1e-6, "spearman": 1e-9, "mi_sklearn": 1e-9,
    "mi_jax": MI_ATOL}


def _p20_container(torch, x, y):
  """Phase 16b's 4 planted groups of phase 4's counts, phase 6's 10
  proteins and the groups one-hot, as a ``SingleCellOMIC`` (numpy on the
  host, as the container holds them)."""
  import numpy as np
  from sisua_tpu_torch.data import SingleCellOMIC
  xd, labels, _ = _planted(torch, x)
  genes, prots = _marker_names()
  sco = SingleCellOMIC(xd.cpu().numpy(), gene_id=genes, name="phase20")
  del xd
  sco.add_omic("proteomic", y.cpu().numpy(), prots)
  ids = np.unique(labels, return_inverse=True)[1]
  sco.add_omic("celltype", np.eye(DE_GROUPS, dtype=np.float32)[ids],
               [f"group{g}" for g in range(DE_GROUPS)])
  return sco, ids


def _p20_run(torch, rows, label, fn):
  """``fn()`` timed on the card (synchronized) with its peak memory above
  the resident; one result line."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  sec = time.perf_counter() - t0
  peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
  rows[label] = sec
  log(f"[20 analysis] {label}: {sec:.3f} s on the card, peak "
      f"{peak:.3f} GiB above the resident")
  return out


def _p20_close(label, got, want, tol, scale=None):
  """|got − want| ≤ tol·|want| (or tol·scale); prints the worst."""
  import numpy as np
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  check(got.shape == want.shape, f"{label}: shapes {got.shape} "
        f"{want.shape}")
  bound = tol * (np.abs(want) if scale is None else scale)
  err = np.abs(got - want)
  worst = float(np.max(err / np.maximum(bound, 1e-300) * tol)) \
      if err.size else 0.0
  check(bool(np.all(err <= bound)), f"{label}: card vs CPU worst "
        f"{worst:.2e} beyond {tol:g}")
  kind = ("relative" if scale is None else "absolute"
          if np.ndim(scale) == 0 else "of each column's range")
  log(f"[20 analysis] {label}: card vs CPU within {tol:g} ({kind}; "
      f"worst {worst:.2e})")


def _p20_equal(label, got, want, what="card equal to the CPU"):
  import numpy as np
  check(np.array_equal(np.asarray(got), np.asarray(want)),
        f"{label}: not {what}")
  log(f"[20 analysis] {label}: {what}")


# phase 22: the figures' data on the card
FIG_TOL = dict(rtol=1e-5, atol=1e-6)  # card vs CPU data steps (float32)
# the min-max scaled dot plots and heatmaps (the CPU tests' bound): an ulp
# of a float32 log1p mean, divided by the range the scaling divides by
FIG_SCALED = ("_dotplot_", "_heatmap_")
FIG_SCALED_ATOL = 1e-5
FIG_PCA_ATOL = 2e-4   # PCA scatters: of a column's range (ROADMAP A23)
FIG_TRUST = 0.02      # t-SNE / UMAP scatters: trustworthiness gap
FIG_BUDGET_S = 120.0
# the card-vs-CPU check's held-out cells: two of the hub's batches, so
# that its batch loops cross a batch boundary on both devices
FIG_CPU_CELLS = 2 * HUB_BATCH
# the check's draws: the first of the hub's HUB_DRAWS (cal_llk's plain
# ZINB over 10 draws of 512 × 33,000 took 42 s on the host's CPU)
FIG_CPU_DRAWS = 2
FIG_EMBEDDED = ("_tsne", "_umap", "protein_pairs", "latent_binary")
FIG_PCA = ("_pca", "divergence", "disentanglement_scatter", "ScatterPlot")


def _same_figure_data(name, card, cpu, z):
  """A figure's data from the card against the CPU's: strings, shapes and
  counts exactly, numbers within FIG_TOL (the scaled dot plots and
  heatmaps within FIG_SCALED_ATOL); a PCA embedding within
  FIG_PCA_ATOL of each column's range, a t-SNE/UMAP embedding by its
  trustworthiness against the latents ``z`` (FIG_TRUST)."""
  import numpy as np
  from sisua_tpu_torch.analysis.manifold import trustworthiness

  def walk(a, b, where):
    if isinstance(a, dict):
      check(isinstance(b, dict) and list(a) == list(b), f"{where} keys")
      for k in a:
        walk(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
      check(isinstance(b, (list, tuple)) and len(a) == len(b),
            f"{where} length")
      for i, (u, v) in enumerate(zip(a, b)):
        walk(u, v, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype.kind in "fiu":
      b = np.asarray(b)
      check(a.shape == b.shape, f"{where} shape {a.shape} vs {b.shape}")
      if where.endswith(".emb") and any(k in name for k in FIG_EMBEDDED):
        ta = trustworthiness(z, a, device=DEVICE)
        tb = trustworthiness(z, b, device=DEVICE)
        check(abs(ta - tb) <= FIG_TRUST,
              f"{where} trustworthiness card {ta:.4f} cpu {tb:.4f}")
      elif where.endswith(".emb") and any(k in name for k in FIG_PCA):
        span = np.ptp(b, axis=0) if len(b) else 0
        check(np.all(np.abs(a - b) <= FIG_PCA_ATOL * span + 1e-6),
              f"{where}: PCA beyond {FIG_PCA_ATOL} of the range")
      else:
        tol = dict(FIG_TOL)
        if any(k in name for k in FIG_SCALED):
          tol["atol"] = FIG_SCALED_ATOL
        ok = np.allclose(a.astype(np.float64), b.astype(np.float64),
                         equal_nan=True, **tol)
        check(ok, f"{where}: max |Δ| "
              f"{np.nanmax(np.abs(a.astype(np.float64) - b)):.3e}")
    elif isinstance(a, float):
      check(abs(a - b) <= FIG_TOL["atol"] + FIG_TOL["rtol"] * abs(b)
            or (a != a and b != b), f"{where}: {a!r} vs {b!r}")
    else:
      a, b = np.asarray(a), np.asarray(b)
      check(a.shape == b.shape and bool(np.all(a == b)),
            f"{where}: {a!r} vs {b!r}")
  walk(card, cpu, name)


def _sub_hub(torch, model, post, data, names, device, n, draws):
  """A hub of the first ``n`` cells and ``draws`` draws of ``post``'s
  data and predictions (host distributions, sliced) whose data steps run
  on ``device``: a copy of the model there whose ``predict`` gives the
  slices (the corrupted source, then the original)."""
  import copy
  import sisua_tpu_torch.dist as TD
  from sisua_tpu_torch.analysis import Posterior
  from sisua_tpu_torch.analysis.posterior import _rows

  def first(d):  # cells, then draws (the leading sample axis)
    d = _rows(d, 0, n, "cpu")
    if len(d.batch_shape) < 2:
      return d
    s, rank = d.batch_shape[0], len(d.batch_shape)
    return TD.tree_map(lambda t: t.narrow(0, 0, draws)
                       if t.ndim > rank and t.shape[0] == s else t, d)

  def cut(d):
    return tuple(first(t) for t in d) if isinstance(d, tuple) else first(d)
  sub = copy.copy(model)
  sub.device = torch.device(device)
  preds = iter([(cut(post.pX_cor), cut(post.qZ_cor)),
                (cut(post.pX_org), cut(post.qZ_org))])
  sub.predict = lambda *a, **k: next(preds)
  hub = Posterior(sub, {k: v[:n].cpu() for k, v in data.items()},
                  var_names=names, sample_shape=draws, seed=8)
  hub.name = post.name
  return hub


def _share_trees(src_hub, hub):
  """The DCI's boosted trees (``Criticizer.create_importance_matrix``)
  grow on the host from a criticizer's host arrays, whatever the hub's
  device, and its split is the only draw from the criticizer's own
  stream. So where a criticizer of ``hub`` has latents and factors equal,
  bitwise, to one of ``src_hub``'s that grew them, it takes those trees
  instead of growing the same ones again. Returns the list of the factor
  names shared (filled as ``hub`` makes its criticizers)."""
  import numpy as np
  shared = []

  def share(crt):
    for src in src_hub.criticizers.values():
      if ("imp" in src._cache
          and np.array_equal(src.latents, crt.latents)
          and np.array_equal(src.factors, crt.factors)):
        crt._cache["imp"] = src._cache["imp"]
        shared.append(list(crt.factor_names))
        break
    return crt
  for crt in hub.criticizers.values():
    share(crt)
  make = hub._criticizer
  hub._criticizer = lambda factors, names: share(make(factors, names))
  return shared


def _monitors(held, held_y, prots, root):
  """22c's three monitors on the held-out cells, every epoch."""
  from sisua_tpu_torch.analysis import (HeatmapPlot, LearningCurves,
                                        ScatterPlot)
  kw = dict(data=[held, held_y], freq=1)
  return [LearningCurves(root, **kw),
          ScatterPlot(root, labels=held_y, label_names=prots, **kw),
          HeatmapPlot(root, **kw)]


def _hub_figures(torch, hub, second):
  """The data of ``hub.plot_all(full=True)`` and of the ResultsSheet's
  ``plot_all`` over ``hub`` and ``second``, with their seconds."""
  from sisua_tpu_torch.analysis import ResultsSheet
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with hub.figure_data() as figs:
    hub.plot_all(full=True)
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  sheet = ResultsSheet(hub, second)
  with sheet.figure_data() as sheet_figs:
    sheet.plot_all()
  torch.cuda.synchronize()
  return figs, sheet_figs, t1 - t0, time.perf_counter() - t1


def _families(post):
  return [m for m in dir(post) if m.startswith("plot_") and m != "plot_all"]


def _top(seconds, k=6):
  return ", ".join(f"{name} {v:.3f}" for name, v in sorted(
      seconds.items(), key=lambda kv: -kv[1])[:k])


def phase_figures(torch, model, x, y, held, held_y, post, post_default):
  """Phase 22: the data step of every figure of ``plot_all(full=True)``
  of 17a's hub (16a's SISUA on the held-out cells), of
  ``ResultsSheet.plot_all`` over it and 17a's second hub of the same data
  (the one at ``create_posterior``'s defaults), and of the three monitors
  over one SISUA epoch, on the card. The data steps are held against the
  CPU's on the first FIG_CPU_CELLS held-out cells and FIG_CPU_DRAWS draws
  (hubs of the same predictions on the card and on the CPU; the sheet's
  second hub 17a's second in both; the DCI's host trees grown once, see
  ``_share_trees``). Then the renders' refusal:
  the card has no matplotlib. Returns the ZINB launches of the main path
  (the battery, the sheet and the monitors' epoch; the card-vs-CPU
  check's own launches are left out)."""
  import contextlib
  import sisua_tpu_torch.dist as TD
  from sisua_tpu_torch.analysis.sc_metrics import _first
  from sisua_tpu_torch.models import SISUA
  from sisua_tpu_torch.ops import zinb as tz
  genes, prots = _marker_names()
  data = {"transcriptomic": held, "proteomic": held_y}
  names = {"transcriptomic": genes, "proteomic": prots}
  n = FIG_CPU_CELLS
  log(f"[22 figures] the battery on 17a's hub of {HELD_OUT} held-out cells "
      f"(its t-SNE, UMAP, mutual-information and importance data on all "
      f"of them, no cut); card against CPU on the first {n} held-out cells "
      f"({n // HUB_BATCH} of the hub's batches of {HUB_BATCH}) and the "
      f"first {FIG_CPU_DRAWS} of its {HUB_DRAWS} draws, the sheet's "
      f"second hub there 17a's second (scored once, on the card): the "
      f"cuts keep phase 22 in its budget")
  torch.cuda.synchronize()
  base_mem = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t_phase = time.perf_counter()
  seconds = _timed_methods(torch, post, _families(post))
  card, sheet_card, card_s, sheet_s = _hub_figures(torch, post,
                                                   post_default)
  launches = dict(tz.launches)  # the main path's: the battery and sheet
  peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
  check(len(card) >= 30 and len(sheet_card) >= 10 and not post.figures,
        f"{len(card)} hub figures, {len(sheet_card)} sheet figures")
  log(f"[22a posterior figures] plot_all(full=True) data on the card: "
      f"{len(card)} figures in {card_s:.2f} s; peak {peak:.2f} GiB above "
      f"the resident {base_mem / 2**30:.2f} GiB; launches {launches} "
      f"(17a cached both hubs' cal_llk)")
  log("[22a posterior figures] seconds by figure family: "
      + _top(seconds, len(seconds)))
  log(f"[22b results sheet] plot_all() data over 17a's two hubs on the "
      f"card: {len(sheet_card)} figures in {sheet_s:.2f} s (the second "
      f"hub's scores included): {list(sheet_card)}")
  # the same data steps on the card and on the CPU, from one prediction;
  # their launches are not the main path's
  t0 = time.perf_counter()
  got, took, card_hub = {}, {}, None
  for dev in (DEVICE, "cpu"):
    hub = _sub_hub(torch, model, post, data, names, dev, n, FIG_CPU_DRAWS)
    if card_hub is not None:  # the host's trees are grown once
      shared = _share_trees(card_hub, hub)
    fam = _timed_methods(torch, hub, _families(hub))
    figs, sheet_figs, hub_s, sh_s = _hub_figures(torch, hub, post_default)
    got[dev] = (figs, sheet_figs)
    took[dev] = (hub_s, sh_s, fam)
    card_hub = hub
  del hub, card_hub
  check(len(shared) == 2, f"the CPU hub shared the trees of {len(shared)} "
        f"criticizers, not of its 2 (the proteins and the imputed ones)")
  check_launches = dict(tz.launches)
  (cf, cs), (hf, hs) = got[DEVICE], got["cpu"]
  check(list(cf) == list(hf) == list(card),
        f"hub figure names differ: card {list(cf)}, cpu {list(hf)}, "
        f"full {list(card)}")
  check(list(cs) == list(hs) == list(sheet_card),
        f"sheet figure names differ: card {list(cs)}, cpu {list(hs)}, "
        f"full {list(sheet_card)}")
  z = post.latents[:n]
  t1 = time.perf_counter()
  for figs_c, figs_h in ((cf, hf), (cs, hs)):
    for k in figs_c:
      _same_figure_data(k, figs_c[k], figs_h[k], z)
  t2 = time.perf_counter()
  log(f"[22a/b card vs CPU] {len(cf)} hub and {len(cs)} sheet figures of "
      f"{n} cells: names and data equal (tol {FIG_TOL}, scaled dot plots "
      f"and heatmaps atol {FIG_SCALED_ATOL}, PCA {FIG_PCA_ATOL} "
      f"of a column's range, t-SNE/UMAP trustworthiness within "
      f"{FIG_TRUST}) in {t2 - t0:.2f} s (the comparison {t2 - t1:.2f} s); "
      f"the check's own launches {check_launches}, not counted; the "
      f"DCI's boosted trees (host code on host arrays, equal bitwise on "
      f"both hubs) grown once, on the card's hub, for {len(shared)} "
      f"criticizers")
  for dev, (hub_s, sh_s, fam) in took.items():
    log(f"[22a/b card vs CPU] on {dev}: battery {hub_s:.2f} s, sheet "
        f"{sh_s:.2f} s; slowest families: {_top(fam)}")
  # 22c: the monitors over one SISUA epoch, then card vs CPU data steps
  root = tempfile.mkdtemp(prefix="chip_smoke_monitors_")
  try:
    mons = _monitors(held, held_y, prots, root)
    fresh = SISUA(_sisua_outputs(), alpha=ALPHA, device=DEVICE, seed=SEED)
    tz.reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
      fired = [stack.enter_context(m.figure_data()) for m in mons]
      fresh.fit([x, y], epochs=1, batch_size=BATCH, learning_rate=1e-3,
                labels_percent=LABELS_PERCENT, device_cache=True,
                callbacks=mons)
      torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v + tz.launches[k] for k, v in launches.items()}
    check(not os.listdir(root), "a monitor wrote files in its data mode")
    fired = {type(m).__name__: list(d) for m, d in zip(mons, fired)}
    check(fired["ScatterPlot"] == ["ScatterPlot_epoch0000"]
          and fired["HeatmapPlot"] == ["HeatmapPlot_epoch0000"],
          f"monitor firings {fired}")
    pX, qZ = fresh.predict([held, held_y], sample_shape=(2,),
                           batch_size=HUB_BATCH)
    to = lambda d, dev: TD.tree_map(lambda t: t.to(dev), d)  # noqa: E731
    t0 = time.perf_counter()
    for m in mons[1:]:
      yc = [held, held_y]
      dc = m._figure_data(m._reduce(yc, tuple(to(d, DEVICE) for d in pX),
                                    to(qZ, DEVICE)), yc)
      yh = [held.cpu(), held_y.cpu()]
      dh = m._figure_data(m._reduce(yh, pX, qZ), yh)
      _same_figure_data(type(m).__name__, dc, dh,
                        _first(qZ).mean().numpy())
    torch.cuda.synchronize()
    mon_s = time.perf_counter() - t0
    del fresh, pX, qZ
  finally:
    shutil.rmtree(root, ignore_errors=True)
  log(f"[22c monitors] SISUA 1 epoch ({CELLS} × {GENES}) with "
      f"LearningCurves, ScatterPlot and HeatmapPlot (in their "
      f"figure_data blocks) {fit_s:.2f} s, firings {fired}; their data "
      f"steps over a served prediction of the {HELD_OUT} held-out cells "
      f"equal to the CPU's ({mon_s:.2f} s)")
  # 22d: the renders refuse without matplotlib, before any work
  import importlib.util
  present = importlib.util.find_spec("matplotlib") is not None
  saved = sys.modules.get("matplotlib")
  if present:
    sys.modules["matplotlib"] = None  # the card case, made here
  try:
    for what, run in (("plot_all", lambda: post.plot_all(full=True)),
                      ("sisua-evaluate", lambda: __import__(
                          "sisua_tpu_torch.cli.evaluate", fromlist=["main"])
                       .main(["-model", "sisua", "--device", DEVICE]))):
      try:
        run()
        raise RuntimeError(f"check failed: {what} ran without matplotlib")
      except ImportError as e:
        check("matplotlib" in str(e), f"{what}: {e}")
  finally:
    if present:
      if saved is None:
        del sys.modules["matplotlib"]
      else:
        sys.modules["matplotlib"] = saved
  check(not post.figures, "a figure was drawn")
  total_s = time.perf_counter() - t_phase
  log(f"[22d renders] plot_all and sisua-evaluate without --no-plots stop "
      f"with an ImportError naming matplotlib (matplotlib "
      f"{'installed, blocked for the check' if present else 'absent'})")
  log(f"[22 figures] phase 22 {total_s:.1f} s (budget {FIG_BUDGET_S:.0f} "
      f"s{', OVER' if total_s > FIG_BUDGET_S else ''}); main-path launches "
      f"{launches} (the battery and sheet, the monitors' epoch)")
  return launches


def phase_data_analysis(torch, x, y):
  """Phase 20: the data analyzer on 8,192 × 33,000 planted counts with 10
  proteins, every method through ``SingleCellOMIC`` on the card, timed,
  with peak memory; each held against the port's own CPU path on a
  2,048-cell subset (every 4th cell) run through the same steps."""
  import numpy as np
  from sisua_tpu_torch.analysis.estimators import adjusted_rand_score
  from sisua_tpu_torch.analysis.stats import mutual_info_regression
  from sisua_tpu_torch.data.umap_impl import fit_umap, fuzzy_simplicial_set
  from sisua_tpu_torch.ops.knn_mi import knn_mutual_information
  t_phase = time.perf_counter()
  full, groups = _p20_container(torch, x, y)
  card = full[::P20_CHECK_STEP]
  cpu = full[::P20_CHECK_STEP]
  rows = {}
  C = dict(device="cpu")
  log(f"[20 analysis] {full.n_obs} × {full.n_vars} counts, "
      f"{full.get_dim('proteomic')} proteins, {DE_GROUPS} planted groups "
      f"(16b's); the CPU check on {card.n_obs} cells; tolerances "
      + ", ".join(f"{k} {v:g}" for k, v in P20_TOL.items()))

  # QC, HVG, normalize
  _p20_run(torch, rows, "calculate_quality_metrics",
           full.calculate_quality_metrics)
  card.calculate_quality_metrics()
  cpu.calculate_quality_metrics(**C)
  for k in ("n_vars_by_counts", "total_counts",
            "pct_counts_in_top_50_vars"):
    _p20_close(f"QC obs {k}", card.obs[f"transcriptomic_{k}"],
               cpu.obs[f"transcriptomic_{k}"], P20_TOL["float32"])
  for k in ("n_cells_by_counts", "total_counts", "mean_counts",
            "pct_dropout_by_counts"):
    _p20_close(f"QC var {k}", card.get_var()[k], cpu.get_var()[k],
               P20_TOL["float32"])
  _p20_run(torch, rows, "filter_highly_variable_genes",
           lambda: full.filter_highly_variable_genes(n_top_genes=P20_HVG))
  check(full.n_vars == P20_HVG, f"HVG kept {full.n_vars}")
  card.filter_highly_variable_genes(n_top_genes=P20_HVG)
  cpu.filter_highly_variable_genes(n_top_genes=P20_HVG, **C)
  _p20_equal("HVG selection", card.get_var_names(), cpu.get_var_names())
  counts = full.copy()   # phase 21's baselines: the HVGs at counts
  _p20_run(torch, rows, "normalize(total, log1p)",
           lambda: full.normalize(total=True, log1p=True))
  card.normalize(total=True, log1p=True)
  cpu.normalize(total=True, log1p=True, **C)
  _p20_close("normalize", card.numpy(), cpu.numpy(), P20_TOL["float32"])
  # each later step is held on one input (log1p differs in the last bit)
  cpu.set_omic("transcriptomic", card.numpy())

  # PCA (incremental: 8,192 > 4,096 rows), UMAP on 50 PCs
  pca = _p20_run(torch, rows, "dimension_reduce(pca, 100) [IncrementalPCA]",
                 lambda: full.dimension_reduce(n_components=P20_PCS))
  check(type(full.uns["transcriptomic_pca_model"]).__name__
        == "IncrementalPCA" and np.isfinite(pca).all(),
        "the full PCA is incremental and finite")
  a = card.dimension_reduce(n_components=P20_PCS)
  b = cpu.dimension_reduce(n_components=P20_PCS, **C)
  mc, mh = (c.uns["transcriptomic_pca_model"] for c in (card, cpu))
  _p20_close(f"PCA ({mh.svd_solver_}) singular values",
             mc.singular_values_.cpu(), mh.singular_values_,
             P20_TOL["pca_sv"])
  # float32 randomized SVDs: cuSOLVER's and LAPACK's LU power iterations
  # turn components whose singular values lie close within their plane
  _p20_close("PCA scores, leading 3 columns", a[:, :3], b[:, :3],
             P20_TOL["pca"], scale=np.abs(b[:, :3]).max(0))
  worst = np.abs(a - b).max(0) / np.abs(b).max(0)
  log(f"[20 analysis] PCA scores, all {a.shape[1]} columns (not held): "
      f"worst {worst.max():.2e} of the range at column {worst.argmax()}")
  cpu.obsm["transcriptomic_pca"] = a.copy()   # downstream: one embedding
  emb = _p20_run(torch, rows, "dimension_reduce(umap) on 50 PCs",
                 lambda: full.dimension_reduce(algo="umap"))
  check(emb.shape == (full.n_obs, 3) and np.isfinite(emb).all(),
        f"UMAP {emb.shape}")
  Wc = fuzzy_simplicial_set(a[:, :50])
  Wh = fuzzy_simplicial_set(a[:, :50], **C)
  _p20_equal("UMAP graph edges", np.stack([Wc.row, Wc.col]),
             np.stack([Wh.row, Wh.col]))
  _p20_close("UMAP graph weights", Wc.data, Wh.data, P20_TOL["graph"])
  import sisua_tpu_torch.data.umap_impl as umap_impl
  init = umap_impl._spectral_init(Wh.tocsr(), 3, 8, device="cpu")
  init_c = umap_impl._spectral_init(Wh.tocsr(), 3, 8)
  _p20_close("UMAP spectral start", init_c, init, P20_TOL["umap_start"],
             scale=1.0)
  # the SGD from one graph and start (where the start's eigenspace is
  # degenerate, either LU picks its basis arbitrarily). The float32 power
  # differs in the last bit between the card and the CPU, and the
  # repulsion, clipped at ±4 where two points nearly meet, amplifies that
  # in a few coordinates: held by the 99th percentile and the largest
  umap_impl.fuzzy_simplicial_set = lambda *args, **kw: Wh
  spectral_init = umap_impl._spectral_init
  umap_impl._spectral_init = lambda *args, **kw: init.copy()
  try:
    d = np.abs(fit_umap(a[:, :50], 3, n_epochs=1)
               - fit_umap(a[:, :50], 3, n_epochs=1, **C)).ravel()
  finally:
    umap_impl.fuzzy_simplicial_set = fuzzy_simplicial_set
    umap_impl._spectral_init = spectral_init
  p99 = float(np.quantile(d, 0.99))
  check(p99 <= P20_TOL["umap_p99"] and d.max() <= P20_TOL["umap_max"],
        f"UMAP one SGD epoch: card vs CPU 99th percentile {p99:.2e}, "
        f"largest {d.max():.2e}")
  log(f"[20 analysis] UMAP one SGD epoch from the CPU's graph and start: "
      f"card vs CPU median {np.median(d):.2e}, 99th percentile {p99:.2e} "
      f"(bound {P20_TOL['umap_p99']:g}), largest {d.max():.2e} (bound "
      f"{P20_TOL['umap_max']:g}), absolute on a ±10 layout")

  # neighbours, Louvain, the clusterings matched to the groups
  g = _p20_run(torch, rows, "neighbors", full.neighbors)
  gc, gh = card.neighbors(), cpu.neighbors(**C)
  _p20_equal("neighbors indices", gc["distances"].indices,
             gh["distances"].indices)
  _p20_close("neighbors distances", gc["distances"].data,
             gh["distances"].data, P20_TOL["graph"])
  ids = _p20_run(torch, rows, "louvain", full.louvain)
  _p20_equal("louvain", card.louvain(), cpu.louvain(**C))
  log(f"[20 analysis] louvain: {len(np.unique(ids))} communities of "
      f"{g['n_neighbors']}-NN graph")
  for algo in ("kmeans", "gmm", "agglomerative", "spectral"):
    ids = _p20_run(torch, rows, f"clustering({algo})",
                   lambda: full.clustering(algo=algo,
                                           matching_labels="celltype"))
    got = card.clustering(algo=algo, matching_labels="celltype")
    want = cpu.clustering(algo=algo, matching_labels="celltype", **C)
    ari = adjusted_rand_score(got, want, device="cpu")
    check(ari == 1.0, f"clustering({algo}) card vs CPU ARI {ari}")
    log(f"[20 analysis] clustering({algo}): card vs CPU ARI 1; "
        f"{np.mean(np.asarray(ids) == groups):.4f} of the {full.n_obs:,} "
        f"cells in their planted (Hungarian-matched) group")

  # rank tests, correlations
  for method in ("t-test", "wilcoxon"):
    res = _p20_run(torch, rows, f"rank_vars_groups({method})",
                   lambda: full.rank_vars_groups(method=method))
    check(len(res) == DE_GROUPS, f"rank groups {list(res)}")
    got = card.rank_vars_groups(method=method)
    want = cpu.rank_vars_groups(method=method, **C)
    for grp in want:
      _p20_equal(f"rank {method} {grp} names", got[grp]["names"],
                 want[grp]["names"])
      _p20_close(f"rank {method} {grp} scores", got[grp]["scores"],
                 want[grp]["scores"], P20_TOL["float32"])
      _p20_close(f"rank {method} {grp} p-values", got[grp]["pvals"],
                 want[grp]["pvals"], P20_TOL["float32"])
  corr = _p20_run(torch, rows, "get_correlation", full.get_correlation)
  check(len(corr) == P20_HVG * PROTEINS, f"{len(corr)} pairs")
  cc = {k[:2]: k[2:] for k in card.get_correlation()}
  ch = {k[:2]: k[2:] for k in cpu.get_correlation(**C)}
  keys = sorted(ch)
  _p20_close("pearson", [cc[k][0] for k in keys], [ch[k][0] for k in keys],
             P20_TOL["pearson"], scale=1.0)
  _p20_close("spearman", [cc[k][1] for k in keys], [ch[k][1] for k in keys],
             P20_TOL["spearman"], scale=1.0)

  # mutual information, both backends, 2,000 HVGs × 10 proteins
  log(f"[20 analysis] get_mutual_information: cut: cells {full.n_obs:,} "
      f"→ {P20_MI_CELLS:,} (max_cells, a seeded subsample)")
  for backend in ("sklearn", "jax"):
    # both backends share the JAX cache key: drop the first's entry
    full.uns.pop(f"transcriptomic_proteomic_mutualinfo_sub{P20_MI_CELLS}",
                 None)
    mi = _p20_run(torch, rows, f"get_mutual_information({backend})",
                  lambda: full.get_mutual_information(
                      backend=backend, max_cells=P20_MI_CELLS))
    vals = np.stack([mi[p] for p in full.get_var_names("proteomic")])
    check(vals.shape == (PROTEINS, P20_HVG) and np.isfinite(vals).all()
          and (vals >= 0).all(), f"MI {backend} {vals.shape}")
  X = card.numpy()[:, :P20_MI_CPU_GENES].astype(np.float64)
  Y = card.numpy("proteomic").astype(np.float64)
  for j in range(PROTEINS):
    _p20_close(f"MI sklearn protein {j}",
               mutual_info_regression(X, Y[:, j], random_state=8),
               mutual_info_regression(X, Y[:, j], random_state=8, **C),
               P20_TOL["mi_sklearn"], scale=1.0)
  _p20_close("MI jax", knn_mutual_information(X, Y),
             knn_mutual_information(X, Y, **C), P20_TOL["mi_jax"],
             scale=1.0)

  # random-forest importances on the most variable genes (the trees grow
  # on the host), at the largest tree count the budget leaves: one tree a
  # protein first, which sets the count
  imp_sco = full.copy()
  n_imp = min(P20_IMP_GENES, full.n_vars)
  top = np.argsort(-imp_sco.numpy().var(0))[:n_imp]
  imp_sco.apply_indices(np.sort(top), observation=False)
  ncpu = min(PROTEINS, len(os.sched_getaffinity(0)))
  imp = _p20_run(torch, rows, "get_importance_matrix(1 tree)",
                 lambda: imp_sco.get_importance_matrix(n_estimators=1,
                                                       ncpu=ncpu))
  t_one = rows["get_importance_matrix(1 tree)"]
  left = P20_BUDGET - sum(rows.values())
  trees = int(max(1, min(P20_TREES_MAX, left // (t_one * 1.25))))
  log(f"[20 analysis] get_importance_matrix: cut: genes {full.n_vars:,} "
      f"→ {n_imp} (the most variable), n_estimators {P20_TREES_MAX} "
      f"→ {trees} ({ncpu} spawned processes for {PROTEINS} proteins; "
      f"{left:.1f} s of the {P20_BUDGET:.0f} s budget left after one "
      f"tree a protein)")
  if trees > 1:
    imp_sco.uns.clear()
    imp = _p20_run(torch, rows, f"get_importance_matrix({trees} trees)",
                   lambda: imp_sco.get_importance_matrix(n_estimators=trees,
                                                         ncpu=ncpu))
  vals = np.stack([imp[p] for p in full.get_var_names("proteomic")])
  check(vals.shape == (PROTEINS, n_imp) and np.isfinite(vals).all()
        and np.allclose(vals.sum(1), 1.0),
        "importances finite, each protein's summing to 1")
  small = card[:512]
  small.apply_indices(np.arange(100), observation=False)
  _p20_equal("importances on 512 cells × 100 genes, 2 trees",
             np.stack(list(small.get_importance_matrix(
                 n_estimators=2, ncpu=ncpu).values())[1:]),
             np.stack(list(small.copy().get_importance_matrix(
                 n_estimators=2, ncpu=1).values())[1:]),
             what=f"{ncpu} processes equal to one")
  total = sum(rows.values())
  log(f"[20 analysis] card-side methods {total:.1f} s of the "
      f"{P20_BUDGET:.0f} s budget; phase 20 in "
      f"{time.perf_counter() - t_phase:.1f} s")
  check(total <= P20_BUDGET, f"phase 20's methods took {total:.1f} s")
  return full, counts


# phase 21: the classical baselines and t-SNE
P21_COMPONENTS = 10      # run_baseline's n_components (the JAX default)
P21_BUDGET = 180.0       # seconds of the phase, its CPU checks included
# (b)'s and (c)'s t-SNEs on every 2nd cell: the host's forces set their
# time (74.7 and 14.8 s on all 8,192 cells on a slow host)
P21_TSNE_STEP = 2
P21_TRUST_K = 12         # trustworthiness's n_neighbors
P21_TOL = {              # card vs CPU on every 4th cell
    # float32 SVDs: cuSOLVER's and LAPACK's power iterations turn close
    # components within their plane (phase 20): the leading 3 columns
    "pca": 1e-2, "ppca": 1e-2,
    "fa": 1e-6,          # float64 throughout
    "nmf": 1e-2,         # from an SVD start that moves as PCA's does
    "sppca": 5e-2,       # float32 LARS steps and a float32 stopping test
    "P": 1e-7,           # of the largest joint probability
    "forces": 1e-6,      # of the largest |force|, one OpenMP thread
    "kl": 0.02}          # relative, two default runs


def _p21_gap(a, b, cols=None):
  """The largest |a − b| of each column over the column's largest |b|."""
  import numpy as np
  a = np.asarray(a, np.float64)[:, :cols]
  b = np.asarray(b, np.float64)[:, :cols]
  return float(np.max(np.abs(a - b).max(0) / np.maximum(
      np.abs(b).max(0), 1e-300)))


def _p21_kl(torch, X, emb, dof):
  """The Barnes-Hut KL divergence of ``emb`` under the P of X (what
  t-SNE reports as ``kl_divergence_`` at its last iteration)."""
  from sisua_tpu_torch import native
  from sisua_tpu_torch.analysis import manifold as M
  k = min(X.shape[0] - 1, 91)
  indptr, indices, P = M._joint_probabilities_nn(*M._kneighbors(X, k),
                                                 30.0)
  return native.tsne_gradient(P.float().cpu().numpy(), emb,
                              indices.cpu().numpy(), indptr.cpu().numpy(),
                              dof=dof)[0]


def phase_baselines_tsne(torch, full, counts, z):
  """Phase 21: the classical baselines on phase 20's planted counts at its
  2,000 HVGs, t-SNE through the container and through ``utils``, and the
  card against the CPU on 2,048 cells."""
  import numpy as np
  from sisua_tpu_torch import baselines, native, utils
  from sisua_tpu_torch.analysis import manifold as M
  t_phase = time.perf_counter()
  log(f"[21 baselines] {counts.n_obs} × {counts.n_vars} counts, "
      f"{counts.get_dim('proteomic')} proteins, {DE_GROUPS} planted groups "
      f"as celltype; cut: genes 33,000 → {counts.n_vars:,} (phase 20's "
      f"HVGs: the set users compare baselines on, and sparse PCA's 1,000 "
      f"dictionary iterations over 33,000 genes would not fit the run); "
      f"n_components {P21_COMPONENTS}; tolerances "
      + ", ".join(f"{k} {v:g}" for k, v in P21_TOL.items()))
  x_sub = np.log1p(counts.numpy()[::P20_CHECK_STEP])
  t_cpu = 0.0
  for model in baselines.BASELINE_MODELS:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    scores = baselines.run_baseline(counts, model,
                                    n_components=P21_COMPONENTS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check({"ARI_celltype", "f1_F1micro"} <= set(scores)
          and all(np.isfinite(v) for v in scores.values()),
          f"run_baseline({model}) scores {scores}")
    fc = baselines._fit_latent(x_sub, model, P21_COMPONENTS, 8)
    zc = fc.transform(x_sub).cpu().numpy()
    t1 = time.perf_counter()
    fh = baselines._fit_latent(x_sub, model, P21_COMPONENTS, 8,
                               device="cpu")
    zh = fh.transform(x_sub).cpu().numpy()
    t_cpu += time.perf_counter() - t1
    check(np.isfinite(zc).all() and zc.shape == zh.shape,
          f"{model} latents {zc.shape}")
    held = 3 if model in ("pca", "ppca") else None
    gap = _p21_gap(zc, zh, held)
    check(gap <= P21_TOL[model], f"{model}: card vs CPU latents {gap:.2e} "
          f"beyond {P21_TOL[model]:g}")
    log(f"[21 baselines] run_baseline({model}): {sec:.3f} s on the card, "
        f"peak {peak:.3f} GiB above the resident; keys "
        f"{','.join(sorted(scores))}; ARI_celltype "
        f"{scores['ARI_celltype']:.4f}, f1_F1micro "
        f"{scores['f1_F1micro']:.4f}; card vs CPU on {len(x_sub)} cells: "
        f"latents {'(leading 3) ' if held else ''}{gap:.2e} of each "
        f"column's range (bound {P21_TOL[model]:g}), all columns "
        f"{_p21_gap(zc, zh):.2e}"
        + (f", n_iter {fc.n_iter_} / {fh.n_iter_}"
           if hasattr(fc, "n_iter_") else ""))

  log(f"[21 baselines] the five in {time.perf_counter() - t_phase:.1f} s, "
      f"{t_cpu:.1f} s of it the CPU's fits on {len(x_sub)} cells")

  # (b) t-SNE through the container, on phase 20's cached PCs (of every
  # P21_TSNE_STEP-th cell)
  pcs = full.obsm["transcriptomic_pca"][:, :50]
  part = full[np.arange(0, full.n_obs, P21_TSNE_STEP)]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  emb = part.dimension_reduce(algo="tsne")
  torch.cuda.synchronize()
  sec = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  check(emb.shape == (part.n_obs, 3) and np.isfinite(emb).all()
        and "transcriptomic_tsne" in part.obsm, f"t-SNE {emb.shape}")
  X = torch.as_tensor(pcs[::P21_TSNE_STEP], device=DEVICE)
  kl = _p21_kl(torch, X, emb, 2)
  tw = M.trustworthiness(X, emb, n_neighbors=P21_TRUST_K)
  # the planted groups are faint in 50 PCs: t-SNE must keep more of each
  # cell's neighbourhood than the linear 3-D projection does
  tw_pca = M.trustworthiness(X, pcs[::P21_TSNE_STEP, :3],
                             n_neighbors=P21_TRUST_K)
  log(f"[21 tsne] dimension_reduce(algo='tsne'): {part.n_obs} cells (cut: "
      f"every {P21_TSNE_STEP}nd of {full.n_obs}) × 3 "
      f"components on 50 PCs: {sec:.3f} s (neighbours, P and the descent "
      f"on the card, the octree's forces on {os.cpu_count()} host CPUs), "
      f"peak {peak:.3f} GiB; KL {kl:.4f}; trustworthiness (k = "
      f"{P21_TRUST_K}) {tw:.4f}, the first 3 PCs' {tw_pca:.4f}")
  check(np.isfinite(kl) and tw > tw_pca, f"t-SNE KL {kl}, trustworthiness "
        f"{tw} (the first 3 PCs' {tw_pca})")

  # (c) t-SNE through utils, on 16b's SCVI latent means (every
  # P21_TSNE_STEP-th cell's)
  z = np.asarray(z)[::P21_TSNE_STEP]
  t0 = time.perf_counter()
  e2 = utils.dimension_reduction(z, "tsne", 2)
  torch.cuda.synchronize()
  sec2 = time.perf_counter() - t0
  Z = torch.as_tensor(np.asarray(z, np.float32), device=DEVICE)
  tw2 = M.trustworthiness(Z, e2, n_neighbors=P21_TRUST_K)
  tw2_pca = M.trustworthiness(Z, utils.dimension_reduction(z, "pca", 2),
                              n_neighbors=P21_TRUST_K)
  check(e2.shape == (len(z), 2) and np.isfinite(e2).all()
        and tw2 > tw2_pca, f"utils t-SNE {e2.shape}, trustworthiness {tw2}"
        f" (PCA's {tw2_pca})")
  log(f"[21 tsne] utils.dimension_reduction(z, 'tsne', 2): {len(z)} SCVI "
      f"latent means × {z.shape[1]} (the kd-tree's exact neighbours, the "
      f"quadtree): {sec2:.3f} s; KL {_p21_kl(torch, Z, e2, 1):.4f}; "
      f"trustworthiness {tw2:.4f}, 2-D PCA's {tw2_pca:.4f}")

  # (d) card against CPU on every 4th cell
  Xs = pcs[::P20_CHECK_STEP]
  k = 91
  parts = {}
  for dev in (DEVICE, "cpu"):
    Xd = torch.as_tensor(Xs, device=dev)
    idx, d = M._kneighbors(Xd, k)
    parts[dev] = (idx.cpu(), d.cpu()) + tuple(
        t.cpu() for t in M._joint_probabilities_nn(idx, d, 30.0))
  (ic, dc, pc, nc, vc), (ih, dh, ph, nh, vh) = parts[DEVICE], parts["cpu"]
  moved = int((ic != ih).sum())
  check(moved == 0 and torch.equal(pc, ph) and torch.equal(nc, nh),
        f"t-SNE neighbours: {moved} indices differ")
  dgap = float(torch.max(torch.abs(dc - dh) / dh.clamp(min=1e-300)))
  pgap = float(torch.max(torch.abs(vc - vh))) / float(vh.max())
  check(pgap <= P21_TOL["P"], f"t-SNE P: card vs CPU {pgap:.2e}")
  start = M.TSNE(3, random_state=8, device="cpu")._start(
      torch.as_tensor(Xs), np.random.RandomState(8)).numpy()
  start_c = M.TSNE(3, random_state=8)._start(
      torch.as_tensor(Xs, device=DEVICE), np.random.RandomState(8))
  forces = [native.tsne_gradient((v * 12.0).float().numpy(), start,
                                 n.numpy(), p.numpy(), dof=2,
                                 num_threads=1)[1]
            for v, n, p in ((vc, nc, pc), (vh, nh, ph))]
  fgap = float(np.abs(forces[0] - forces[1]).max()
               / np.abs(forces[1]).max())
  check(fgap <= P21_TOL["forces"], f"t-SNE first forces {fgap:.2e}")
  runs = {}
  for dev in (DEVICE, "cpu"):
    t0 = time.perf_counter()
    m = M.TSNE(3, random_state=8, device=dev)
    m.fit_transform(Xs)
    runs[dev] = (m.kl_divergence_, time.perf_counter() - t0)
  klgap = abs(runs[DEVICE][0] - runs["cpu"][0]) / runs["cpu"][0]
  check(klgap <= P21_TOL["kl"], f"t-SNE final KL card {runs[DEVICE][0]} "
        f"vs CPU {runs['cpu'][0]}")
  log(f"[21 tsne] card vs CPU on {len(Xs)} cells: neighbour indices equal, "
      f"distances worst rel {dgap:.2e}; P structure equal, values "
      f"{pgap:.2e} of the largest (bound {P21_TOL['P']:g}); the PCA start "
      f"{_p21_gap(start_c.cpu().numpy(), start):.2e} of each column's "
      f"range; first forces from the CPU's start at one OpenMP thread "
      f"{fgap:.2e} of the largest (bound {P21_TOL['forces']:g}); default "
      f"runs: KL card {runs[DEVICE][0]:.5f} ({runs[DEVICE][1]:.1f} s), CPU "
      f"{runs['cpu'][0]:.5f} ({runs['cpu'][1]:.1f} s), {klgap:.2%} apart "
      f"(bound {P21_TOL['kl']:.0%})")
  total = time.perf_counter() - t_phase
  log(f"[21] phase 21 in {total:.1f} s (budget {P21_BUDGET:.0f} s)")
  check(total <= P21_BUDGET, f"phase 21 took {total:.1f} s")


# phase 18: the experiment path (SISUA_EXP → a temporary directory)
EXP_CLI = ("model.name=sisua", "dataset.name=synthetic10k",
           "dataset.batch_size=128", "train.epochs=3", "train.valid_freq=0")
EXP_CLI_CELLS, EXP_CLI_GENES = 10_000, 500   # the registry's synthetic10k
EXP_CLI_DRAWS = 2            # predict's --sample-shape
# evaluate scores the model on another registry set of the same genes: the
# test split of synthetic2k, 400 cells (cli.train scored synthetic10k's)
EXP_EVAL_DS = "synthetic2k"
EXP_WIDE = {"model.name": "sisua", "dataset.name": "wide33k",
            "dataset.batch_size": BATCH, "train.epochs": 4}
EXP_SPLIT = 0.8              # phase 18b's train_percent
EXP_TIMEOUT = 600            # seconds for each CLI call
HYPER_EVALS = 4


def _cli(args, env):
  """``python -m <args>`` as a user runs it, from the checkout's root;
  its output's last lines are logged, a non-zero exit fails the phase."""
  t0 = time.perf_counter()
  proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=EXP_TIMEOUT)
  secs = time.perf_counter() - t0
  tail = (proc.stdout + proc.stderr).strip().splitlines()[-4:]
  for line in tail:
    log(f"[18 experiment]   | {line[:200]}")
  check(proc.returncode == 0,
        f"{args[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
  return proc.stdout, secs


def _finite_rows(sb, table, n_uids):
  """The scoreboard table's rows: ``n_uids`` of them, every value
  finite, and no error row."""
  import math
  rows = sb.read_scores(table)
  check(len(rows) == n_uids, f"{table}: {len(rows)} uids, want {n_uids}")
  bad = {u: [k for k, v in r.items() if not math.isfinite(v)]
         for u, r in rows.items()}
  check(not any(bad.values()), f"{table}: non-finite scores {bad}")
  errors = sb.read_errors()
  check(errors == [], f"scoreboard errors: "
        f"{[(e['uid'], e['message'][:300]) for e in errors]}")
  return rows


def phase_experiment_cli(root):
  """18a: ``cli.train`` on the registry's synthetic10k as a user runs it,
  then ``cli.predict`` on the model it saved and ``cli.evaluate``."""
  import numpy as np
  from sisua_tpu_torch.train.scoreboard import ScoreBoard
  env = dict(os.environ, SISUA_EXP=root)
  # the CLIs' default device is 'cuda'; a rehearsal elsewhere passes its own
  dev = [] if DEVICE == "cuda" else ["--device", DEVICE]
  out, train_s = _cli(["sisua_tpu_torch.cli.train", *EXP_CLI, *dev], env)
  device = [ln for ln in out.splitlines() if ln.startswith(" - device")]
  check(device and DEVICE in device[0], f"train printed {device}")
  dirs = [d for d in os.listdir(root) if d.startswith("sisua_synthetic10k_")]
  check(len(dirs) == 1, f"experiment dirs {os.listdir(root)}")
  exp_dir = os.path.join(root, dirs[0])
  for f in ("config.yaml", "model/metamodel.json", "scores.json"):
    check(os.path.isfile(os.path.join(exp_dir, f)), f"{f} missing")
  sb = ScoreBoard(os.path.join(root, "scoreboard.db"))
  rows = _finite_rows(sb, "scores_synthetic10k", 1)
  with open(os.path.join(exp_dir, "scores.json")) as f:
    keys = set(json.load(f))
  check(keys <= set(rows[dirs[0]]), "scores.json keys not on the board")
  log(f"[18a experiment] cli.train: {train_s:.1f} s, {device[0].strip()}, "
      f"{dirs[0]}: {len(keys)} posterior scores, {len(rows[dirs[0]])} on "
      "the scoreboard with the criticizers', all finite, no error row")
  pred, ev = os.path.join(root, "predict"), os.path.join(root, "evaluate")
  with ThreadPoolExecutor(2) as pool:  # both only read the saved model
    predicting = pool.submit(
        _cli, ["sisua_tpu_torch.cli.predict", os.path.join(exp_dir, "model"),
               "synthetic10k", "-o", pred, "--sample-shape",
               str(EXP_CLI_DRAWS), *dev], env)
    evaluating = pool.submit(
        _cli, ["sisua_tpu_torch.cli.evaluate", "-model", "sisua", "-ds",
               "synthetic10k", "-ds2", EXP_EVAL_DS, "--no-plots", "-path",
               ev, *dev], env)
    (_, pred_s), (_, eval_s) = predicting.result(), evaluating.result()
  with open(os.path.join(pred, "manifest.json")) as f:
    manifest = json.load(f)
  want = [[EXP_CLI_CELLS, EXP_CLI_GENES], [EXP_CLI_CELLS, PROTEINS],
          [EXP_CLI_CELLS, 7]]
  check(manifest["model"] == "SISUA" and manifest["n_cells"] == EXP_CLI_CELLS
        and manifest["outputs"] == want
        and manifest["latents"] == [[EXP_CLI_CELLS, 12]],
        f"predict manifest {manifest}")
  with np.load(os.path.join(pred, "imputed.npz")) as z:
    check(all(np.isfinite(z[k]).all() for k in z), "imputed not finite")
  uid = f"sisua_{EXP_EVAL_DS}"
  erows = _finite_rows(sb, f"eval_{EXP_EVAL_DS}", 1)
  check(list(erows) == [uid], f"eval rows {list(erows)}")
  check(os.path.isfile(os.path.join(ev, "scores.csv")), "no scores.csv")
  sb.close()
  log(f"[18a experiment] at once: cli.predict {pred_s:.1f} s, outputs "
      f"{manifest['outputs']}; cli.evaluate -ds2 {EXP_EVAL_DS} --no-plots "
      f"{eval_s:.1f} s, {len(erows[uid])} scores in eval_{EXP_EVAL_DS}")


def _wide_data():
  """18b's data: the port's generator at 8,192 × 33,000 × 10 proteins, on
  the host; (container, seconds)."""
  from sisua_tpu_torch.data import generate_synthetic
  t0 = time.perf_counter()
  sco = generate_synthetic(n_cells=CELLS, n_genes=GENES, n_proteins=PROTEINS)
  return sco, time.perf_counter() - t0


def phase_experiment_wide(torch, root, sco, data_s):
  """18b: ``SisuaExperimenter.run_config`` of SISUA on ``sco``, the port's
  ``generate_synthetic`` at 8,192 × 33,000 × 10 proteins made in
  ``data_s`` seconds (the base.yaml variables: 'zinbd' RNA, 'nb'
  proteins, the one-hot cell types), split 0.8, batch 512, 4 epochs.
  Returns its ZINB launches."""
  import numpy as np
  from sisua_tpu_torch.ops import zinb as tz
  from sisua_tpu_torch.train.experimenter import SisuaExperimenter

  class Wide(SisuaExperimenter):
    def on_load_data(self, cfg):
      self.seconds = {"data": data_s}
      train, test = sco.split(EXP_SPLIT)
      return {"sco": sco, "train": train, "test": test}

    def on_train(self, cfg, exp_dir, model, data):
      t0 = time.perf_counter()
      super().on_train(cfg, exp_dir, model, data)
      torch.cuda.synchronize()
      self.seconds["train"] = time.perf_counter() - t0
      self.model = model

    def on_eval(self, cfg, exp_dir, model, data):
      """``on_eval`` with its posterior, ``save_scores`` and criticizers
      timed apart."""
      import sisua_tpu_torch.train.experimenter as X
      from sisua_tpu_torch.analysis import Criticizer, Posterior
      spent = dict.fromkeys(("posterior", "save_scores", "criticizers"), 0.0)

      def timed(fn, key):
        def run(*a, **k):
          torch.cuda.synchronize()
          t = time.perf_counter()
          try:
            return fn(*a, **k)
          finally:
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
        return run

      patches = ((X, "sco_posterior", "posterior"),
                 (Posterior, "save_scores", "save_scores"),
                 (Criticizer, "cal_all_scores", "criticizers"))
      saved = [(o, n, getattr(o, n)) for o, n, _ in patches]
      for o, n, key in patches:
        setattr(o, n, timed(getattr(o, n), key))
      t0 = time.perf_counter()
      try:
        scores = super().on_eval(cfg, exp_dir, model, data)
      finally:
        for o, n, fn in saved:
          setattr(o, n, fn)
      self.seconds["eval"] = time.perf_counter() - t0
      self.seconds.update(spent)
      return scores

  exp = Wide(save_path=os.path.join(root, "wide"), device=DEVICE)
  cfg = exp.load_config(EXP_WIDE)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  tz.reset_launches()
  t0 = time.perf_counter()
  scores = exp.run_config(cfg)
  total_s = time.perf_counter() - t0
  launches = dict(tz.launches)
  peak = torch.cuda.max_memory_allocated() / 2**30
  model = exp.model
  h = model.history
  losses = np.asarray(h["loss"])
  check(len(losses) == EXP_WIDE["train.epochs"] and np.isfinite(losses).all()
        and "val_loss" in h, f"losses {losses}, history {sorted(h)}")
  check(model.outputs[0].dim == GENES and len(model.outputs) == 3,
        f"outputs {model.outputs}")
  check(launches["zinb_rowsum_fwd"] > 0 and launches["zinb_rowsum_bwd"] > 0,
        f"launches {launches}")
  rows = _finite_rows(exp.scoreboard, "scores_wide33k", 1)
  steps = model.step // len(losses)
  step_ms = float(np.median(h["epoch_time"][1:])) / steps * 1e3
  log(f"[18b experiment] SISUA {CELLS} × {GENES} × {PROTEINS} proteins "
      f"through run_config: data {exp.seconds['data']:.1f} s on the host "
      "(beside 18a, c, d), "
      f"train {exp.seconds['train']:.1f} s ({model.step} steps, steady "
      f"{step_ms:.3f} ms a step, loss {losses[0]:.1f} → {losses[-1]:.1f}, "
      f"val_loss {h['val_loss'][-1]:.1f}), on_eval "
      f"{exp.seconds['eval']:.1f} s (posterior "
      f"{exp.seconds['posterior']:.1f}, save_scores "
      f"{exp.seconds['save_scores']:.1f}, criticizers "
      f"{exp.seconds['criticizers']:.1f}), run_config {total_s:.1f} s; peak "
      f"{peak:.2f} GiB; launches {launches}; {len(scores)} scores, "
      f"{len(rows[next(iter(rows))])} on the board, no error row")
  del exp.model, model
  torch.cuda.empty_cache()
  return launches


def phase_experiment_multi(root):
  """18c: multirun of VAE and DCA in two spawned processes sharing the
  card."""
  from sisua_tpu_torch.train.experimenter import SisuaExperimenter
  exp = SisuaExperimenter(save_path=os.path.join(root, "multi"),
                          device=DEVICE)
  t0 = time.perf_counter()
  res = exp.run(["model.name=vae,dca", "dataset.name=synthetic",
                 "train.epochs=1", "train.valid_freq=0", "-m", "--ncpu",
                 "2"])
  multi_s = time.perf_counter() - t0
  check(len(res) == 2 and not any("error" in r for r in res),
        f"multirun results {[r.get('error') for r in res]}")
  _finite_rows(exp.scoreboard, "scores_synthetic", 2)
  log(f"[18c experiment] multirun vae,dca on synthetic, 2 processes on the "
      f"card: {multi_s:.1f} s, 2 scoreboard uids, no error row")


def phase_experiment_hyper():
  """18d: ``fit_hyper`` of SCVI, 4 trials in waves of 2 processes."""
  import numpy as np
  from sisua_tpu_torch.models.hyper_params import fit_hyper
  t0 = time.perf_counter()
  hyper = fit_hyper("scvi", "synthetic", max_evals=HYPER_EVALS, epochs=1,
                    n_processes=2, device=DEVICE)
  hyper_s = time.perf_counter() - t0
  losses = [t["loss"] for t in hyper["trials"]]
  check(len(losses) == HYPER_EVALS and np.isfinite(losses).all()
        and hyper["best"] is not None and not hyper["errors"],
        f"fit_hyper {hyper}")
  log(f"[18d experiment] fit_hyper scvi, {HYPER_EVALS} trials, 2 processes: "
      f"{hyper_s:.1f} s; best {hyper['best']} val_loss {hyper['loss']:.2f}")


def phase_experiment(torch):
  """Phase 18: the experiment entry points on the card, every part with
  ``SISUA_EXP`` in a temporary directory. Returns 18b's launches."""
  # imported here first: threads importing the package at once would meet
  # its import cycles (models ↔ train) as half-initialised modules
  import sisua_tpu_torch.data  # noqa: F401
  import sisua_tpu_torch.models.hyper_params  # noqa: F401
  import sisua_tpu_torch.train.experimenter  # noqa: F401
  root = tempfile.mkdtemp(prefix="chip_smoke_exp_")
  old = os.environ.get("SISUA_EXP")
  os.environ["SISUA_EXP"] = root
  t0 = time.perf_counter()
  try:
    # the CLIs, multirun and fit_hyper run in processes of their own: they
    # share the card beside the host's generator; 18b then runs alone
    with ThreadPoolExecutor(4) as pool:
      data = pool.submit(_wide_data)
      parts = [pool.submit(phase_experiment_cli, os.path.join(root, "cli")),
               pool.submit(phase_experiment_multi, root),
               pool.submit(phase_experiment_hyper)]
      for part in parts:
        part.result()
      sco, data_s = data.result()
    log(f"[18 experiment] 18a, c, d and 18b's data in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = phase_experiment_wide(torch, root, sco, data_s)
    del sco
  finally:
    if old is None:
      os.environ.pop("SISUA_EXP", None)
    else:
      os.environ["SISUA_EXP"] = old
    shutil.rmtree(root, ignore_errors=True)
  log(f"[18 experiment] phase 18 in {time.perf_counter() - t0:.1f} s")
  return launches


P23_EPOCHS = 2
P23_STEPS = 4            # 23b: 4 global batches of BATCH rows
P23_LOSS_RTOL = 1e-6     # 23a: a one-rank mesh against one device
P23_STEP_RTOL = 1e-5     # 23b: each step's loss, 2 × 2 against one device
# 23b: parameters after 4 Adam steps. Where a gradient is small beside its
# rounding error (an entry of a sparse gene, a BatchNorm-fed bias) Adam's
# normalized step turns that error into up to ±lr, so every entry is held
# to 2·lr·steps and each leaf's update, ‖p − p_single‖ / ‖p_single − p₀‖,
# to P23_UPDATE_RTOL (a BatchNorm-fed bias and its running mean to the
# first alone)
P23_UPDATE_RTOL = 0.05
P23_SAMPLE_ROWS = 8      # 23a: predict_mean rows compared whole
P23_BUDGET = 90.0
P23_TIMEOUT = 300


def _p23_record(torch, model):
  """Wraps ``model._train_step`` and ``ClippedOptimizer.step`` to keep
  each step's (global) loss and step 1's pre-clip gradients, the model
  axis's slices gathered; returns (losses, grads, undo)."""
  from sisua_tpu_torch.parallel import functional as PF
  from sisua_tpu_torch.train.trainer import ClippedOptimizer
  losses, grads = [], {}
  step = model._train_step

  def recorded_step(batch, noise=None):
    m = step(batch, noise)
    losses.append(m["loss"].detach())
    return m
  model._train_step = recorded_step
  clipped = ClippedOptimizer.step

  def recorded_clip(opt):
    if not grads:
      split = model._split
      dims = {} if split is None else {id(p): d for _, _, _, p, d
                                       in split.entries}
      for k, p in model.module.named_parameters():
        g = p.grad.detach()
        if id(p) in dims:
          g = PF.all_gather_cat(g, split.view.model_group, dims[id(p)])
        grads[k] = g.clone()
    clipped(opt)
  ClippedOptimizer.step = recorded_clip

  def undo():
    ClippedOptimizer.step = clipped
  return losses, grads, undo


def _p23a_fit(torch, mesh):
  """23a's fit of phase 4's SCVI on phase 4's counts (made again from
  their seed), on ``mesh`` or on one device, and its ``predict_mean``:
  the losses, launches, step ms and the means' row sums and first rows."""
  from sisua_tpu_torch.ops import zinb as tz
  t0 = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
  x = torch.cat([_counts(torch, gen, 1024, GENES)
                 for _ in range(CELLS // 1024)])
  model = _scvi(torch, "full")
  tz.reset_launches()
  model.fit(x, epochs=P23_EPOCHS, batch_size=BATCH, learning_rate=1e-3,
            clipnorm=100.0, device_cache=True, mesh=mesh)
  launches = dict(tz.launches)
  means, _ = model.predict_mean(x, sample_shape=(2,), batch_size=BATCH,
                                mesh=mesh)
  return {"loss": list(model.history["loss"]), "launches": launches,
          "step_ms": model.history["epoch_time"][-1]
          / (CELLS // BATCH) * 1e3,
          "row_sums": means[0].sum(1, dtype="float64"),
          "rows": means[0][:P23_SAMPLE_ROWS].copy(),
          "seconds": time.perf_counter() - t0}


def _p23a_rank():
  """23a in its NCCL rank: phase 4's fit over a 1 × 1 mesh."""
  import torch
  from sisua_tpu_torch.parallel import create_mesh
  return _p23a_fit(torch, create_mesh())


def _p23_counts(torch, rows):
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
  return _counts(torch, gen, rows, GENES)


def _p23b_fit(torch, mesh):
  """23b's fit on one rank's card: the seeded SCVI, 4 global steps."""
  from sisua_tpu_torch.ops import zinb as tz
  from sisua_tpu_torch.parallel import param_plan
  x = _p23_counts(torch, P23_STEPS * BATCH)
  model = _scvi(torch, "full")
  losses, grads, undo = _p23_record(torch, model)
  tz.reset_launches()
  t0 = time.perf_counter()
  try:
    model.fit(x, epochs=1, batch_size=BATCH, learning_rate=1e-3,
              clipnorm=100.0, device_cache=True, mesh=mesh, patience=0)
    torch.cuda.synchronize()
  finally:
    undo()
  seconds = time.perf_counter() - t0
  return {"losses": [float(v) for v in losses], "grads": grads,
          "state": {k: v.detach() for k, v in
                    model.module.state_dict().items()},
          "launches": dict(tz.launches), "seconds": seconds,
          "split": sorted(param_plan(dict(model.module.named_parameters()),
                                     2))}


def _p23b_rank():
  """23b in one of the 4 gloo ranks (all on card 0)."""
  import torch
  import torch.distributed as dist
  from sisua_tpu_torch.parallel import create_mesh
  out = _p23b_fit(torch, create_mesh(2, 2))
  keep = dist.get_rank() == 0
  return {"losses": out["losses"], "launches": out["launches"],
          "seconds": out["seconds"], "split": out["split"],
          "grads": {k: v.cpu().numpy() for k, v in out["grads"].items()}
          if keep else None,
          "state": {k: v.cpu().numpy() for k, v in out["state"].items()}
          if keep else None,
          "digest": float(sum(v.double().abs().sum()
                              for v in out["state"].values()))}


def _check_p23a(torch, single, mesh, a_s):
  import numpy as np
  steps = P23_EPOCHS * (CELLS // BATCH)
  rel = max(abs(m - s) / abs(s) for m, s in zip(mesh["loss"],
                                                 single["loss"]))
  check(np.isfinite(mesh["loss"]).all() and rel <= P23_LOSS_RTOL,
        f"23a losses mesh {mesh['loss']} single {single['loss']}")
  check(mesh["launches"] == {"zinb_rowsum_fwd": steps,
                             "zinb_rowsum_bwd": steps},
        f"23a launches {mesh['launches']} != {steps} steps")
  scale = float(np.abs(single["rows"]).max())
  serve = max(float(np.abs(mesh["rows"] - single["rows"]).max()) / scale,
              float(np.abs(mesh["row_sums"] - single["row_sums"]).max()
                    / np.abs(single["row_sums"]).max()))
  check(serve <= SERVE_RTOL, f"23a predict_mean(mesh=) off by {serve:.2e}")
  log(f"[23a mesh] one NCCL rank (``parallel.spawn``), fit(mesh="
      f"create_mesh(), device_cache=True) {P23_EPOCHS} epochs ({steps} "
      f"steps) on {CELLS} × {GENES}: per-epoch losses {mesh['loss']} "
      f"against {single['loss']} on one device in this process (max rel "
      f"{rel:.2e}); a one-rank group's collectives are skipped, so the "
      "gradients' all-reduce, BatchNorm's statistics, the means and the "
      f"model axis's gathers are identities; launches {mesh['launches']};"
      f" predict_mean(mesh=) against predict_mean(): {serve:.2e} of the "
      f"largest (the first {P23_SAMPLE_ROWS} rows whole, every row's sum); "
      f"steady step {mesh['step_ms']:.3f} ms on the mesh, "
      f"{single['step_ms']:.3f} ms without, phase 4's "
      f"{PHASE4.get('step_ms', float('nan')):.3f} ms; the rank's fit and "
      f"serving {mesh['seconds']:.1f} s, {a_s:.1f} s with its start")


def _check_p23b(torch, ranks, want, b_s):
  import numpy as np
  for r, out in enumerate(ranks):
    check(out["launches"] == {"zinb_rowsum_fwd": P23_STEPS,
                              "zinb_rowsum_bwd": P23_STEPS},
          f"23b rank {r} launches {out['launches']}")
    check(abs(out["digest"] - ranks[0]["digest"])
          <= 1e-6 * ranks[0]["digest"], f"23b rank {r}'s model differs")
    for i, (g, w) in enumerate(zip(out["losses"], want["losses"])):
      check(abs(g - w) <= P23_STEP_RTOL * abs(w),
            f"23b rank {r} step {i + 1} loss {g} against {w}")
  got = ranks[0]
  check(len(got["split"]) == 3, f"23b split leaves {got['split']}")
  scale = max(float(g.abs().max()) for g in want["grads"].values())
  worst, worst_key = 0.0, None
  for k, w in want["grads"].items():
    w = w.cpu().numpy()
    ratio = float(np.abs(got["grads"][k] - w).max()) / (
        float(np.abs(w).max()) + 1e-3 * scale)
    if ratio > worst:
      worst, worst_key = ratio, k
  check(worst <= ROUTE_GRAD_BOUND,
        f"23b step 1 gradient {worst_key} off by {worst:.2e}")
  model = _scvi(torch, "full")
  state0 = {k: v.cpu().numpy() for k, v in model.module.state_dict().items()}
  loose = _batchnormed_biases(model.module)
  loose |= {k.replace(".dense", ".bn")[:-len("bias")] + "running_mean"
            for k in loose}
  del model
  u_worst, u_key, d_worst = 0.0, None, 0.0
  for k, w in want["state"].items():
    w = w.cpu().numpy()
    d = np.abs(got["state"][k] - w)
    d_worst = max(d_worst, float(d.max()))
    check(float(d.max()) <= 2 * 1e-3 * P23_STEPS + 1e-6,
          f"23b {k} off by {float(d.max()):.2e} after {P23_STEPS} steps")
    moved = float(np.linalg.norm(w - state0[k]))
    if k in loose or moved == 0.0:
      continue
    ratio = float(np.linalg.norm(got["state"][k] - w)) / moved
    if ratio > u_worst:
      u_worst, u_key = ratio, k
  check(u_worst <= P23_UPDATE_RTOL,
        f"23b {u_key}'s update off by {u_worst:.2e} of its norm")
  log(f"[23b mesh] a 2 × 2 world of 4 gloo ranks on one card (the gene "
      f"heads {got['split']} split over 'model', 256 rows a data rank): "
      f"{P23_STEPS} steps, losses {[round(v, 3) for v in got['losses']]} "
      f"against one device's {[round(v, 3) for v in want['losses']]} "
      f"(rtol {P23_STEP_RTOL}); step 1 gradients max|Δ|/(max|g|+1e-3·G) "
      f"{worst:.2e} at {worst_key} (bound {ROUTE_GRAD_BOUND}); after step "
      f"{P23_STEPS} every entry within {d_worst:.2e} (bound 2·lr·"
      f"{P23_STEPS}), the worst update ‖Δp‖/‖p − p₀‖ {u_worst:.2e} at "
      f"{u_key} (bound {P23_UPDATE_RTOL}; the {len(loose)} BatchNorm-fed "
      "biases and running means to the entry bound alone); every rank "
      f"launched each kernel {P23_STEPS} times; gloo took every collective"
      " on CUDA tensors (none staged through the host); the gloo fit "
      f"{got['seconds']:.2f} s is no speed figure ({b_s:.1f} s with the "
      "ranks' start)")


def phase_mesh(torch):
  """Phase 23 (module docstring): 23a's rank and 23b's four start at once,
  while this process makes their one-device references. Returns the
  launches of the mesh fits, summed over the ranks."""
  from sisua_tpu_torch.parallel import spawn
  t0 = time.perf_counter()

  def timed(fn, *args, **kw):
    t = time.perf_counter()
    return fn(*args, **kw), time.perf_counter() - t
  with ThreadPoolExecutor(2) as pool:
    fa = pool.submit(timed, spawn, _p23a_rank, 1, timeout=P23_TIMEOUT)
    fb = pool.submit(timed, spawn, _p23b_rank, 4, backend="gloo",
                     timeout=P23_TIMEOUT)
    single = _p23a_fit(torch, None)
    want = _p23b_fit(torch, None)
    (a, a_s), (ranks, b_s) = fa.result(), fb.result()
  mesh = a[0]
  _check_p23a(torch, single, mesh, a_s)
  _check_p23b(torch, ranks, want, b_s)
  total = time.perf_counter() - t0
  check(total <= P23_BUDGET, f"phase 23 took {total:.1f} s > {P23_BUDGET}")
  log(f"[23 mesh] phase 23 in {total:.1f} s (budget {P23_BUDGET:.0f} s; "
      f"the one-device references {single['seconds']:.1f} + "
      f"{want['seconds']:.1f} s in this process meanwhile)")
  return {k: mesh["launches"][k] + sum(o["launches"][k] for o in ranks)
          for k in mesh["launches"]}


# phase 24: 10x's pbmc_10k_protein_v3 filtered matrix at its published size
P24_CELLS = 7_865
P24_GENES = 33_538       # its "Gene Expression" features
P24_ADTS = ("CD3", "CD4", "CD8a", "CD14", "CD15", "CD16", "CD56", "CD19",
            "CD25", "CD45RA", "CD45RO", "PD-1", "TIGIT", "CD127", "IgG2a",
            "IgG1", "IgG2b")  # its 17 "Antibody Capture" features
P24_DUP_EVERY = 1_500    # every 1,500th gene repeats the symbol before it
P24_EPOCHS = 2
P24_PREDICT = 512
P24_BUDGET = 60.0
P24_SAMPLE = "pbmc_10k_protein_v3"


def _p24_barcode(i):
  return "".join("ACGT"[(i >> (2 * k)) & 3] for k in range(16)) + "-1"


def _p24_write(torch, user_dir):
  """The CellRanger v3 directory of phase 24's counts (made on the card
  from the seed, written with scipy); returns the written cells × features
  CSR, the feature names and the barcodes."""
  import gzip
  import numpy as np
  from scipy import io as sp_io
  from scipy import sparse
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
  x = torch.cat([_counts(torch, gen, P24_CELLS, P24_GENES),
                 _proteins(torch, gen, P24_CELLS, len(P24_ADTS))], 1)
  cell, feat = x.nonzero(as_tuple=True)
  vals = x[cell, feat].to(torch.int32).cpu().numpy()
  cell, feat = cell.cpu().numpy(), feat.cpu().numpy()
  del x
  n_feat = P24_GENES + len(P24_ADTS)
  names = [f"GENE{j}" for j in range(P24_GENES)]
  for j in range(P24_DUP_EVERY, P24_GENES, P24_DUP_EVERY):
    names[j] = names[j - 1]
  names += [f"{a}_TotalSeqB" for a in P24_ADTS]
  barcodes = [_p24_barcode(i) for i in range(P24_CELLS)]
  os.makedirs(user_dir)
  with gzip.open(os.path.join(user_dir, "matrix.mtx.gz"), "wb",
                 compresslevel=1) as f:
    sp_io.mmwrite(f, sparse.coo_matrix((vals, (feat, cell)),
                                       shape=(n_feat, P24_CELLS)))
  with gzip.open(os.path.join(user_dir, "barcodes.tsv.gz"), "wt") as f:
    f.write("".join(b + "\n" for b in barcodes))
  with gzip.open(os.path.join(user_dir, "features.tsv.gz"), "wt") as f:
    for j, n in enumerate(names):
      kind = "Gene Expression" if j < P24_GENES else "Antibody Capture"
      f.write(f"ENSG{j:011d}\t{n}\t{kind}\n")
  written = sparse.csr_matrix((vals.astype(np.float32), (cell, feat)),
                              shape=(P24_CELLS, n_feat))
  return written, names, barcodes


def _p24_check(label, sco, rna, adt, genes, barcodes):
  """The container holds the written counts bit for bit, the names (made
  unique as the JAX container makes them) and barcodes in order."""
  import numpy as np
  from sisua_tpu_torch.data.utils import dedup_names
  check(sco.omics == ["transcriptomic", "proteomic"],
        f"{label}: omics {sco.omics}")
  check(list(sco.obs["cell_id"]) == barcodes, f"{label}: barcodes")
  x = sco.get_omic("transcriptomic").tocsr(copy=True)
  x.sort_indices()
  check(x.dtype == np.float32 and x.shape == rna.shape
        and np.array_equal(x.indptr, rna.indptr)
        and np.array_equal(x.indices, rna.indices)
        and np.array_equal(x.data.view(np.uint32), rna.data.view(np.uint32)),
        f"{label}: transcriptomic differs from the written counts")
  y = sco.get_omic("proteomic")
  check(y.dtype == np.float32 and np.array_equal(
      y.view(np.uint32), adt.view(np.uint32)),
        f"{label}: proteomic differs from the written counts")
  check(list(sco.get_var_names("transcriptomic")) == dedup_names(genes),
        f"{label}: gene names")
  check(list(sco.get_var_names("proteomic"))
        == [f"{a}_TotalSeqB" for a in P24_ADTS], f"{label}: protein names")


def ingest_data_root():
  """Phase 24's data folder, named for this process: $SISUA_DATA and
  $SISUA_DOWNLOAD point into it from here on, so call this before the port
  is imported. Phase 24 makes it; the caller removes it."""
  data_root = os.path.join(tempfile.gettempdir(),
                           f"chip_smoke_data_{os.getpid()}")
  os.environ["SISUA_DATA"] = os.path.join(data_root, "data")
  os.environ["SISUA_DOWNLOAD"] = os.path.join(data_root, "downloads")
  return data_root


def phase_ingest(torch, data_root):
  """Phase 24 (module docstring): a CellRanger directory at the published
  size of 10x's pbmc_10k_protein_v3, read three ways, then SISUA trained
  on it. ``data_root`` holds $SISUA_DATA and $SISUA_DOWNLOAD, set before
  the port was imported. Returns the fit's launches."""
  import numpy as np
  from sisua_tpu_torch.data import get_dataset, path
  from sisua_tpu_torch.data.adapters import fit_sco, sco_matrices
  from sisua_tpu_torch.data.loaders import tenx
  from sisua_tpu_torch.models import SISUA, RVmeta
  from sisua_tpu_torch.ops import zinb as tz
  import scipy
  check(path.DATA_DIR == os.path.join(data_root, "data")
        and tenx.DOWNLOAD_DIR == os.path.join(data_root, "downloads"),
        f"SISUA_DATA / SISUA_DOWNLOAD not in effect: {path.DATA_DIR}")
  t0 = time.perf_counter()
  seconds = {}
  user_dir = os.path.join(data_root, "user", "filtered_feature_bc_matrix")
  written, names, barcodes = _p24_write(torch, user_dir)
  rna = written[:, :P24_GENES].tocsr()
  adt = written[:, P24_GENES:].toarray()
  seconds["write"] = time.perf_counter() - t0
  # the same tree placed as the 10x archive, downloaded and extracted
  t = time.perf_counter()
  url = tenx._matrix_url(*tenx.TENX_CATALOG[P24_SAMPLE], filtered=True)
  os.makedirs(tenx.DOWNLOAD_DIR)
  import tarfile
  # gzip level 0: the members are gzipped already
  with tarfile.open(os.path.join(tenx.DOWNLOAD_DIR, os.path.basename(url)),
                    "w:gz", compresslevel=0) as tar:
    tar.add(user_dir, arcname="filtered_feature_bc_matrix")
  extracted = os.path.join(tenx.DOWNLOAD_DIR, f"10x_{P24_SAMPLE}_filtered",
                           "filtered_feature_bc_matrix")
  shutil.copytree(user_dir, extracted)
  with open(os.path.join(os.path.dirname(extracted), ".extracted"), "w") as f:
    f.write(os.path.basename(url))
  seconds["place"] = time.perf_counter() - t
  log(f"[24 ingest] scipy {scipy.__version__}; wrote {P24_CELLS:,} cells × "
      f"{P24_GENES:,} genes + {len(P24_ADTS)} antibodies "
      f"({written.nnz:,} nonzeros, matrix.mtx.gz "
      f"{os.path.getsize(os.path.join(user_dir, 'matrix.mtx.gz')) / 1e6:.1f}"
      f" MB) in {seconds['write']:.2f} s; placed as the downloaded and "
      f"extracted archive in {seconds['place']:.2f} s")

  tz.reset_launches()
  t = time.perf_counter()
  by_dir = get_dataset(user_dir)
  seconds["load_dir"] = time.perf_counter() - t
  _p24_check("get_dataset(<dir>)", by_dir, rna, adt, names[:P24_GENES],
             barcodes)
  cache_s = []
  save = tenx.save_to_dataset

  def timed_save(*args, **kw):
    t = time.perf_counter()
    try:
      return save(*args, **kw)
    finally:
      cache_s.append(time.perf_counter() - t)
  tenx.save_to_dataset = timed_save
  try:
    t = time.perf_counter()
    parsed = get_dataset("10k")
    seconds["load_parse"] = time.perf_counter() - t
  finally:
    tenx.save_to_dataset = save
  check(len(cache_s) == 1, f"'10k' wrote {len(cache_s)} caches")
  seconds["cache_write"] = cache_s[0]
  _p24_check("get_dataset('10k')", parsed, rna, adt, names[:P24_GENES],
             barcodes)

  def refuse(url, *a, **k):
    raise RuntimeError(f"cache miss: download of {url}")
  download, tenx.download_file = tenx.download_file, refuse
  try:
    t = time.perf_counter()
    cached = get_dataset("10k")
    seconds["load_cache"] = time.perf_counter() - t
  finally:
    tenx.download_file = download
  _p24_check("get_dataset('10k') from its cache", cached, rna, adt,
             names[:P24_GENES], barcodes)
  check(by_dir.md5 == parsed.md5 == cached.md5,
        f"md5 {by_dir.md5} / {parsed.md5} / {cached.md5}")
  log(f"[24 ingest] three containers bitwise the written counts, names "
      f"and barcodes, one md5 {cached.md5}: get_dataset(<dir>) "
      f"{seconds['load_dir']:.2f} s, get_dataset('10k') parsing "
      f"{seconds['load_parse']:.2f} s (its cache written in "
      f"{seconds['cache_write']:.2f} s), get_dataset('10k') from the cache "
      f"{seconds['load_cache']:.2f} s (downloads refused)")
  del by_dir, parsed

  model = SISUA([RVmeta(P24_GENES, "zinb", name="transcriptomic"),
                 RVmeta(len(P24_ADTS), "nb", name="proteomic")],
                alpha=ALPHA, device=DEVICE, seed=SEED)
  # the kernel route against the plain route on the cached container's
  # first batch: rows of 33,538 f32 are not 16-byte aligned, and the
  # proteins 17 wide
  t = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
  head = cached[np.arange(BATCH)]
  batch = {"inputs": [torch.as_tensor(m.toarray() if hasattr(m, "toarray")
                                      else m, device=DEVICE)
                      for m in sco_matrices(model, head)],
           "mask": (torch.rand((BATCH,), generator=gen, device=DEVICE)
                    < 0.5).to(torch.float32)}
  check([tuple(m.shape) for m in batch["inputs"]]
        == [(BATCH, P24_GENES), (BATCH, len(P24_ADTS))],
        f"route batch {[m.shape for m in batch['inputs']]}")
  _compare_routes(torch, "24 ingest", "SISUA on the cached container's "
                  f"first {BATCH} cells", model, _converted(model, model),
                  batch, [torch.randn((BATCH, 10), generator=gen,
                                      device=DEVICE)], 2)
  del batch
  seconds["routes"] = time.perf_counter() - t
  tz.reset_launches()
  t = time.perf_counter()
  fit_sco(model, cached, batch_size=BATCH, labels_percent=LABELS_PERCENT,
          epochs=P24_EPOCHS, learning_rate=1e-3)
  torch.cuda.synchronize()
  seconds["fit"] = time.perf_counter() - t
  steps = P24_EPOCHS * (P24_CELLS // BATCH)
  launches = dict(tz.launches)
  losses = np.asarray(model.history["loss"])
  check(len(losses) == P24_EPOCHS and model.step == steps,
        f"ran {len(losses)} epochs / {model.step} steps")
  check(np.isfinite(losses).all(), f"non-finite loss {losses}")
  check(losses[-1] < losses[0], f"last epoch loss {losses[-1]} !< first "
        f"{losses[0]}")
  check(launches == {"zinb_rowsum_fwd": 2 * steps,
                     "zinb_rowsum_bwd": 2 * steps},
        f"launches {launches}: expected 2 × {steps} steps each")
  t = time.perf_counter()
  head = cached[np.arange(P24_PREDICT)]
  x_means, z_means = model.predict_mean(sco_matrices(model, head),
                                        batch_size=BATCH)
  seconds["predict"] = time.perf_counter() - t
  check([m.shape for m in x_means] == [(P24_PREDICT, P24_GENES),
                                       (P24_PREDICT, len(P24_ADTS))]
        and all(np.isfinite(m).all() for m in x_means + z_means),
        f"predict_mean shapes {[m.shape for m in x_means]}")
  check(dict(tz.launches) == launches, f"predict launched {tz.launches}")
  total = time.perf_counter() - t0
  epoch_s = ", ".join(f"{v:.2f}" for v in model.history["epoch_time"])
  log(f"[24 ingest] SISUA (phase 6's nets) fit_sco on the cached container, "
      f"batch {BATCH}, {P24_EPOCHS} epochs: {steps} steps in "
      f"{seconds['fit']:.2f} s (epochs {epoch_s} s), loss {losses[0]:.2f} "
      f"→ {losses[-1]:.2f}, launches {launches}; predict_mean of "
      f"{P24_PREDICT} cells {seconds['predict']:.2f} s")
  log(f"[24 ingest] phase 24 in {total:.1f} s (budget {P24_BUDGET:.0f} s"
      f"{'' if total <= P24_BUDGET else ', OVER'}): " + ", ".join(
          f"{k} {v:.2f} s" for k, v in seconds.items()))
  return launches


P25_DEPTH = 1            # 1 epoch (2 for the notebook's fast fit), 2 TPE
#                          evaluations, 2 MC draws, a 2-run grid
P25_BUDGET = 90.0
# tutorials whose main path has no ZINB/NB head in this process: the
# embedding's GMMs, and the drill, whose two stages run in a process of
# their own (their launches are its)
P25_NO_KERNEL = ("probabilistic_embedding", "real_data_drill")
# trains with mc_samples=2, whose parameters carry the draws' dims: its
# steps take the distribution math, its validation and posterior the
# forward kernel
P25_FORWARD_ONLY = ("uncertainty_analysis",)


def _p25_numbers(obj, path="result"):
  """Every number in a tutorial's result, with where it lies."""
  import numpy as np
  if isinstance(obj, dict):
    for k, v in obj.items():
      yield from _p25_numbers(v, f"{path}[{k!r}]")
  elif isinstance(obj, (list, tuple)):
    for i, v in enumerate(obj):
      yield from _p25_numbers(v, f"{path}[{i}]")
  elif not (isinstance(obj, (bool, str)) or obj is None):
    yield path, float(np.asarray(obj, np.float64))


def phase_tutorials(torch, depth=P25_DEPTH, budget=P25_BUDGET):
  """Phase 25 (module docstring): every tutorial's ``main()`` on the card
  at ``depth`` (None: the JAX tutorials' own), then the notebook's code
  cells in order, in a fresh working directory, each from launch counts
  set to 0. What the tutorials print goes to a log, shown if one raises.
  Returns (the ZINB launches, seconds by tutorial)."""
  import importlib
  import math
  from sisua_tpu_torch.ops import zinb as tz
  from sisua_tpu_torch.tutorials import TUTORIALS
  work = tempfile.mkdtemp(prefix="chip_smoke_tutorials_")
  cwd = os.getcwd()
  launches = {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  seconds = {}
  log("[25 tutorials] host load averages (1, 5, 15 min): "
      + ", ".join(f"{v:.2f}" for v in os.getloadavg())
      + f" on {len(os.sched_getaffinity(0))} cores")
  t0 = time.perf_counter()
  try:
    os.chdir(work)
    for name in TUTORIALS + ("notebook",):
      mod = importlib.import_module(f"sisua_tpu_torch.tutorials.{name}")
      out = os.path.join(work, name)
      os.makedirs(out)
      tz.reset_launches()
      t = time.perf_counter()
      with open(os.path.join(work, f"{name}.log"), "w") as f:
        try:
          with contextlib.redirect_stdout(f):
            result = mod.main(device=DEVICE, out_dir=out, depth=depth)
          torch.cuda.synchronize()
        except BaseException:
          f.flush()
          with open(f.name) as g:
            print(g.read()[-6000:], file=sys.stderr)
          raise
      seconds[name] = time.perf_counter() - t
      got = dict(tz.launches)
      for k in launches:
        launches[k] += got.get(k, 0)
      bad = [p for p, v in _p25_numbers(result) if not math.isfinite(v)]
      check(not bad, f"[25 tutorials] {name}: not finite {bad}")
      if name in P25_NO_KERNEL:
        check(not any(got.values()) or name == "real_data_drill",
              f"[25 tutorials] {name} launched {got}")
      else:
        want = (("zinb_rowsum_fwd",) if name in P25_FORWARD_ONLY
                else tuple(launches))
        check(all(got.get(k, 0) > 0 for k in want),
              f"[25 tutorials] {name} launched {got}: the card's "
              f"ZINB/NB heads must reach {' and '.join(want)}")
      log(f"[25 tutorials] {name}: {seconds[name]:.2f} s, launches {got}")
  finally:
    os.chdir(cwd)
    shutil.rmtree(work, ignore_errors=True)
  total = time.perf_counter() - t0
  label = "their own depth" if depth is None else f"depth {depth}"
  log(f"[25 tutorials] {len(seconds)} tutorials at {label} in {total:.1f} s"
      f" (budget {budget:.0f} s{'' if total <= budget else ', OVER'}), "
      f"launches {launches}")
  return launches, seconds


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    return 2
  sys.path.insert(0, ROOT)
  data_root = ingest_data_root()
  import sisua_tpu_torch  # noqa: F401  (fails outside a checkout)
  t_start = time.perf_counter()

  def mark(phases):
    log(f"[timing] phases {phases} end at "
        f"{time.perf_counter() - t_start:.1f} s")

  smi = phase_device(torch)
  phase_build()
  kern = phase_kernels(torch)
  x, held = phase_data(torch)
  mark("1-3")
  ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
  try:
    model, library, launches = phase_fit(torch, x, held)
    saved = {"SCVI": _save_trained(torch, model, [held], ckpt_root)}
    phase_routes(torch, model, x, library)
    del model
    sisua, y, held_y, sisua_launches = phase_sisua(torch, x, held)
    saved["SISUA"] = _save_trained(torch, sisua, [held, held_y], ckpt_root)
    phase_model_routes(torch, sisua, x, y)
    del sisua
    serve_launches = phase_serving(torch, saved, x, held, held_y, smi)
    del saved
    mark("4-8")
    zoo_launches = phase_zoo(torch, x, held, y, held_y, library, ckpt_root,
                             smi)
    batch_launches = phase_batch(torch, x, held, y, held_y, library,
                                 ckpt_root, smi)
    # phase 11 makes its counts mosaic in place: it gets a copy
    multiome_launches = phase_multiome(torch, x.clone(), held.clone(),
                                       ckpt_root, smi)
    torch.cuda.empty_cache()
    last_launches = phase_last_zoo(torch, x, held, library, ckpt_root, smi)
    torch.cuda.empty_cache()
    mark("9-12")
    bf16_launches, _ = phase_bf16(torch, x, held, library, ckpt_root, smi)
    surface_launches = phase_fit_surface(torch, x, held, ckpt_root, smi)
    torch.cuda.empty_cache()
    mark("13")
    probes, probe_launches = phase_probes(torch)
    big, ooc_model, ooc_launches = phase_out_of_core(torch, x, smi)
    stream_launches = phase_streaming(torch, big, held, smi)
    phase_sparse_serving(torch, ooc_model, held)
    del ooc_model
    scan_launches = phase_scan_steps(torch, big)
    del big
    torch.cuda.empty_cache()
    mark("14, 15e")
    members = phase_member_kernels(torch)
    fleet_launches = phase_fleet(torch, x, held, library, smi)
    fleet_zoo_launches = phase_fleet_zoo(torch, x, y, library, smi)
    mark("15a-d, 19")
    analysis_launches, z = phase_analysis(torch, x, held, y, held_y)
    torch.cuda.empty_cache()
    mark("16-17, 22")
    full, counts = phase_data_analysis(torch, x, y)
    mark("20")
    del x, held, y, held_y
    torch.cuda.empty_cache()
    phase_baselines_tsne(torch, full, counts, z)
    del full, counts, z
    torch.cuda.empty_cache()
    mark("21")
    experiment_launches = phase_experiment(torch)
    mark("18")
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(torch)
    mark("23")
    torch.cuda.empty_cache()
    ingest_launches = phase_ingest(torch, data_root)
    mark("24")
    torch.cuda.empty_cache()
    tutorial_launches, _ = phase_tutorials(torch)
    mark("25")
  finally:
    shutil.rmtree(ckpt_root, ignore_errors=True)
    shutil.rmtree(data_root, ignore_errors=True)
  launches = {k: v + sisua_launches[k] + serve_launches[k] + zoo_launches[k]
              + batch_launches[k] + multiome_launches[k] + last_launches[k]
              + bf16_launches[k] + surface_launches[k] + probe_launches[k]
              + ooc_launches[k] + stream_launches[k] + scan_launches[k]
              + fleet_launches[k] + fleet_zoo_launches[k]
              + analysis_launches[k]
              + experiment_launches[k] + mesh_launches[k]
              + ingest_launches[k] + tutorial_launches[k]
              for k, v in launches.items()}

  def numbers(case, key, err, kind, results=kern):
    c = results[case]
    return {"max_abs_err": c[err], "ms": c[key]["kernel"] / 1e3,
            "plain_ms": c[key]["plain"] / 1e3,
            "bound_ms": c["bounds"][kind][0] / 1e3,
            "bound_by": c["bounds"][kind][1]}
  kernels = []
  for name, line, key, err, kind in (
      ("zinb_rowsum_fwd", 172, "t_fwd", "fwd_err", "fwd"),
      ("zinb_rowsum_bwd", 339, "t_bwd", "bwd_err", "bwd")):
    entry = {"name": name, "route": "cuda",
             "source": "sisua_tpu_torch/csrc/zinb.cu",
             "replaces": f"sisua_tpu/ops/zinb_pallas.py:{line}",
             "launches": launches[name],
             **numbers("main_full", key, err, kind),
             "library_ms": None}  # no single PyTorch call computes it
    # the bf16-operand mode (phase 13a's path), at 512 × 33,000 main_full
    entry["bf16_operands"] = dict(launches=bf16_launches[name],
                                  **numbers("main_full_bf16", key, err,
                                            kind))
    if kind == "bwd":  # float32 operands, bf16 gradient writes
      entry["bf16_writes"] = numbers("main_full_writes", key, err, kind)
    # FLEET members in one launch (phases 15b–d's and 19's fleets)
    entry["members"] = dict(count=FLEET, launches=fleet_launches[name]
                            + fleet_zoo_launches[name],
                            **numbers("fleet_full_shared", key, err, kind,
                                      members))
    kernels.append(entry)
  for name, line in (("elemwise_probe", 83), ("lgamma_probe", 131)):
    kernels.append({"name": name, "route": "cuda",
                    "source": "sisua_tpu_torch/csrc/probe.cu",
                    "replaces": f"benchmarks/kernel_probe.py:{line}",
                    **probes[name],
                    "library_ms": None})  # no single PyTorch call computes it
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
