"""Serving / batch scoring: counts in → imputed means, latent embeddings
and denoised expression out, the inference surface and its transfer
knobs (port of ``tutorials/serving.py``).

  python -m sisua_tpu_torch.tutorials.serving            # on the card
  python -m sisua_tpu_torch.tutorials.serving --device cpu
"""

from __future__ import annotations

import numpy as np

from ._common import at_depth, device_of, run_cli

EPOCHS = 6
DRAWS = 10        # predict_mean's and the normalized expression's draws
BF16_DRAWS = 4    # the bf16 fetch's draws


def build(train, device):
  from ..models import SCVI, RVmeta
  return SCVI(RVmeta(train.n_vars, "zinbd", name="rna"),
              latents=RVmeta(16, "diag", name="latents"), device=device)


def main(device=None, out_dir=None, depth=None, figures=False):
  from ..data import generate_citeseq
  from ..data.adapters import fit_sco, sco_matrices
  dev = device_of(device)
  draws = at_depth(DRAWS, depth, least=2)
  bf16_draws = at_depth(BF16_DRAWS, depth, least=2)

  # --- train a model (any checkpoint works the same way) ---------------------
  sco = generate_citeseq(n_cells=2048, n_genes=120, n_proteins=8, seed=0)
  train, fresh = sco.split(0.8, seed=1)
  model = build(train, dev)
  fit_sco(model, train, epochs=at_depth(EPOCHS, depth), batch_size=128,
          device_cache=True, metrics_interval=3, valid_freq=0, patience=0)
  counts = sco_matrices(model, fresh)

  # --- 1. the serving path: predict_mean -------------------------------------
  # ``predict`` returns distributions; ``predict_mean`` averages the draws
  # on the device and fetches only the (n, d) means.
  (imputed, *_), (latents, *_) = model.predict_mean(
      counts, sample_shape=(draws,))
  print("imputed:", imputed.shape, "latents:", latents.shape)

  # --- 2. transfer compression -----------------------------------------------
  # input_dtype='auto' uploads integral counts as exact int16;
  # fetch_dtype='bfloat16' halves the fetch. The same generator state gives
  # the same draws, so the two calls differ by bf16 rounding only.
  state = model.generator.get_state()
  (x32, *_), _ = model.predict_mean(counts, sample_shape=(bf16_draws,))
  model.generator.set_state(state)
  (x16, *_), _ = model.predict_mean(counts, sample_shape=(bf16_draws,),
                                    fetch_dtype="bfloat16")
  rel = np.abs(np.asarray(x16, np.float32) - x32) / (np.abs(x32) + 1e-6)
  print(f"bf16 fetch relative error: median {np.median(rel):.2e}")

  # --- 3. denoised (library-free) expression ---------------------------------
  scale = model.get_normalized_expression(counts, sample_shape=(draws,))
  sums_to_1 = bool(np.allclose(scale.sum(1), 1.0, atol=1e-3))
  print("normalized expression rows sum to 1:", sums_to_1)

  # --- 4. several cards: every inference entry point takes mesh=
  #   from sisua_tpu_torch.parallel import create_mesh
  #   model.predict_mean(counts, mesh=create_mesh())
  # --- 5. the same from the command line:
  #   python -m sisua_tpu_torch.cli.predict ckpt_dir counts.npz -o scored/ \
  #       --fetch-dtype bfloat16
  print("done")
  return {"imputed": list(imputed.shape), "latents": list(latents.shape),
          "bf16_median_rel_err": float(np.median(rel)),
          "rows_sum_to_1": sums_to_1}


if __name__ == "__main__":
  run_cli(main, __doc__)
