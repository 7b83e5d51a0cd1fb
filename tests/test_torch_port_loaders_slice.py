"""The ingestion slice against JAX on the CPU: a CellRanger v3 directory of
256 cells × 300 genes + 5 antibodies goes through each package's
``get_dataset``; one SISUA step on its cells at the JAX weights (random,
seeded) carried across by ``convert.py`` gives the JAX loss and gradients
(the tolerances of ``test_torch_port_models.py``); and
``sisua_tpu_torch.cli.train`` trains SISUA for one epoch from that
directory and from an ``.h5ad`` of it, and writes its scores (the port's
counterpart of
``test_cache_drill.py::test_h5ad_one_command_drill``)."""

import gzip
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import io as sp_io
from scipy import sparse

import sisua_tpu.data as JD
import sisua_tpu.models as J
import sisua_tpu_torch.data as TD
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.rv import RVmeta as TRV
from test_torch_port_batch import _random_state
from test_torch_port_models import _port_grad_tree
from torch_port_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS, GENES, ADT, BATCH = 256, 300, 5, 64


@pytest.fixture(scope="module")
def tenx_dir(tmp_path_factory):
  """A CellRanger v3 filtered_feature_bc_matrix directory (gzipped), with
  a repeated gene symbol, seeded with numpy."""
  rng = np.random.default_rng(20)
  rna = (rng.poisson(np.exp(rng.normal(-0.5, 1, (CELLS, GENES))))
         * (rng.uniform(size=(CELLS, GENES)) > 0.3))
  adt = rng.poisson(np.exp(2.0 + rng.normal(0, 1, (CELLS, ADT))))
  x = np.concatenate([rna, adt], 1).astype(np.float32)
  d = tmp_path_factory.mktemp("slice") / "filtered_feature_bc_matrix"
  os.makedirs(d)
  with gzip.open(d / "matrix.mtx.gz", "wb") as f:
    sp_io.mmwrite(f, sparse.coo_matrix(x.T))  # features × cells
  with gzip.open(d / "barcodes.tsv.gz", "wt") as f:
    f.write("".join(f"AAAC{i:05d}-1\n" for i in range(CELLS)))
  names = [f"GENE{j}" for j in range(GENES)]
  names[7] = names[3]
  with gzip.open(d / "features.tsv.gz", "wt") as f:
    f.write("".join(f"ENSG{j:05d}\t{n}\tGene Expression\n"
                    for j, n in enumerate(names)))
    f.write("".join(f"ADT{j}\tCD{j + 2}_TotalSeqB\tAntibody Capture\n"
                    for j in range(ADT)))
  return str(d), x


def test_sisua_step_from_a_10x_directory_matches_jax(tenx_dir):
  path, x = tenx_dir
  jsco, tsco = JD.get_dataset(path), TD.get_dataset(path)
  assert tsco.omics == list(jsco.omics) == ["transcriptomic", "proteomic"]
  assert tsco.md5 == jsco.md5
  np.testing.assert_array_equal(tsco.numpy("transcriptomic"), x[:, :GENES])
  np.testing.assert_array_equal(tsco.numpy("proteomic"), x[:, GENES:])
  assert list(tsco.get_var_names())[7] == "GENE3.1"
  rvs = [("transcriptomic", GENES, "zinb"), ("proteomic", ADT, "nb")]
  nets = dict(encoder={"units": [32, 32], "batchnorm": True},
              decoder={"units": [32, 32], "batchnorm": True},
              latents=dict(dim=8, posterior="diag", name="latents"),
              alpha=10.0)
  jm = J.SISUA([JRV(d, p, name=n) for n, d, p in rvs], **nets)
  params, bs = _random_state(jm)
  tm = T.SISUA([TRV(d, p, name=n) for n, d, p in rvs], device="cpu",
               **nets)
  tm.module.load_state_dict(convert.jax_to_torch(tm.module, params, bs))
  rows = np.arange(BATCH)
  mask = (np.random.default_rng(1).uniform(size=BATCH) < 0.4).astype(
      np.float32)
  mask[:2] = [0.0, 1.0]
  jin = [jsco.numpy(o)[rows] for o in jsco.omics]
  (loss, (_, _, out)), grads = jax.jit(jax.value_and_grad(
      lambda p: jm._loss(p, bs, {"inputs": [jnp.asarray(a) for a in jin],
                                 "mask": jnp.asarray(mask)},
                         jax.random.key(3, impl="rbg"), 1.0, training=True),
      has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
  noise = [torch.tensor(np.asarray((z - q.loc) / q.scale_diag))
           for q, z in zip(out.latents, out.latent_samples)]
  tin = [torch.tensor(tsco.numpy(o)[rows]) for o in tsco.omics]
  tloss, _, _ = tm._loss({"inputs": tin, "mask": torch.tensor(mask)}, True,
                         1.0, noise=noise)
  tloss.backward()
  np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-4)
  jl = jax.tree_util.tree_leaves_with_path(jax.device_get(grads))
  tl = jax.tree_util.tree_leaves_with_path(_port_grad_tree(tm.module))
  assert [p for p, _ in jl] == [p for p, _ in tl]
  scale = max(float(np.abs(np.asarray(g)).max()) for _, g in jl)
  for (p, jg), (_, tg) in zip(jl, tl):
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * scale,
                               err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("source", ["tenx_dir", "h5ad"])
def test_train_cli_from_user_files(source, tenx_dir, tmp_path):
  """``sisua-train`` of SISUA for one epoch on the CPU from the directory
  or from an ``.h5ad`` written of it: exit 0, its scores on disk and on
  the scoreboard, every value finite."""
  path = tenx_dir[0]
  if source == "h5ad":
    path = str(tmp_path / "user_data.h5ad")
    TD.write_h5ad(TD.get_dataset(tenx_dir[0]), path)
  env = dict(os.environ, SISUA_EXP=str(tmp_path / "exp"),
             OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
             MKL_NUM_THREADS="1")
  proc = subprocess.run(
      [sys.executable, "-m", "sisua_tpu_torch.cli.train", "model.name=sisua",
       f"dataset.name={path}", "train.epochs=1", "train.valid_freq=0",
       "variables.latents.event_shape=4", "--device", "cpu"],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  (exp,) = [d for d in os.listdir(tmp_path / "exp") if d != "scoreboard.db"]
  with open(tmp_path / "exp" / exp / "scores.json") as f:
    scores = json.load(f)
  assert any(k.startswith("llk") for k in scores)
  assert all(np.isfinite(v) for v in scores.values())
  from sisua_tpu_torch.train.scoreboard import ScoreBoard
  rows = ScoreBoard(str(tmp_path / "exp" / "scoreboard.db")).read_scores(
      f"scores_{path}")
  assert list(rows) == [exp]
  assert all(rows[exp][k] == v for k, v in scores.items())
