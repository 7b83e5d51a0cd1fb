"""The port's training monitors (``analysis.sc_monitor``), the figures of
``label_threshold`` and ``sisua-embed``, and ``cli.showdata`` against the
JAX package's.

The monitors' ``plot`` takes distributions built from the same arrays in
both packages and draws the JAX figure (``torch_port_figure_helper``:
strings and counts exactly, numbers within 1e-5 relative where the JAX
figure computes in float32, the latent PCA within 2e-4 of a column's
range); fitted with a model, they save the JAX files at the JAX epochs,
and within their ``figure_data()`` blocks keep the figures' data and draw
nothing. The
embedding's figures are drawn from the same fitted labels (1e-10); the
CLIs write the JAX files. Without matplotlib each render names it.
"""

import contextlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu_torch.dist as TD
from torch_port_figure_helper import assert_figures_equal, reduce_figure
from torch_port_threads import _one_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)
HISTORY = {"loss": [5.0, 4.0], "val_loss": [5.5, 4.5], "llk": [-3.0, -2.0],
           "klqp": [1.0, 0.5], "other": [0.0, 1.0]}


@pytest.fixture(scope="module")
def data():
  from sisua_tpu.data import generate_synthetic
  sco = generate_synthetic(n_cells=90, n_genes=70, n_proteins=4,
                           n_celltypes=3, seed=6)
  rng = np.random.default_rng(0)
  n, g = sco.n_obs, sco.n_vars
  arrays = dict(total_count=np.exp(rng.normal(size=(2, n, g))),
                logits=rng.normal(size=(2, n, g)),
                gate=rng.normal(size=(2, n, g)),
                loc=rng.normal(size=(n, 5)))
  return sco, {k: v.astype(np.float32) for k, v in arrays.items()}


def _dists(pkg, a):
  t = jnp.asarray if pkg is JD else torch.tensor
  px = pkg.Independent(pkg.ZeroInflated(pkg.NegativeBinomial(
      t(a["total_count"]), t(a["logits"])), t(a["gate"])), 1)
  qz = pkg.MultivariateNormalDiag(loc=t(a["loc"]),
                                  scale_diag=t(np.ones_like(a["loc"])))
  return px, qz


class _Model:
  history = HISTORY


def test_monitors_draw_the_jax_figures(data, tmp_path):
  import sisua_tpu.analysis.sc_monitor as JM
  import sisua_tpu_torch.analysis.sc_monitor as TM
  sco, a = data
  y = [sco.numpy("transcriptomic")]
  names = list(sco.get_var_names("celltype"))
  onehot = sco.numpy("celltype")
  pairs = [
      (JM.LearningCurves(str(tmp_path), sco=sco),
       TM.LearningCurves(str(tmp_path), data=y), {}),
      (JM.LearningCurves(str(tmp_path), keys=["loss", "klqp"], sco=sco),
       TM.LearningCurves(str(tmp_path), keys=["loss", "klqp"], data=y), {}),
      (JM.ScatterPlot(str(tmp_path), sco=sco),
       TM.ScatterPlot(str(tmp_path), labels=onehot, label_names=names,
                      data=y), dict(column_atol=2e-4)),
      (JM.HeatmapPlot(str(tmp_path), sco=sco),
       TM.HeatmapPlot(str(tmp_path), data=y), {}),
  ]
  for i, (jm, tm, tol) in enumerate(pairs):
    jm.set_model(_Model())
    tm.set_model(_Model())
    jf = jm.plot(y, *_dists(JD, a))
    tf = tm.plot(y, *_dists(TD, a))
    assert_figures_equal(reduce_figure(tf), reduce_figure(jf), name=str(i),
                         **tol, **F32)


def test_monitors_save_at_the_jax_epochs(tmp_path, monkeypatch):
  """A VAE fitted 2 epochs with the three monitors (every epoch) in each
  package saves the same files; without rendering the port keeps each
  firing's data under the file's name."""
  import sisua_tpu.analysis.sc_monitor as JM
  import sisua_tpu_torch.analysis.sc_monitor as TM
  from sisua_tpu.data import generate_synthetic
  from sisua_tpu.models import VAE as JVAE
  from sisua_tpu.nn import NetConf as JNet
  from sisua_tpu.rv import RVmeta as JRV
  from sisua_tpu_torch.models import VAE as TVAE
  from sisua_tpu_torch.nn import NetConf as TNet
  from sisua_tpu_torch.rv import RVmeta as TRV
  sco = generate_synthetic(n_cells=120, n_genes=30, n_proteins=3,
                           n_celltypes=2, seed=2)
  x = sco.numpy("transcriptomic")
  kw = dict(freq=1, sample_shape=1)
  jcb = [JM.LearningCurves(str(tmp_path / "j"), sco=sco, **kw),
         JM.ScatterPlot(str(tmp_path / "j"), sco=sco, **kw),
         JM.HeatmapPlot(str(tmp_path / "j"), sco=sco, **kw)]
  lab = dict(labels=sco.numpy("celltype"),
             label_names=list(sco.get_var_names("celltype")))
  def tvae():
    return TVAE(TRV(30, "zinb", name="transcriptomic"),
                encoder=TNet((8,)), decoder=TNet((8,)), device="cpu")

  for sub, render in (("t", True), ("d", False)):
    tcb = [TM.LearningCurves(str(tmp_path / sub), data=[x], **kw),
           TM.ScatterPlot(str(tmp_path / sub), data=[x], **lab, **kw),
           TM.HeatmapPlot(str(tmp_path / sub), data=[x], **kw)]
    if render:
      tvae().fit(x, epochs=2, batch_size=40, callbacks=tcb)
      saved = sorted(os.listdir(tmp_path / "t"))
      assert all(not m.figures for m in tcb)
    else:
      with contextlib.ExitStack() as stack:
        fired = [stack.enter_context(m.figure_data()) for m in tcb]
        tvae().fit(x, epochs=2, batch_size=40, callbacks=tcb)
      assert not os.listdir(tmp_path / "d")
      assert sorted(f"{k}.png" for d in fired for k in d) == saved
  jm = JVAE(JRV(30, "zinb", name="transcriptomic"), encoder=JNet((8,)),
            decoder=JNet((8,)))
  jm.fit(sco, epochs=2, batch_size=40, callbacks=jcb)
  assert saved == sorted(os.listdir(tmp_path / "j"))
  # in both packages the loss history grows after the epoch's callbacks:
  # each firing is named epoch 0, and LearningCurves has nothing to draw
  assert saved == ["HeatmapPlot_epoch0000.png", "ScatterPlot_epoch0000.png"]
  monkeypatch.setitem(sys.modules, "matplotlib", None)
  mon = TM.HeatmapPlot(str(tmp_path / "x"), data=[x])
  with pytest.raises(ImportError, match="matplotlib"):  # before any step
    mon.set_model(tvae())


def test_embed_figures_match_jax(tmp_path, monkeypatch):
  from sisua_tpu.label_threshold import ProbabilisticEmbedding as JPE
  from sisua_tpu.label_threshold import main as jembed
  from sisua_tpu_torch.cli.embed import main as tembed
  from sisua_tpu_torch.data import get_dataset
  from sisua_tpu_torch.label_threshold import ProbabilisticEmbedding as TPE
  tembed(["synthetic200", "-o", str(tmp_path / "t"), "--device", "cpu"])
  jembed(["synthetic200", "-o", str(tmp_path / "j")])
  assert sorted(os.listdir(tmp_path / "t")) == sorted(
      os.listdir(tmp_path / "j")) == ["distribution.png", "model.pkl",
                                      "y_bin", "y_prob"]
  x = get_dataset("synthetic200").numpy("proteomic")[:, :3]
  jp, tp = JPE().fit(x), TPE(device="cpu").fit(x)
  np.testing.assert_array_equal(tp.predict(x), jp.predict(x))
  for jf, tf in ((jp.plot_distribution(x, ["a", "b", "c"]),
                  tp.plot_distribution(x, ["a", "b", "c"])),
                 (jp.plot_diagnosis(x), tp.plot_diagnosis(x)),
                 (jp.boxplot(x), tp.boxplot(x)),
                 (jp.boxplot(x[:, 0]), tp.boxplot(x[:, 0]))):
    assert_figures_equal(reduce_figure(tf), reduce_figure(jf), rtol=1e-10,
                         atol=1e-10)
  tp.boxplot(x, path=str(tmp_path / "b.png"))
  assert (tmp_path / "b.png").is_file()
  monkeypatch.setitem(sys.modules, "matplotlib", None)
  with pytest.raises(ImportError, match="matplotlib"):
    tp.plot_distribution(x)


def test_showdata_writes_the_jax_files(tmp_path, monkeypatch, capsys):
  from sisua_tpu.cli.showdata import main as jshow
  from sisua_tpu_torch.cli.showdata import main as tshow
  jshow(["-ds", "synthetic200", "-path", str(tmp_path / "j"), "--figures"])
  sco = tshow(["-ds", "synthetic200", "-path", str(tmp_path / "t"),
               "--figures", "--device", "cpu"])
  files = sorted(os.listdir(tmp_path / "t"))
  assert files == sorted(os.listdir(tmp_path / "j"))
  assert "obs_stats.csv" in files and len(files) == 8
  import pandas as pd
  j = pd.read_csv(tmp_path / "j" / "obs_stats.csv", index_col=0)
  t = pd.read_csv(tmp_path / "t" / "obs_stats.csv", index_col=0)
  assert list(t.index) == list(j.index)
  for c in set(t.columns) & set(j.columns):
    np.testing.assert_allclose(t[c].to_numpy(), j[c].to_numpy(), rtol=1e-6,
                               err_msg=c)
  assert "transcriptomic_total_counts" in t.columns
  tshow(["--list"])
  assert "synthetic200" in capsys.readouterr().out
  monkeypatch.setitem(sys.modules, "matplotlib", None)
  with pytest.raises(ImportError, match="matplotlib"):
    tshow(["-ds", "synthetic200", "-path", str(tmp_path / "x"),
           "--figures", "--device", "cpu"])
  assert not (tmp_path / "x").exists() and sco is not None
