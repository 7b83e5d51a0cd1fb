"""Checkpoints shared by the JAX package and the port: the msgpack codec
against flax, ``save_weights``/``load_model`` in both directions for SCVI
('single' and 'full', with ``n_batch`` and with a label head), VAE,
SISUA, MISA, DCA, SCALE, SCALAR, FVAE and SemiFVAE (with FactorVAE's
discriminator in ``aux_params.msgpack``), LDVAE, TotalVI (``mask_protein``,
``n_batch``) and SCANVI (its classifier and hierarchy nets), what
``metamodel.json`` carries (β schedules, ``NetConf``'s
JAX-only fields, dataset, metadata, history), bf16 and ``use_conv``
checkpoints, the refusals, and that the
port imports none of JAX, flax, msgpack, pandas or ``sisua_tpu``.

Weights are random (perturbed off their init, batch stats and aux
parameters too), so every leaf is worth comparing. The eval-mode forward
and loss of the loaded model are held to the model it came from at fed
noise: the JAX draws are replayed from the module's 'sample' keys (a
mixture latent's component indices and component noise too; TotalVI's
log β and SCANVI's z₂ from the second key) and handed to the port (rtol 1e-4, atol 1e-5, as tests/test_torch_port_models.py; the
eval loss metrics rtol 1e-3, ``EVAL_RTOL``).
"""

import functools
import io
import json
import os
import subprocess
import sys

import flax.serialization as fser
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack as upstream_msgpack
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu.models as J
from sisua_tpu.nn import NetConf as JNetConf
from sisua_tpu.rv import RVmeta as JRV
from sisua_tpu_torch import convert
from sisua_tpu_torch import models as T
from sisua_tpu_torch.nn import NetConf as TNetConf
from sisua_tpu_torch.rv import RVmeta as TRV
from sisua_tpu_torch.train import checkpoint as tckpt
from sisua_tpu_torch.train import msgpack as tmp
from torch_port_threads import _one_thread  # noqa: F401


G, P, N = 60, 6, 40
NB, C = 3, 4  # batch levels of the n_batch models, SCANVI's cell types
CLOSE = dict(rtol=1e-4, atol=1e-5)
# eval-mode loss metrics across the packages: the perturbed weights put
# NB dispersions up to e^15, where one float32 ulp of lgamma(θ) is ~0.5
# and the two packages' lgamma differ by about that in a cell's sum
EVAL_RTOL = 1e-3
NETS = dict(encoder={"units": [32, 32], "batchnorm": True},
            decoder={"units": [32, 32], "batchnorm": True})


# ------------------------------------------------------------------ codec
def _tree(seed):
  rng = np.random.default_rng(seed)
  return {
      "dense": {"kernel": rng.normal(size=(7, 5)).astype(np.float32),
                "bias": rng.normal(size=(5,)).astype(np.float32)},
      "counts": {"i32": rng.integers(-9, 9, (3, 4)).astype(np.int32),
                 "i64": np.arange(20, dtype=np.int64)},
      "bf16": np.asarray(rng.normal(size=(2, 9)), ml_dtypes.bfloat16),
      "scalars": {"f": np.float32(2.5), "i": np.int32(-7),
                  "step": np.int64(123456789)},
      "empty": np.zeros((0, 3), np.float32),
      "wide": rng.normal(size=(70, 300)).astype(np.float32),
  }


def _leaves_equal(a, b):
  if isinstance(a, dict):
    assert sorted(a) == sorted(b)
    for k in a:
      _leaves_equal(a[k], b[k])
    return
  if isinstance(b, torch.Tensor):  # a bf16 leaf reads as a torch tensor
    assert str(np.asarray(a).dtype) == "bfloat16"
    b = b.float().numpy()
    a = np.asarray(a, np.float32)
  assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(
      b).dtype or np.asarray(a).dtype == ml_dtypes.bfloat16
  np.testing.assert_array_equal(np.asarray(a, np.asarray(b).dtype), b)


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_writes_flax_bytes(seed):
  tree = _tree(seed)
  assert tmp.packb(tree) == fser.msgpack_serialize(tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_reads_flax_bytes(seed):
  tree = _tree(seed)
  back = tmp.unpackb(fser.msgpack_serialize(tree))
  _leaves_equal(tree, back)
  assert isinstance(back["scalars"]["f"], np.float32)
  assert back["bf16"].dtype == torch.bfloat16
  _leaves_equal(fser.msgpack_restore(tmp.packb(tree)), tmp.unpackb(
      tmp.packb(tree)))


def test_codec_torch_leaves_pack_as_numpy():
  t = torch.randn(3, 4)
  assert tmp.packb({"a": t}) == fser.msgpack_serialize({"a": t.numpy()})
  b = torch.randn(3, 4).to(torch.bfloat16)
  ref = np.asarray(b.float().numpy(), ml_dtypes.bfloat16)
  assert tmp.packb({"b": b}) == fser.msgpack_serialize({"b": ref})


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63, 1.5,
    -0.0, "", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "é" * 70000,
    b"", b"\x00" * 300, b"\x01" * 70000, list(range(15)), list(range(16)),
    list(range(70000)), {f"{i:02d}": i for i in range(15)},
    {f"{i:02d}": [i, None] for i in range(16)}],
    ids=lambda o: type(o).__name__ + str(len(o) if hasattr(o, "__len__")
                                         else o)[:12])
def test_codec_plain_values_match_msgpack(obj):
  """Maps are written with sorted keys, as flax's tree copy orders
  them; these are given in that order."""
  ref = upstream_msgpack.packb(obj, use_bin_type=True)
  assert tmp.packb(obj) == ref
  back = tmp.unpackb(ref)
  assert back == obj


def test_codec_refuses_what_it_cannot_read_right(monkeypatch):
  """Leaves above flax's MAX_CHUNK_SIZE (both limits lowered to 64 bytes
  here) are written as flax's chunked maps, byte for byte, in both
  directions: a leaf in a map is chunked (the last chunk ragged), a leaf in
  a list is not, a bf16 tensor chunks by its 2-byte items; each side reads
  the other's bytes back to the same leaves. What the codec cannot read
  right still raises."""
  monkeypatch.setattr(tmp, "MAX_LEAF_BYTES", 64)
  monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
  rng = np.random.default_rng(7)
  bf16 = torch.randn(5, 9).to(torch.bfloat16)
  tree = {"Imputation": {"kernel": rng.normal(size=(9, 7)).astype(np.float32),
                         "bias": rng.normal(size=7).astype(np.float32)},
          "at_limit": np.zeros(16, np.float32),
          "ints": np.arange(70, dtype=np.int64).reshape(2, 5, 7),
          "listed": [rng.normal(size=30).astype(np.float32)],
          "scalar": np.float32(2.5)}
  data = tmp.packb(tree)
  assert data == fser.msgpack_serialize(tree)
  raw = upstream_msgpack.unpackb(data, raw=False)
  chunked = raw["Imputation"]["kernel"]
  assert list(chunked) == ["__msgpack_chunked_array__", "shape", "chunks"]
  assert chunked["shape"] == {"0": 9, "1": 7} and len(chunked["chunks"]) == 4
  assert isinstance(raw["at_limit"], upstream_msgpack.ExtType)
  assert isinstance(raw["listed"][0], upstream_msgpack.ExtType)
  _leaves_equal(tmp.unpackb(data), fser.msgpack_restore(data))
  _leaves_equal(tmp.unpackb(data), tree)
  back = tmp.unpackb(data)["Imputation"]["kernel"]
  assert back.flags.writeable and back.flags.c_contiguous
  ref = np.asarray(bf16.float().numpy(), ml_dtypes.bfloat16)
  assert tmp.packb({"b": bf16}) == fser.msgpack_serialize({"b": ref})
  assert torch.equal(tmp.unpackb(tmp.packb({"b": bf16}))["b"], bf16)
  buf = io.BytesIO()
  tmp.dump(tree, buf)
  assert buf.getvalue() == data
  data = fser.msgpack_serialize({"a": np.ones(3, np.float32)})
  with pytest.raises(ValueError, match="truncated"):
    tmp.unpackb(data[:-1])
  with pytest.raises(ValueError, match="trailing"):
    tmp.unpackb(data + b"\xc0")
  with pytest.raises(TypeError):
    tmp.packb({"a": object()})


# --------------------------------------------------------- model round trips
def _specs(RV, name):
  """(class name, outputs, kwargs) of one zoo configuration."""
  lat = dict(latents=dict(dim=4, posterior="diag", name="latents"))
  if name == "scvi_nb":
    return "SCVI", RV(G, "zinbd", name="rna"), dict(lat, n_batch=NB,
                                                     **NETS)
  if name == "scvi_label":
    return "SCVI", [RV(G, "zinbd", name="rna"), RV(P, "nb", name="adt")], \
        dict(lat, alpha=10.0, **NETS)
  if name == "totalvi":
    return "TotalVI", [RV(G, "zinbd", name="rna"),
                       RV(P, "nbd", name="adt")], dict(
                           lat, mask_protein=True, n_batch=NB, **NETS)
  if name == "scanvi":
    return "SCANVI", [RV(G, "nbd", name="rna"),
                      RV(C, "onehot", name="celltype")], dict(
                          lat, n_batch=NB, classifier={"units": [8]},
                          encoder_z2={"units": [8]},
                          decoder_z1={"units": [8]}, **NETS)
  if name.startswith("scvi"):
    return "SCVI", RV(G, "zinbd", name="rna"), dict(
        lat, dispersion=name.split("_")[1], **NETS)
  if name == "ldvae":
    return "LDVAE", RV(G, "nbd", name="rna"), dict(
        lat, encoder=NETS["encoder"])
  if name == "dca":
    return "DeepCountAutoencoder", RV(G, "zinb", name="rna"), dict(NETS)
  outs = [RV(G, "zinb", name="rna"), RV(P, "nbd" if name == "misa" else
                                        "nb", name="adt")]
  if name in ("vae", "scale", "fvae"):
    extra = {"scale": dict(n_components=3),
             "fvae": dict(discriminator_units=(8, 8, 8))}.get(name, {})
    return name.upper(), outs[0], dict(lat, **NETS, **extra)
  if name == "scale_mixtril":
    return "SCALE", outs[0], dict(NETS, latents=dict(
        dim=3, posterior="mixtril", name="latents", n_components=2))
  extra = {"scalar": dict(n_components=3),
           "sfvae": dict(discriminator_units=(8, 8, 8))}.get(name, {})
  return {"sisua": "SISUA", "misa": "MISA", "scalar": "SCALAR",
          "sfvae": "SemiFVAE"}[name], outs, dict(lat, alpha=10.0, **NETS,
                                                  **extra)


MODELS = ["scvi_single", "scvi_full", "vae", "sisua", "misa", "dca",
          "scale", "scale_mixtril", "scalar", "fvae", "sfvae", "ldvae",
          "scvi_nb", "scvi_label", "totalvi", "scanvi"]
EXTRA = dict(
    beta={"kind": "linear", "vmin": 0.0, "vmax": 2.0, "norm": 50.0,
          "delay_in": 5.0, "cyclical": True},
    dataset="toy_citeseq",
    metadata={"rna": [f"g{i}" for i in range(G)], "note": ["a", "b"],
              "batch_categories": ["donor1", "donor2", "donor3"]})


def _perturbed(tree, seed):
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map(
      lambda a: (np.asarray(a) + rng.normal(0, 0.2, a.shape)).astype(
          np.float32), jax.device_get(tree))


def _jax_model(name, **extra):
  cls, outs, kw = _specs(JRV, name)
  jm = getattr(J, cls)(outs, seed=3, **kw, **extra)
  jm._ensure_initialized()
  rng = np.random.default_rng(2)

  def stat(path, a):  # running variances stay positive
    if path[-1].key == "var":
      return (rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    return (np.asarray(a) + rng.normal(0, 0.2, a.shape)).astype(np.float32)
  bs, aux = jm.batch_stats, jm._state.aux_params
  jm._state = jm._state.replace(
      params=_perturbed(jm.params, 1),
      batch_stats=None if bs is None else jax.tree_util.tree_map_with_path(
          stat, jax.device_get(bs)),
      aux_params=None if aux is None else _perturbed(aux, 5))
  return jm


def _port_model(name, **extra):
  cls, outs, kw = _specs(TRV, name)
  tm = getattr(T, cls)(outs, device="cpu", seed=3, **kw, **extra)
  gen = torch.Generator().manual_seed(4)
  state = dict(tm.module.state_dict())
  if tm.aux is not None:
    state.update({f"aux.{k}": v for k, v in tm.aux.state_dict().items()})
  with torch.no_grad():
    for key, v in state.items():
      if key.endswith("running_var"):
        v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
      else:
        v.add_(0.2 * torch.randn(v.shape, generator=gen))
  return tm


def _x(n=N, seed=0):
  rng = np.random.default_rng(seed)
  return (rng.poisson(np.exp(rng.normal(-0.5, 1, (n, G))))
          * (rng.uniform(size=(n, G)) > 0.3)).astype(np.float32)


def _library(x):
  logc = np.log(x.sum(1) + 1e-8)
  return np.stack([np.full(len(x), logc.mean()),
                   np.full(len(x), logc.var())], 1).astype(np.float32)


def _draw(q, key):
  """The standard draws of a JAX latent's ``sample(key)`` as the port's
  ``eps``: None (deterministic), a tensor, or (component indices,
  component noise) for a mixture."""
  if isinstance(q, JD.VectorDeterministic):
    return None
  if isinstance(q, JD.MixtureSameFamily):
    kc, ks = jax.random.split(key)
    k = jax.random.categorical(kc, q.mixture_logits, axis=-1,
                               shape=tuple(q.batch_shape))
    c = q.components
    eps = jax.random.normal(ks, tuple(c.batch_shape) + tuple(c.event_shape))
    return torch.tensor(np.asarray(k)), torch.tensor(np.asarray(eps))
  return torch.tensor(np.asarray(jax.random.normal(
      key, tuple(q.batch_shape) + tuple(q.event_shape))))


def _replayed_noise(jm, x, key, out):
  """The draws of ``jm.apply``/``jm._loss`` with ``key``: both split it
  into the 'sample' and 'dropout' streams; the module splits its first
  'sample' key per latent and draws TotalVI's log β (a nuisance latent
  of ``out``) or SCANVI's z₂ from its second."""
  k_sample, k_drop = jax.random.split(key)
  variables = {"params": jm.params}
  if jm.batch_stats is not None:
    variables["batch_stats"] = jm.batch_stats
  k1, k2 = jm.module.apply(
      variables, x, rngs={"sample": k_sample, "dropout": k_drop},
      method=lambda m, *a, **k: (m.make_rng("sample"), m.make_rng("sample")))
  n = jm.n_latents
  noise = [_draw(q, k) for q, k in zip(out.latents[:n],
                                       jax.random.split(k1, n))]
  if len(out.latents) > n:
    noise.append(_draw(out.latents[n], k2))
  elif out.aux_outputs:
    noise.append(torch.tensor(np.asarray(jax.random.normal(
        k2, (jm.n_labels,) + tuple(out.latent_samples[0].shape)))))
  return noise


def _inputs(model, x):
  """x, a protein matrix (or SCANVI's cell-type one-hot) for each label
  output, and the batch one-hot of an n_batch model."""
  rng = np.random.default_rng(9)
  xs = [x]
  for rv in model.outputs[1:]:
    if rv.posterior == "onehot":
      xs.append(np.eye(rv.dim, dtype=np.float32)[
          rng.integers(0, rv.dim, len(x))])
    else:
      xs.append(rng.poisson(5.0, (len(x), rv.dim)).astype(np.float32))
  if model.n_batch:
    xs.append(np.eye(model.n_batch, dtype=np.float32)[
        rng.integers(0, model.n_batch, len(x))])
  return xs


def _assert_same_forward(jm, tm, x):
  """Eval-mode forward (output and latent means) and eval-mode loss
  metrics, at the same draws."""
  lib = _library(x)
  key = jax.random.key(7, impl="rbg")
  xs = _inputs(tm, x)
  xin = np.array(jm._module_input([jnp.asarray(a) for a in xs]))
  jout = jm.apply(jnp.asarray(xin), library=jnp.asarray(lib),
                  training=False, key=key)
  noise = _replayed_noise(jm, jnp.asarray(xin), key, jout)
  tout = tm.apply(xin, library=lib, noise=noise)
  for jp, tp in zip(jout.outputs, tout.outputs):
    assert type(tp).__name__ == type(jp).__name__
    np.testing.assert_allclose(tp.mean().detach().numpy(),
                               np.asarray(jp.mean()), **CLOSE)
  for jq, tq in zip(jout.latents, tout.latents):
    np.testing.assert_allclose(tq.mean().detach().numpy(),
                               np.asarray(jq.mean()), **CLOSE)
  for jz, tz in zip(jout.latent_samples, tout.latent_samples):
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), **CLOSE)
  batch = {"inputs": xs, "library": lib, "mask": np.ones(len(x), np.float32)}
  _, (jmet, _, jo) = jm._loss(jm.params, jm.batch_stats, jax.tree_util.tree_map(
      jnp.asarray, batch), key, 1.0, training=False)
  with torch.no_grad():
    _, tmet, _ = tm._loss(jax.tree_util.tree_map(torch.tensor, batch), False,
                          1.0, noise=_replayed_noise(jm, jnp.asarray(xin), key,
                                                     jo))
  assert set(tmet) == set(jmet)
  for k, v in jmet.items():  # EVAL_RTOL: see its comment
    np.testing.assert_allclose(float(tmet[k]), float(v), rtol=EVAL_RTOL,
                               err_msg=k)


def _assert_same_leaves(jm, tm):
  params, stats = convert.torch_to_jax(tm.module)
  aux = None if tm.aux is None else convert.torch_to_jax(tm.aux)[0]
  for jt, tt in ((jm.params, params), (jm.batch_stats, stats or None),
                 (jm._state.aux_params, aux)):
    if jt is None:
      assert tt is None
      continue
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jt))
    tl = jax.tree_util.tree_leaves_with_path(tt)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
      np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name", MODELS)
def test_jax_checkpoint_loads_in_the_port(name, tmp_path):
  jm = _jax_model(name, **EXTRA)
  jm.save_weights(str(tmp_path))
  tm = T.load_model(str(tmp_path), device="cpu")
  assert type(tm).__name__ == type(jm).__name__
  _assert_same_leaves(jm, tm)
  _assert_same_forward(jm, tm, _x())
  assert tm.name == jm.name and tm.dataset == EXTRA["dataset"]
  assert tm.metadata == EXTRA["metadata"]
  assert tm.beta == T.base.get_interpolation(EXTRA["beta"])
  assert tm.outputs == tuple(TRV(**vars(rv)) for rv in jm.outputs)
  assert tm.latents == tuple(TRV(**vars(rv)) for rv in jm.latents)


@pytest.mark.parametrize("name", MODELS)
def test_port_checkpoint_loads_in_jax(name, tmp_path):
  tm = _port_model(name, **EXTRA)
  tm.save_weights(str(tmp_path))
  jm = J.load_model(str(tmp_path))
  assert type(jm).__name__ == type(tm).__name__
  _assert_same_leaves(jm, tm)
  _assert_same_forward(jm, tm, _x(seed=1))
  assert jm.name == tm.name and jm.dataset == EXTRA["dataset"]
  assert jm.metadata == EXTRA["metadata"]
  assert jm.beta.kind == "linear" and jm.beta.cyclical
  assert [vars(r) for r in jm.encoder] == [vars(r) for r in tm.encoder]


@pytest.mark.parametrize("name", ["scvi_single", "sisua", "scale",
                                  "scalar", "fvae", "sfvae", "ldvae",
                                  "scvi_nb", "scvi_label", "totalvi",
                                  "scanvi"])
def test_both_packages_write_the_same_files(name, tmp_path):
  """JAX save → port load → port save: byte-identical weights (the
  discriminator's ``aux_params.msgpack`` too) and the same
  metamodel.json; port save → JAX load → JAX save the same."""
  jm = _jax_model(name, **EXTRA)
  jm.save_weights(str(tmp_path / "jax"))
  T.load_model(str(tmp_path / "jax"), device="cpu").save_weights(
      str(tmp_path / "port"))
  _port_model(name, **EXTRA).save_weights(str(tmp_path / "port2"))
  J.load_model(str(tmp_path / "port2")).save_weights(str(tmp_path / "jax2"))
  files = {"params.msgpack", "batch_stats.msgpack"}
  if name in ("fvae", "sfvae"):
    files.add("aux_params.msgpack")
  for a, b in (("jax", "port"), ("port2", "jax2")):
    assert files <= {p.name for p in (tmp_path / a).iterdir()}
    for f in files:
      assert (tmp_path / a / f).read_bytes() == (tmp_path / b / f).read_bytes()
  meta = [json.loads((tmp_path / d / "metamodel.json").read_text())
          for d in ("jax", "port")]
  assert meta[0] == meta[1] and meta[0]["format_version"] == 1


def test_netconf_jax_only_fields_round_trip(tmp_path):
  enc = dict(units=[16, 8], batchnorm=True, kernel_size=3,
             compute_dtype="float32", name="enc")
  jm = J.VAE(JRV(G, "zinb", name="rna"), encoder=JNetConf(
      **dict(enc, units=(16, 8))), decoder=NETS["decoder"])
  jm.save_weights(str(tmp_path / "a"))
  tm = T.load_model(str(tmp_path / "a"), device="cpu")
  assert tm.encoder[0] == TNetConf(**dict(enc, units=(16, 8)))
  tm.save_weights(str(tmp_path / "b"))
  assert (J.load_model(str(tmp_path / "b")).encoder[0]
          == JNetConf(**dict(enc, units=(16, 8))))
  d = tckpt.encode_spec(tm.encoder[0])["__netconf__"]
  assert {"use_conv", "kernel_size", "compute_dtype"} <= set(d)
  assert tckpt.decode_spec(json.loads(json.dumps(
      tckpt.encode_spec(tm.encoder[0])))) == tm.encoder[0]


def _perturbed_jax(jm):
  """``jm`` initialized, its weights and batch stats moved off the init."""
  jm._ensure_initialized()
  rng = np.random.default_rng(2)
  jm._state = jm._state.replace(
      params=_perturbed(jm.params, 1),
      batch_stats=jax.tree_util.tree_map_with_path(
          lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                        else np.asarray(a) + rng.normal(0, 0.2, a.shape)
                        ).astype(np.float32),
          jax.device_get(jm.batch_stats)))
  return jm


def _round_trips_byte_for_byte(jm, tmp_path):
  jm.save_weights(str(tmp_path / "jax"))
  tm = T.load_model(str(tmp_path / "jax"), device="cpu")
  _assert_same_leaves(jm, tm)
  tm.save_weights(str(tmp_path / "port"))
  J.load_model(str(tmp_path / "port")).save_weights(str(tmp_path / "jax2"))
  for a, b in (("jax", "port"), ("port", "jax2")):
    for f in ("params.msgpack", "batch_stats.msgpack"):
      assert (tmp_path / a / f).read_bytes() == (tmp_path / b / f).read_bytes()
  meta = [json.loads((tmp_path / d / "metamodel.json").read_text())
          for d in ("jax", "port")]
  assert meta[0] == meta[1]
  return tm


def test_bf16_checkpoint_round_trips(tmp_path):
  """A JAX checkpoint saved with ``compute_dtype='bfloat16'`` loads in the
  port with its compute dtype (float32 parameters, as flax keeps them)
  and saves back byte for byte, both ways."""
  jm = _perturbed_jax(J.VAE(JRV(G, "zinb", name="rna"),
                            compute_dtype="bfloat16", **NETS))
  tm = _round_trips_byte_for_byte(jm, tmp_path)
  assert tm.compute_dtype == "bfloat16"
  assert all(e.compute_dtype == "bfloat16" for e in tm.encoder + tm.decoder)
  assert all(p.dtype == torch.float32 for p in tm.module.parameters())
  assert J.load_model(str(tmp_path / "port")).compute_dtype == "bfloat16"


def test_use_conv_checkpoint_round_trips(tmp_path):
  """A JAX ``use_conv`` encoder (flax ``conv{i}`` kernels (k, in, out), the
  port's (out, in, k)) loads in the port, serves the JAX forward and loss
  at the same draws, and saves back byte for byte."""
  enc = dict(units=(6, 4), batchnorm=True, use_conv=True, kernel_size=3,
             name="encoder")
  jm = _perturbed_jax(J.VAE(JRV(G, "zinb", name="rna"),
                            encoder=JNetConf(**enc),
                            decoder=NETS["decoder"]))
  tm = _round_trips_byte_for_byte(jm, tmp_path)
  assert tm.encoder[0] == TNetConf(**enc)
  assert tuple(tm.module.encoder0.conv0.weight.shape) == (6, 1, 3)
  _assert_same_forward(jm, tm, _x())


def test_history_json_read_back(tmp_path):
  jm = _jax_model("vae")
  jm._loaded_history = {"loss": [3.5, 2.25], "val_loss": [4.0]}
  jm.save_weights(str(tmp_path / "jax"))
  tm = T.load_model(str(tmp_path / "jax"), device="cpu")
  assert tm.history == {"loss": [3.5, 2.25], "val_loss": [4.0]}
  x = _x(64)
  # a fitted model keeps its own
  tm.fit(x, epochs=2, batch_size=32, device_cache=True)
  assert len(tm.history["loss"]) == 2
  tm.save_weights(str(tmp_path / "port"))
  fitted = tm.history
  assert T.load_model(str(tmp_path / "port"), device="cpu").history \
      == fitted
  assert J.load_model(str(tmp_path / "port")).history == fitted
  # a fitted model loading weights keeps its own history
  assert tm.load_weights(str(tmp_path / "jax")).history["loss"] \
      == fitted["loss"]


def test_mismatched_checkpoint_names_the_first_leaf(tmp_path):
  tm = _port_model("vae")
  tm.save_weights(str(tmp_path))
  wider = T.VAE(TRV(G, "zinb", name="rna"), device="cpu",
                latents=dict(dim=4, posterior="diag", name="latents"),
                encoder={"units": [32, 32], "batchnorm": True},
                decoder={"units": [32, 48], "batchnorm": True})
  with pytest.raises(ValueError, match=r"params/decoder0/bn1/bias"):
    wider.load_weights(str(tmp_path))
  other = T.VAE(TRV(G, "zinb", name="rna"), device="cpu",
                latents=dict(dim=4, posterior="diag", name="z"), **NETS)
  with pytest.raises(KeyError, match=r"params/latent_head_latents"):
    other.load_weights(str(tmp_path))
  before = {k: v.clone() for k, v in other.module.state_dict().items()}
  assert other.load_weights(str(tmp_path / "nothing")) is other
  assert all(torch.equal(v, before[k])
             for k, v in other.module.state_dict().items())
  with pytest.raises(FileNotFoundError):
    other.load_weights(str(tmp_path / "nothing"), raise_notfound=True)


def test_unported_backends_raise(tmp_path):
  tm = _port_model("dca")
  with pytest.raises(NotImplementedError, match="orbax"):
    tm.save_weights(str(tmp_path / "o"), backend="orbax")
  assert not (tmp_path / "o").exists()
  (tmp_path / "ob" / "orbax").mkdir(parents=True)
  with pytest.raises(NotImplementedError, match="orbax"):
    tm.load_weights(str(tmp_path / "ob"))
  # aux_params round trip, checked leaf by leaf against its template
  aux = {"dense0": {"bias": np.arange(3, dtype=np.float32),
                    "kernel": np.ones((2, 3), np.float32)}}
  tckpt.save_weights(str(tmp_path / "a"), {"w": np.zeros(2, np.float32)},
                     aux_params=aux)
  assert (tmp_path / "a" / "aux_params.msgpack").read_bytes() \
      == fser.msgpack_serialize(aux)
  _, _, back = tckpt.load_weights(str(tmp_path / "a"),
                                  {"w": np.zeros(2, np.float32)}, None, aux)
  _leaves_equal(aux, back)
  with pytest.raises(ValueError, match=r"aux_params/dense0/kernel"):
    tckpt.load_weights(str(tmp_path / "a"), {"w": np.zeros(2, np.float32)},
                       None, {"dense0": {"bias": aux["dense0"]["bias"],
                                         "kernel": np.ones((3, 3))}})
  with pytest.raises(ValueError, match="among the ported"):
    T.get_model("NoSuchModel")
  assert set(T.get_all_models()) == {
      T.VAE, T.SISUA, T.MISA, T.SCVI, T.DeepCountAutoencoder, T.LDVAE,
      T.SCALE, T.SCALAR, T.FVAE, T.SemiFVAE, T.TotalVI, T.SCANVI, T.PEAKVI,
      T.MULTIVI, T.SCScope, T.AUTOZI}
  assert sorted(c.__name__ for c in T.get_all_models()) \
      == sorted(c.__name__ for c in J.get_all_models())


def test_constructor_takes_the_jax_kwargs():
  tm = T.SISUA([TRV(G, "zinb", name="rna"), TRV(P, "nb", name="adt")],
               device="cpu", gamma=6.0, name="mine", batch_key="donor",
               prng="threefry2x32", compute_dtype="float32",
               dataset="d", metadata={"adt": ["p"]})
  assert (tm.name, tm.id, tm.gamma, tm.batch_key, tm.prng) == (
      "mine", "sisua", 6.0, "donor", "threefry2x32")
  assert (tm.n_outputs, tm.n_latents, tm.is_zero_inflated) == (2, 1, True)
  assert tm.posteriors == tm.outputs
  assert T.DeepCountAutoencoder(TRV(G, "zinb"), device="cpu").name \
      == "deep_count_autoencoder"

  class SCO:
    name = "pbmc"
    omics = ("rna", "adt")

    def get_var_names(self, om):
      return np.array([f"{om}{i}" for i in range(2)])
  tm.set_metadata(SCO())
  assert tm.dataset == "pbmc"
  assert tm.metadata == {"adt": ["adt0", "adt1"], "rna": ["rna0", "rna1"]}


_BLOCKER = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas",
           "sisua_tpu")
class Block(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path, target=None):
    if name.split(".")[0] in BLOCKED:
      raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import pkgutil, sisua_tpu_torch
for m in pkgutil.walk_packages(sisua_tpu_torch.__path__, "sisua_tpu_torch."):
  __import__(m.name)
from sisua_tpu_torch.models import SISUA, RVmeta, load_model
import numpy as np, tempfile
m = SISUA([RVmeta(20, "zinb", name="rna"), RVmeta(3, "nb", name="adt")],
          device="cpu")
d = tempfile.mkdtemp()
m.save_weights(d)
x = np.random.default_rng(0).poisson(1.0, (10, 20)).astype(np.float32)
print(load_model(d, device="cpu").predict_mean(x)[0][0].shape)
print(sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED))
"""


def test_port_imports_no_jax_flax_msgpack_pandas():
  env = dict(os.environ)
  env["PYTHONPATH"] = os.pathsep.join(
      [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
      + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
  r = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                     capture_output=True, text=True, timeout=300)
  assert r.returncode == 0, r.stderr[-3000:]
  assert r.stdout.split("\n")[:2] == ["(10, 20)", "[]"], r.stdout
