"""The port's host data path against the JAX package's: the ``DataFeeder``,
the native gathers, the CSR triplets and the device densify.

* ``DataFeeder``: the same arrays as ``sisua_tpu.data.feeder.DataFeeder``,
  exactly, over two epochs (dense and CSR sources, ``labels_percent``, the
  library, ``drop_remainder=False``, ``iter_chunks``, ``full_batches``,
  ``transfer_dtype='int16'``): both draw from the same numpy streams.
* ``native``: ``csr_gather``/``dense_gather`` equal the numpy versions and
  scipy's row indexing exactly (they copy values).
* ``csr_row_triplets``: byte-equal to the JAX function, for ``rows=None``
  and for gathered rows.
* ``densify``: equal to the JAX ``make_densify`` exactly for float32, int16
  and bfloat16, with a duplicated column and padding (each position gets
  at most two adds, so the sum order cannot differ).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from sisua_tpu.data.feeder import DataFeeder as JFeeder
from sisua_tpu.ops import sparse as jsparse
from sisua_tpu_torch import native
from sisua_tpu_torch.data.feeder import DataFeeder
from sisua_tpu_torch.ops import sparse as tsparse
from torch_port_threads import _one_thread  # noqa: F401


N, D, P = 203, 37, 5


def _data(seed=0, density=0.3):
  rng = np.random.default_rng(seed)
  x = (rng.poisson(2.0, (N, D)) * (rng.uniform(size=(N, D)) < density)
       ).astype(np.float32)
  y = rng.poisson(5.0, (N, P)).astype(np.float32)
  lib = rng.normal(size=(N, 2)).astype(np.float32)
  return x, y, lib


def _same(a, b):
  """Two feeders' batches: equal keys, dtypes and arrays."""
  assert sorted(a) == sorted(b)
  for xa, xb in zip(a["inputs"], b["inputs"]):
    assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
  for k in ("mask", "library"):
    if k in a:
      assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("sparse_src", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("drop", [True, False], ids=["drop", "keep"])
def test_feeder_yields_jaxs_batches(sparse_src, drop):
  x, y, lib = _data()
  mats = [sp.csr_matrix(x) if sparse_src else x, y]
  kw = dict(library=lib, labels_percent=0.4, batch_size=32,
            drop_remainder=drop, seed=7)
  jf, tf = JFeeder(mats, **kw), DataFeeder(mats, **kw)
  assert len(tf) == len(jf) and tf.input_dims == jf.input_dims
  for epoch in range(2):
    jb, tb = list(jf.set_epoch(epoch)), list(tf.set_epoch(epoch))
    assert len(tb) == len(jb) == len(jf)
    for a, b in zip(tb, jb):
      _same(a, b)
  assert np.array_equal(tf._run_mask(), jf._run_mask())


def test_feeder_chunks_full_batches_and_int16():
  x, y, lib = _data(seed=1)
  mats = [sp.csr_matrix(x), y]
  jf = JFeeder(mats, library=lib, labels_percent=0.5, batch_size=16)
  tf = DataFeeder(mats, library=lib, labels_percent=0.5, batch_size=16)
  assert tf.n_chunks(3) == jf.n_chunks(3)
  for _ in range(2):  # whole epochs: each generator advances its epoch
    for a, b in zip(list(tf.iter_chunks(3)), list(jf.iter_chunks(3))):
      _same(a, b)
  for a, b in zip(tf.full_batches(50), jf.full_batches(50)):
    _same(a, b)
  for f in (jf, tf):
    f.set_transfer_dtype("int16")
  assert tf.transfer_dtype == jf.transfer_dtype == np.int16
  for a, b in zip(list(tf.set_epoch(3)), list(jf.set_epoch(3))):
    _same(a, b)
  frac = [x + 0.5]
  assert DataFeeder(frac).set_transfer_dtype("auto").transfer_dtype is None
  with pytest.raises(ValueError, match="int16"):
    DataFeeder(frac).set_transfer_dtype("int16")


def test_unshuffled_and_tensor_sources():
  """``shuffle=False`` walks the rows in order; a torch tensor source
  gathers the same rows as its numpy array."""
  x, _, lib = _data(seed=2)
  tf = DataFeeder([torch.tensor(x)], library=lib, batch_size=40,
                  shuffle=False)
  nf = DataFeeder([x], library=lib, batch_size=40, shuffle=False)
  for a, b in zip(tf, nf):
    _same(a, b)
  first = next(iter(DataFeeder([x], batch_size=40, shuffle=False)))
  assert np.array_equal(first["inputs"][0], x[:40])


def test_native_gathers_match_numpy_and_scipy():
  x, _, _ = _data(seed=3, density=0.2)
  m = sp.csr_matrix(x)
  m.data = m.data.astype(np.float64)  # scipy's default dtypes, coerced
  rows = np.random.default_rng(0).integers(0, N, 77)
  got = native.csr_gather(m.data, m.indices, m.indptr, rows, D)
  assert got.dtype == np.float32 and np.array_equal(got, m[rows].toarray())
  assert np.array_equal(got, native.csr_gather_ref(m.data, m.indices,
                                                   m.indptr, rows, D))
  lg = native.csr_gather(m.data, m.indices, m.indptr, rows, D, log1p=True)
  assert np.array_equal(lg, native.csr_gather_ref(
      m.data, m.indices, m.indptr, rows, D, log1p=True))
  out = np.full((len(rows), D), 7.0, np.float32)
  assert native.dense_gather(x, rows, out=out) is out
  assert np.array_equal(out, x[rows])
  assert np.array_equal(out, native.dense_gather_ref(x, rows))
  with pytest.raises(ValueError, match="C-contiguous float32"):
    native.dense_gather(x, rows, out=np.empty((len(rows), D), np.float64))
  with pytest.raises(IndexError):
    native.dense_gather(x, [N])


@pytest.mark.parametrize("gathered", [False, True], ids=["all", "rows"])
def test_csr_row_triplets_byte_equal(gathered):
  x, _, _ = _data(seed=4)
  m = sp.csr_matrix(x)
  rows = (np.random.default_rng(1).permutation(N)[:64] if gathered
          else None)
  n_rows = 64 if gathered else N + 9
  nnz = (int(np.diff(m.indptr)[rows].sum()) if gathered else m.nnz)
  cap = nnz + 13
  for vd in (np.float32, np.int16):
    args = (m.indptr.astype(np.int64), m.indices.astype(np.int64),
            m.data.astype(np.float32), rows, cap, n_rows, vd,
            tsparse.col_dtype_for(D))
    for t, j in zip(tsparse.csr_row_triplets(*args),
                    jsparse.csr_row_triplets(*args)):
      assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
  assert tsparse.col_dtype_for(70_000) == jsparse.col_dtype_for(70_000)
  for args in ((100, 64, 2000, 4, 4), (200_000, 64, 2000, 4, 4),
               (10, 8, 70_000, 2, 2)):
    assert tsparse.worthwhile(*args) == jsparse.worthwhile(*args)


@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16"])
def test_densify_matches_jax(dtype):
  """Three rows, the middle one empty, a column repeated in row 0 (CSR may
  hold duplicates: the densify adds them) and three padding entries."""
  vals = np.array([1.5, 2.0, 3.0, 4.0, 0, 0, 0], np.float32)
  if dtype == "int16":
    vals = vals.round().astype(np.int16)
  cols = np.array([5, 5, 0, 6, 0, 0, 0], np.uint16)
  rowlen = np.array([2, 0, 2], np.int32)
  jdt = {"float32": jnp.float32, "int16": jnp.int16,
         "bfloat16": jnp.bfloat16}[dtype]
  ref = jsparse.make_densify(3, 7, len(vals), jdt)(
      jnp.asarray(vals).astype(jdt), jnp.asarray(cols), jnp.asarray(rowlen))
  tdt = getattr(torch, dtype)
  got = tsparse.densify(torch.from_numpy(vals).to(tdt),
                        torch.from_numpy(cols.view(np.int16)),
                        torch.from_numpy(rowlen), 7, tdt)
  assert got.dtype == tdt and got.shape == (3, 7)
  assert np.array_equal(got.float().numpy(),
                        np.asarray(ref.astype(jnp.float32)))
  # the same block from host triplets, copied and scattered 2 at a time,
  # and a uint16 column above 32,767 through its int16 bits
  pieces = tsparse.densify(torch.from_numpy(vals).to(tdt),
                           torch.from_numpy(cols.view(np.int16)),
                           torch.from_numpy(rowlen), 7, tdt, "cpu", piece=2)
  assert torch.equal(pieces, got)
  high = tsparse.densify(torch.tensor([3.0]), torch.from_numpy(
      np.array([40_000], np.uint16).view(np.int16)),
      torch.tensor([1], dtype=torch.int32), 40_001, torch.float32)
  assert high[0, 40_000] == 3.0 and high.sum() == 3.0
  # the column ids of wide matrices travel as int32
  wide = tsparse.densify(torch.tensor([1.0, 2.0]),
                         torch.tensor([70_000, 3], dtype=torch.int32),
                         torch.tensor([1, 1], dtype=torch.int32), 70_001,
                         torch.float32)
  assert wide[0, 70_000] == 1.0 and wide[1, 3] == 2.0 and wide.sum() == 3.0
