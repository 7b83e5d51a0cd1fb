"""The msgpack subset that flax's ``serialization.to_bytes`` and
``from_bytes`` write and read (``sisua_tpu/train/checkpoint.py:76,94``),
self-contained: the port needs neither ``msgpack`` nor ``flax``.

flax packs a state dict, nested maps with str keys, through
``msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)``:

  * nil, bool, int, float (always float 64), str, bin, array and map in
    their smallest msgpack form;
  * an array leaf is ext type 1 whose payload is the msgpack of
    ``(shape, dtype name, C-order bytes)``;
  * a numpy scalar is ext type 3, the same payload at shape ().

``packb`` writes exactly those bytes, so a tree flax wrote reads back
leaf for leaf and a tree written here is the file flax would write.
numpy has no bfloat16: a 'bfloat16' leaf reads as a ``torch.bfloat16``
tensor, and a bf16 tensor writes as one.

Leaves above ``MAX_LEAF_BYTES`` (flax's ``MAX_CHUNK_SIZE``, 2^30 bytes) are
written as flax's ``_chunk`` writes them, when they sit in a map (flax's
``_chunk_array_leaves_in_place``): a map, in this key order,
``{'__msgpack_chunked_array__': True, 'shape': {'0': d0, …}, 'chunks':
{'0': …, '1': …}}`` whose chunks are the C-order flat slices of
``MAX_LEAF_BYTES // itemsize`` elements, each an array leaf. The reader
turns such a map back into one array, as flax's ``_unchunk``. ``dump``
streams the bytes to a file: each chunk goes out as a view of the leaf,
so a leaf of several GB is never copied whole on the host.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable, Tuple

import numpy as np
import torch

__all__ = ["packb", "dump", "unpackb", "MAX_LEAF_BYTES"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
#: flax's MAX_CHUNK_SIZE: larger leaves in a map are written chunked
MAX_LEAF_BYTES = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_Write = Callable[[Any], Any]


# ------------------------------------------------------------------ writing
def _header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> bytes:
  """Length header: the fix form below ``fix_max``, else 8/16/32-bit (the
  first code may be 0 where the type has no 8-bit form)."""
  if n < fix_max:
    return bytes((fix | n,))
  if n <= 0xFF and codes[0]:
    return bytes((codes[0], n))
  if n <= 0xFFFF:
    return bytes((codes[1],)) + struct.pack(">H", n)
  return bytes((codes[2],)) + struct.pack(">I", n)


def _int_bytes(x: int) -> bytes:
  if 0 <= x < 0x80 or -32 <= x < 0:
    return struct.pack(">b" if x < 0 else ">B", x)
  if 0 <= x:
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                           (0xCE, ">I", 0xFFFFFFFF),
                           (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
      if x <= top:
        return bytes((code,)) + struct.pack(fmt, x)
    raise OverflowError(f"{x} does not fit msgpack's uint64")
  for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                         (0xD2, ">i", -0x80000000),
                         (0xD3, ">q", -0x8000000000000000)):
    if x >= low:
      return bytes((code,)) + struct.pack(fmt, x)
  raise OverflowError(f"{x} does not fit msgpack's int64")


def _ext_header(code: int, n: int) -> bytes:
  fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
  if n in fixed:
    head = bytes((fixed[n],))
  elif n <= 0xFF:
    head = bytes((0xC7, n))
  elif n <= 0xFFFF:
    head = bytes((0xC8,)) + struct.pack(">H", n)
  elif n <= 0xFFFFFFFF:
    head = bytes((0xC9,)) + struct.pack(">I", n)
  else:
    raise ValueError(f"ext payload of {n} bytes exceeds msgpack's 2^32")
  return head + struct.pack(">b", code)


def _as_numpy(x) -> Tuple[np.ndarray, str]:
  """(C-contiguous numpy array, dtype name) of an array leaf; a bf16
  tensor as its int16 bits under the name 'bfloat16'."""
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
      return x.view(torch.int16).numpy(), "bfloat16"
    x = x.numpy()
  if x.dtype.hasobject or x.dtype.fields is not None:
    raise ValueError(f"cannot serialize an array of dtype {x.dtype}")
  return (x if x.flags.c_contiguous else x.copy(order="C")), x.dtype.name


def _write_array(code: int, x: np.ndarray, name: str, write: _Write) -> None:
  """Ext ``code`` whose payload is the msgpack of (shape, dtype name,
  C-order bytes); the bytes go out as a view of ``x``."""
  data = memoryview(x.reshape(-1).view(np.uint8))
  parts = [bytes((0x93,))]
  _pack(list(x.shape), parts.append)
  _pack(name, parts.append)
  parts.append(_header(len(data), 0, 0, (0xC4, 0xC5, 0xC6)))
  prefix = b"".join(parts)
  write(_ext_header(code, len(prefix) + len(data)))
  write(prefix)
  write(data)


def _write_chunked(x: np.ndarray, name: str, write: _Write) -> None:
  """flax's ``_chunk``: shape and flat C-order chunks of MAX_LEAF_BYTES,
  keys in flax's insertion order (not sorted), each chunk a view."""
  size = max(1, int(MAX_LEAF_BYTES / x.dtype.itemsize))
  flat = x.reshape(-1)
  starts = range(0, flat.size, size)
  write(bytes((0x83,)))
  _pack(_CHUNKED, write)
  _pack(True, write)
  _pack("shape", write)
  write(_header(len(x.shape), 0x80, 16, (0, 0xDE, 0xDF)))
  for i, d in enumerate(x.shape):
    _pack(str(i), write)
    _pack(int(d), write)
  _pack("chunks", write)
  write(_header(len(starts), 0x80, 16, (0, 0xDE, 0xDF)))
  for i, lo in enumerate(starts):
    _pack(str(i), write)
    _write_array(_EXT_NDARRAY, flat[lo:lo + size], name, write)


def _pack(obj: Any, write: _Write, in_map: bool = False) -> None:
  """Write ``obj``; ``in_map``: a map's value (or the root), where flax
  chunks an array leaf above MAX_LEAF_BYTES."""
  t = type(obj)
  if obj is None:
    write(b"\xc0")
  elif t is bool:
    write(b"\xc3" if obj else b"\xc2")
  elif t is int:
    write(_int_bytes(obj))
  elif t is float:
    write(b"\xcb" + struct.pack(">d", obj))
  elif t is str:
    data = obj.encode("utf-8")
    write(_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data)
  elif t in (bytes, bytearray, memoryview):
    data = bytes(obj)
    write(_header(len(data), 0, 0, (0xC4, 0xC5, 0xC6)) + data)
  elif t in (list, tuple):
    write(_header(len(obj), 0x90, 16, (0, 0xDC, 0xDD)))
    for v in obj:
      _pack(v, write)
  elif t is dict:
    write(_header(len(obj), 0x80, 16, (0, 0xDE, 0xDF)))
    for k, v in sorted(obj.items()):
      _pack(k, write)
      _pack(v, write, in_map=True)
  elif isinstance(obj, (np.ndarray, torch.Tensor)):
    x, name = _as_numpy(obj)
    if in_map and x.nbytes > MAX_LEAF_BYTES:
      _write_chunked(x, name, write)
    else:
      _write_array(_EXT_NDARRAY, x, name, write)
  elif isinstance(obj, np.generic):
    x, name = _as_numpy(np.asarray(obj))
    _write_array(_EXT_NPSCALAR, x, name, write)
  else:
    raise TypeError(f"cannot serialize {t.__name__} to msgpack")


def packb(obj: Any) -> bytes:
  """``flax.serialization.msgpack_serialize`` of a state dict: nested dicts
  with str keys and array, numpy-scalar or plain leaves. Map keys are
  written sorted, as the pytree copy that function (and the
  ``jax.device_get`` before ``to_bytes`` in the JAX checkpoint) makes."""
  parts = []
  _pack(obj, parts.append, in_map=True)
  return b"".join(parts)


def dump(obj: Any, f: BinaryIO) -> None:
  """``packb(obj)`` written to the binary file ``f`` piece by piece."""
  _pack(obj, f.write, in_map=True)


# ------------------------------------------------------------------ reading
def _array_from_payload(data: memoryview, scalar: bool):
  """An ext array leaf: a read-only numpy view of ``data`` (``unpackb``
  copies it, or joins a chunked leaf's views), a numpy scalar, or a bf16
  tensor."""
  reader = _Reader(data, raw_bin=True)
  shape, name, buf = reader.read()
  if reader.pos != len(data):
    raise ValueError("trailing bytes in an array leaf")
  if name == "bfloat16":
    arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
    arr = arr.reshape(tuple(shape))
  else:
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(tuple(shape))
  return arr[()] if scalar else arr


class _Reader:

  def __init__(self, data, raw_bin: bool = False):
    self.data = memoryview(data)
    self.pos = 0
    self.raw_bin = raw_bin  # bin as a view (an array leaf's bytes)

  def take(self, n: int) -> memoryview:
    if self.pos + n > len(self.data):
      raise ValueError("truncated msgpack data")
    view = self.data[self.pos:self.pos + n]
    self.pos += n
    return view

  def unpack(self, fmt: str):
    return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

  def read(self) -> Any:
    b = self.take(1)[0]
    if b <= 0x7F:
      return b
    if b >= 0xE0:
      return b - 0x100
    if 0x80 <= b <= 0x8F:
      return self.map(b & 0x0F)
    if 0x90 <= b <= 0x9F:
      return [self.read() for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
      return str(self.take(b & 0x1F), "utf-8")
    if b == 0xC0:
      return None
    if b in (0xC2, 0xC3):
      return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
      data = self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
      return data if self.raw_bin else bytes(data)
    if b in (0xC7, 0xC8, 0xC9):
      return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
    if 0xD4 <= b <= 0xD8:
      return self.ext(1 << (b - 0xD4))
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
      return self.unpack(fixed[b])
    if b in (0xD9, 0xDA, 0xDB):
      n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
      return str(self.take(n), "utf-8")
    if b in (0xDC, 0xDD):
      n = self.unpack(">H" if b == 0xDC else ">I")
      return [self.read() for _ in range(n)]
    if b in (0xDE, 0xDF):
      return self.map(self.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

  def map(self, n: int) -> dict:
    out = {}
    for _ in range(n):
      k = self.read()
      out[k] = self.read()
    return out

  def ext(self, n: int):
    code = struct.unpack(">b", self.take(1))[0]
    data = self.take(n)
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
      raise ValueError(f"unsupported msgpack ext type {code}")
    return _array_from_payload(data, scalar=code == _EXT_NPSCALAR)


def _unchunk(d: dict):
  """flax's ``_unchunk``: the chunks joined (one copy) in ``shape``."""
  shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
  chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
  if chunks and isinstance(chunks[0], torch.Tensor):
    return torch.cat(chunks).reshape(shape)
  return np.concatenate(chunks).reshape(shape)


def _settle(obj: Any, unchunk: bool = True) -> Any:
  """Chunked maps reached through maps from the root joined into one array
  (flax's ``_unchunk_array_leaves_in_place``, which enters no list);
  every other array view copied, so nothing holds the read buffer."""
  if isinstance(obj, dict):
    if unchunk and _CHUNKED in obj:
      return _unchunk(obj)
    return {k: _settle(v, unchunk) for k, v in obj.items()}
  if isinstance(obj, list):
    return [_settle(v, False) for v in obj]
  if isinstance(obj, np.ndarray):
    return obj.copy()
  return obj


def unpackb(data: bytes) -> Any:
  """``flax.serialization.msgpack_restore``: maps become dicts, arrays
  lists, ext 1/3 numpy arrays and scalars (bf16 as torch tensors), and
  chunked leaves one array each."""
  reader = _Reader(data)
  out = reader.read()
  if reader.pos != len(reader.data):
    raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after "
                     "the msgpack object")
  return _settle(out)
