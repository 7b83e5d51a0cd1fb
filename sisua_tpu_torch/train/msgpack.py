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
tensor, and a bf16 tensor writes as one. flax splits leaves above 2^30
bytes into ``{'__msgpack_chunked_array__': True, …}`` maps; the reader
refuses such a map rather than misread it, and the writer refuses such
a leaf.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["packb", "unpackb", "MAX_LEAF_BYTES"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
#: flax's MAX_CHUNK_SIZE: larger leaves are written chunked by flax
MAX_LEAF_BYTES = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writing
def _header(out: bytearray, n: int, fix: int, fix_max: int,
            codes: Tuple[int, ...]) -> None:
  """Length header: the fix form below ``fix_max``, else 8/16/32-bit (the
  first code may be 0 where the type has no 8-bit form)."""
  if n < fix_max:
    out.append(fix | n)
  elif n <= 0xFF and codes[0]:
    out += bytes((codes[0], n))
  elif n <= 0xFFFF:
    out.append(codes[1])
    out += struct.pack(">H", n)
  else:
    out.append(codes[2])
    out += struct.pack(">I", n)


def _pack_int(out: bytearray, x: int) -> None:
  if 0 <= x < 0x80 or -32 <= x < 0:
    out += struct.pack(">b" if x < 0 else ">B", x)
  elif 0 <= x:
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                           (0xCE, ">I", 0xFFFFFFFF),
                           (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
      if x <= top:
        out.append(code)
        out += struct.pack(fmt, x)
        return
    raise OverflowError(f"{x} does not fit msgpack's uint64")
  else:
    for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                           (0xD2, ">i", -0x80000000),
                           (0xD3, ">q", -0x8000000000000000)):
      if x >= low:
        out.append(code)
        out += struct.pack(fmt, x)
        return
    raise OverflowError(f"{x} does not fit msgpack's int64")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
  n = len(data)
  fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
  if n in fixed:
    out.append(fixed[n])
  elif n <= 0xFF:
    out += bytes((0xC7, n))
  elif n <= 0xFFFF:
    out.append(0xC8)
    out += struct.pack(">H", n)
  else:
    out.append(0xC9)
    out += struct.pack(">I", n)
  out.append(code)
  out += data


def _payload(shape, name: str, data: bytes) -> bytes:
  """msgpack of (shape, dtype name, C-order bytes): an array leaf."""
  if len(data) > MAX_LEAF_BYTES:
    raise ValueError(f"array leaf of {len(data)} bytes: flax writes leaves "
                     f"above {MAX_LEAF_BYTES} bytes chunked, which this "
                     "codec does not")
  return packb([list(shape), name, data])


def _array_payload(x) -> bytes:
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
      return _payload(x.shape, "bfloat16",
                      x.view(torch.int16).numpy().tobytes())
    x = x.numpy()
  if x.dtype.hasobject or x.dtype.fields is not None:
    raise ValueError(f"cannot serialize an array of dtype {x.dtype}")
  return _payload(x.shape, x.dtype.name, x.tobytes("C"))


def _pack(obj: Any, out: bytearray) -> None:
  t = type(obj)
  if obj is None:
    out.append(0xC0)
  elif t is bool:
    out.append(0xC3 if obj else 0xC2)
  elif t is int:
    _pack_int(out, obj)
  elif t is float:
    out.append(0xCB)
    out += struct.pack(">d", obj)
  elif t is str:
    data = obj.encode("utf-8")
    _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out += data
  elif t in (bytes, bytearray, memoryview):
    data = bytes(obj)
    _header(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
    out += data
  elif t in (list, tuple):
    _header(out, len(obj), 0x90, 16, (0, 0xDC, 0xDD))
    for v in obj:
      _pack(v, out)
  elif t is dict:
    _header(out, len(obj), 0x80, 16, (0, 0xDE, 0xDF))
    for k, v in sorted(obj.items()):
      _pack(k, out)
      _pack(v, out)
  elif isinstance(obj, (np.ndarray, torch.Tensor)):
    _pack_ext(out, _EXT_NDARRAY, _array_payload(obj))
  elif isinstance(obj, np.generic):
    _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(obj)))
  else:
    raise TypeError(f"cannot serialize {t.__name__} to msgpack")


def packb(obj: Any) -> bytes:
  """``flax.serialization.msgpack_serialize`` of a state dict: nested dicts
  with str keys and array, numpy-scalar or plain leaves. Map keys are
  written sorted, as the pytree copy that function (and the
  ``jax.device_get`` before ``to_bytes`` in the JAX checkpoint) makes."""
  out = bytearray()
  _pack(obj, out)
  return bytes(out)


# ------------------------------------------------------------------ reading
def _array_from_payload(data: bytes, scalar: bool):
  shape, name, buf = unpackb(data)
  if name == "bfloat16":
    arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
    arr = arr.reshape(tuple(shape))
  else:
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(
        tuple(shape)).copy()
  return arr[()] if scalar else arr


class _Reader:

  def __init__(self, data: bytes):
    self.data = memoryview(data)
    self.pos = 0

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
      return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H",
                                          0xC6: ">I"}[b])))
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
    if _CHUNKED in out:
      raise ValueError("chunked array leaf (flax splits leaves above 2^30 "
                       "bytes): not supported by this reader")
    return out

  def ext(self, n: int):
    code = struct.unpack(">b", self.take(1))[0]
    data = bytes(self.take(n))
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
      raise ValueError(f"unsupported msgpack ext type {code}")
    return _array_from_payload(data, scalar=code == _EXT_NPSCALAR)


def unpackb(data: bytes) -> Any:
  """``flax.serialization.msgpack_restore``: maps become dicts, arrays
  lists, ext 1/3 numpy arrays and scalars (bf16 as torch tensors)."""
  reader = _Reader(data)
  out = reader.read()
  if reader.pos != len(reader.data):
    raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after "
                     "the msgpack object")
  return out
