"""A YAML reader and writer of the port's own (the card has no PyYAML).

``safe_load`` reads what the experiment configs use, and what
``yaml.safe_dump`` writes: block mappings and sequences (a sequence under
a key may sit at the key's indent), flow mappings and sequences
(``{units: [64, 64], batchnorm: true}``), comments, and plain,
single-quoted and double-quoted scalars. Plain scalars resolve as
PyYAML's YAML 1.1 resolver does: ``1.0e-3`` is a float but ``1e-3`` a
string (its float pattern wants a dot); ``true``/``yes``/``on`` and their
negations are booleans; ``null``, ``~`` and the empty scalar are None;
``.inf`` and ``.nan`` floats; decimal integers, ``_`` separators
allowed. Keys resolve the same way. What the configs never use raises
``YAMLError``: the scalars PyYAML reads as binary, octal, hexadecimal or
base-60 numbers or as timestamps (``0x1F``, ``017``, ``1:30``,
``2001-12-14``), block scalars (``|``, ``>``), anchors, aliases, tags and
scalars that span lines. So whatever the reader accepts, it reads as
``yaml.safe_load`` does. ``safe_dump`` quotes those scalars, and writes a
string with a line break double-quoted on one line.

``safe_dump`` writes nested dicts, lists, strings, numbers, booleans and
None the way ``yaml.safe_dump`` does by default (sorted keys, block
style, a sequence at its key's indent, floats as PyYAML represents them,
strings quoted only where a plain one would read back otherwise), so
PyYAML reads the result back to the same object.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["safe_load", "safe_dump", "YAMLError"]


class YAMLError(ValueError):
  pass


# ---------------------------------------------------------------------------
# PyYAML's implicit resolvers (resolver.py, YAML 1.1)
# ---------------------------------------------------------------------------
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# what PyYAML resolves to a binary, octal, hexadecimal or base-60 number or
# to a timestamp: no config uses these forms, so the reader refuses them
_REFUSED = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?
     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}


def _construct_float(s: str) -> float:
  v = s.replace("_", "").lower()
  if v.lstrip("+-") == ".inf":
    return -math.inf if v[0] == "-" else math.inf
  if v == ".nan":
    return math.nan
  return float(v)


def _resolve(s: str) -> Any:
  """A plain scalar as PyYAML's safe loader constructs it."""
  if _NULL.match(s):
    return None
  if _BOOL.match(s):
    return _BOOL_VALUES[s.lower()]
  if _INT.match(s):
    return int(s.replace("_", ""))
  if _FLOAT.match(s):
    return _construct_float(s)
  if _REFUSED.match(s):
    raise YAMLError(f"{s!r}: binary, octal, hexadecimal and base-60 "
                    "numbers and timestamps are not read; quote it")
  return s


# ---------------------------------------------------------------------------
# scalars and flow collections within one logical line
# ---------------------------------------------------------------------------
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Scanner:
  """Cursor over one logical line: quoted scalars, plain scalars and
  flow collections."""

  def __init__(self, text: str, where: str):
    self.s = text
    self.i = 0
    self.where = where

  def error(self, msg: str):
    raise YAMLError(f"{msg} ({self.where}: {self.s!r})")

  def skip_spaces(self):
    while self.i < len(self.s) and self.s[self.i] in " \t":
      self.i += 1

  def at_end(self) -> bool:
    self.skip_spaces()
    return self.i >= len(self.s)

  def peek(self) -> str:
    return self.s[self.i] if self.i < len(self.s) else ""

  def quoted(self) -> str:
    q = self.s[self.i]
    self.i += 1
    out = []
    while True:
      if self.i >= len(self.s):
        self.error("unterminated quoted scalar")
      ch = self.s[self.i]
      if q == "'":
        if ch == "'":
          if self.s[self.i + 1:self.i + 2] == "'":
            out.append("'")
            self.i += 2
            continue
          self.i += 1
          return "".join(out)
        out.append(ch)
        self.i += 1
        continue
      if ch == '"':
        self.i += 1
        return "".join(out)
      if ch == "\\":
        esc = self.s[self.i + 1:self.i + 2]
        if esc in _ESCAPES:
          out.append(_ESCAPES[esc])
          self.i += 2
        elif esc in _HEX:
          n = _HEX[esc]
          code = self.s[self.i + 2:self.i + 2 + n]
          if len(code) != n or not re.fullmatch(r"[0-9A-Fa-f]+", code):
            self.error(f"bad escape \\{esc}{code}")
          out.append(chr(int(code, 16)))
          self.i += 2 + n
        else:
          self.error(f"unknown escape \\{esc}")
        continue
      out.append(ch)
      self.i += 1

  def plain(self, flow: bool) -> str:
    """A plain scalar up to ': ', ' #', the line's end, or in a flow
    collection ',', ']', '}'."""
    start = self.i
    while self.i < len(self.s):
      ch = self.s[self.i]
      nxt = self.s[self.i + 1:self.i + 2]
      if ch == ":" and (nxt in ("", " ", "\t")
                        or (flow and nxt in ",[]{}")):
        break
      if ch == "#" and self.i > start and self.s[self.i - 1] in " \t":
        break
      if flow and ch in ",[]{}":
        break
      self.i += 1
    return self.s[start:self.i].strip()

  def node(self, flow: bool) -> Any:
    """A scalar or a flow collection at the cursor."""
    self.skip_spaces()
    ch = self.peek()
    if ch == "[":
      return self.flow_sequence()
    if ch == "{":
      return self.flow_mapping()
    if ch in ("'", '"'):
      return self.quoted()
    if ch in ("&", "*", "!", "|", ">", "%", "@", "`"):
      self.error(f"unsupported YAML indicator {ch!r}")
    if ch == "-" and self.s[self.i + 1:self.i + 2] in ("", " "):
      self.error("a block sequence cannot start inside a line")
    return _resolve(self.plain(flow))

  def flow_sequence(self) -> list:
    self.i += 1
    out = []
    while True:
      self.skip_spaces()
      if self.peek() == "]":
        self.i += 1
        return out
      start = self.i
      item = self.node(flow=True)
      self.skip_spaces()
      if self.peek() == ":":  # a single-pair mapping inside a sequence
        self.i += 1
        item = {item: self.node(flow=True)}
        self.skip_spaces()
      if self.i == start:
        self.error("empty flow sequence entry")
      out.append(item)
      ch = self.peek()
      if ch == ",":
        self.i += 1
      elif ch != "]":
        self.error("expected ',' or ']'")

  def flow_mapping(self) -> dict:
    self.i += 1
    out = {}
    while True:
      self.skip_spaces()
      if self.peek() == "}":
        self.i += 1
        return out
      key = self.node(flow=True)
      self.skip_spaces()
      value = None
      if self.peek() == ":":
        self.i += 1
        self.skip_spaces()
        value = (None if self.peek() in (",", "}")
                 else self.node(flow=True))
        self.skip_spaces()
      out[_hashable(key, self)] = value
      ch = self.peek()
      if ch == ",":
        self.i += 1
      elif ch != "}":
        self.error("expected ',' or '}'")


def _hashable(key, scanner: _Scanner):
  if isinstance(key, (list, dict)):
    scanner.error("a collection cannot be a mapping key")
  return key


def _strip_comment(line: str) -> str:
  """The line without its comment: a '#' at the start or after a space,
  outside quotes."""
  quote: Optional[str] = None
  i = 0
  while i < len(line):
    ch = line[i]
    if quote == "'":
      if ch == "'":
        if line[i + 1:i + 2] == "'":
          i += 2
          continue
        quote = None
    elif quote == '"':
      if ch == "\\":
        i += 2
        continue
      if ch == '"':
        quote = None
    elif ch in ("'", '"') and (i == 0 or line[i - 1] in " \t[{,:-?"):
      quote = ch
    elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
      return line[:i].rstrip()
    i += 1
  return line.rstrip()


def _brackets_open(text: str) -> int:
  """Unclosed '[' and '{' of a line, outside quotes."""
  depth, quote = 0, None
  i = 0
  while i < len(text):
    ch = text[i]
    if quote == "'":
      if ch == "'":
        quote = None
    elif quote == '"':
      if ch == "\\":
        i += 1
      elif ch == '"':
        quote = None
    elif ch in ("'", '"') and (i == 0 or text[i - 1] in " \t[{,:-?"):
      quote = ch
    elif ch in "[{":
      depth += 1
    elif ch in "]}":
      depth -= 1
    i += 1
  return depth


# ---------------------------------------------------------------------------
# block structure
# ---------------------------------------------------------------------------
class _Line:
  __slots__ = ("indent", "text", "lineno")

  def __init__(self, indent: int, text: str, lineno: int):
    self.indent, self.text, self.lineno = indent, text, lineno


def _logical_lines(stream: str) -> List[_Line]:
  out: List[_Line] = []
  raw = stream.splitlines()
  i = 0
  while i < len(raw):
    line = raw[i]
    lineno = i + 1
    i += 1
    if "\t" in line[:len(line) - len(line.lstrip())]:
      raise YAMLError(f"a tab in the indentation (line {lineno})")
    text = _strip_comment(line)
    if not text.strip():
      continue
    stripped = text.strip()
    if stripped in ("---", "..."):
      if out and stripped == "---":
        raise YAMLError("more than one document")
      continue
    if stripped.startswith("%"):
      raise YAMLError(f"directives are not supported (line {lineno})")
    # a flow collection may span lines: join until its brackets close
    while _brackets_open(text) > 0 and i < len(raw):
      text = text + " " + _strip_comment(raw[i]).strip()
      i += 1
    out.append(_Line(len(text) - len(text.lstrip(" ")), text.strip(),
                     lineno))
  return out


def _is_seq_item(text: str) -> bool:
  return text == "-" or text.startswith("- ")


def _split_key(text: str, where: str) -> Optional[Tuple[Any, str]]:
  """(key, rest) when the line is a mapping entry 'key: rest', else
  None."""
  sc = _Scanner(text, where)
  ch = sc.peek()
  if ch in ("[", "{"):
    return None
  if ch in ("'", '"'):
    key = sc.quoted()
    sc.skip_spaces()
    if sc.peek() != ":":
      return None
  else:
    raw = sc.plain(flow=False)
    if sc.peek() != ":":
      return None
    key = _resolve(raw)
  sc.i += 1
  if sc.peek() not in ("", " ", "\t"):
    return None
  return _hashable(key, sc), text[sc.i:].strip()


class _Parser:

  def __init__(self, lines: List[_Line]):
    self.lines = lines
    self.pos = 0

  def where(self, line: _Line) -> str:
    return f"line {line.lineno}"

  def block(self, indent: int) -> Any:
    """The node whose lines start at ``self.pos``, at ``indent``."""
    line = self.lines[self.pos]
    if _is_seq_item(line.text):
      return self.sequence(line.indent)
    if _split_key(line.text, self.where(line)) is not None:
      return self.mapping(line.indent)
    self.pos += 1
    sc = _Scanner(line.text, self.where(line))
    value = sc.node(flow=False)
    if not sc.at_end():
      sc.error("unexpected text after a value")
    if self.pos < len(self.lines) and self.lines[self.pos].indent > indent:
      raise YAMLError(f"multi-line plain scalars are not supported "
                      f"({self.where(line)})")
    return value

  def inline(self, text: str, line: _Line, indent: int,
             parent_indent: int) -> Any:
    """The value after 'key:' or '- ' on ``line``; ``indent`` is the
    column a nested block under it would start past."""
    if not text:
      if self.pos < len(self.lines):
        nxt = self.lines[self.pos]
        if nxt.indent > parent_indent:
          return self.block(nxt.indent)
      return None
    if _is_seq_item(text):
      raise YAMLError(f"a sequence after a key on one line "
                      f"({self.where(line)})")
    sc = _Scanner(text, self.where(line))
    value = sc.node(flow=False)
    if not sc.at_end():
      sc.error("unexpected text after a value")
    if (self.pos < len(self.lines)
        and self.lines[self.pos].indent > parent_indent
        and not (isinstance(value, (list, dict)))):
      raise YAMLError(f"multi-line plain scalars are not supported "
                      f"({self.where(line)})")
    return value

  def mapping(self, indent: int) -> dict:
    out = {}
    while self.pos < len(self.lines):
      line = self.lines[self.pos]
      if line.indent < indent:
        break
      if line.indent > indent:
        raise YAMLError(f"bad indentation ({self.where(line)})")
      split = _split_key(line.text, self.where(line))
      if split is None:
        raise YAMLError(f"expected 'key: value' ({self.where(line)}: "
                        f"{line.text!r})")
      key, rest = split
      self.pos += 1
      if not rest and self.pos < len(self.lines):
        nxt = self.lines[self.pos]
        if nxt.indent == indent and _is_seq_item(nxt.text):
          out[key] = self.sequence(indent)  # a sequence at its key's indent
          continue
      out[key] = self.inline(rest, line, indent, indent)
    return out

  def sequence(self, indent: int) -> list:
    out = []
    while self.pos < len(self.lines):
      line = self.lines[self.pos]
      if line.indent != indent or not _is_seq_item(line.text):
        if line.indent > indent:
          raise YAMLError(f"bad indentation ({self.where(line)})")
        break
      rest = line.text[1:].lstrip(" ")
      if not rest:
        self.pos += 1
        out.append(self.inline("", line, indent, indent))
        continue
      # '- key: v' or '- - x': the entry is a block at the text's column
      column = indent + (len(line.text) - len(rest))
      if _is_seq_item(rest) or _split_key(rest, self.where(line)):
        self.lines[self.pos] = _Line(column, rest, line.lineno)
        out.append(self.block(column))
        continue
      self.pos += 1
      out.append(self.inline(rest, line, column, indent))
    return out


def safe_load(stream) -> Any:
  """Parse one YAML document (a string or a text file) to Python
  objects."""
  if hasattr(stream, "read"):
    stream = stream.read()
  lines = _logical_lines(str(stream))
  if not lines:
    return None
  parser = _Parser(lines)
  value = parser.block(lines[0].indent)
  if parser.pos != len(lines):
    line = lines[parser.pos]
    raise YAMLError(f"unexpected content ({parser.where(line)}: "
                    f"{line.text!r})")
  return value


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------
_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./()+$^=;<>~-][^\n]*$")


def _repr_float(v: float) -> str:
  """PyYAML's ``represent_float``."""
  if v != v:
    return ".nan"
  if v == math.inf:
    return ".inf"
  if v == -math.inf:
    return "-.inf"
  text = repr(v).lower()
  if "." not in text and "e" in text:
    text = text.replace("e", ".0e", 1)
  return text


def _plain_ok(s: str) -> bool:
  """Whether ``s`` written plain reads back as the same string."""
  if not s or s != s.strip() or not _PLAIN_SAFE.match(s):
    return False
  if s in ("<<", "="):  # PyYAML's merge and value tags
    return False
  if s.startswith(("- ", "? ")) or s == "-":
    return False
  if ": " in s or " #" in s or s.endswith(":") or "\t" in s:
    return False
  if any(c in s for c in ",[]{}&*!|>'\"%@`"):
    return False
  if not s.isprintable() or not s.isascii():
    return False
  if _REFUSED.match(s):
    return False
  return isinstance(_resolve(s), str)


def _scalar(v) -> str:
  if v is None:
    return "null"
  if v is True:
    return "true"
  if v is False:
    return "false"
  if isinstance(v, int):
    return str(v)
  if isinstance(v, float):
    return _repr_float(v)
  if isinstance(v, str):
    if _plain_ok(v):
      return v
    if v.isprintable() and "\n" not in v:
      return "'" + v.replace("'", "''") + "'"
    out = ['"']
    for ch in v:
      if ch == '"':
        out.append('\\"')
      elif ch == "\\":
        out.append("\\\\")
      elif ch == "\n":
        out.append("\\n")
      elif ch == "\t":
        out.append("\\t")
      elif not ch.isprintable():
        code = ord(ch)
        out.append(f"\\x{code:02X}" if code < 0x100 else
                   f"\\u{code:04X}" if code < 0x10000 else f"\\U{code:08X}")
      else:
        out.append(ch)
    out.append('"')
    return "".join(out)
  raise YAMLError(f"cannot represent {type(v).__name__}: {v!r}")


def _key(k) -> str:
  if isinstance(k, (list, dict, tuple)):
    raise YAMLError(f"cannot write a collection as a key: {k!r}")
  return _scalar(k)


def _emit(obj, indent: int, out: List[str]) -> None:
  """Block lines of a non-empty dict or list at ``indent``."""
  pad = " " * indent
  if isinstance(obj, dict):
    for k in sorted(obj, key=lambda x: (str(type(x)), x)):
      v = obj[k]
      if isinstance(v, dict) and v:
        out.append(f"{pad}{_key(k)}:")
        _emit(v, indent + 2, out)
      elif isinstance(v, (list, tuple)) and v:
        out.append(f"{pad}{_key(k)}:")
        _emit(list(v), indent, out)  # the sequence at its key's indent
      else:
        out.append(f"{pad}{_key(k)}: {_inline(v)}")
    return
  for v in obj:
    if isinstance(v, (dict, list, tuple)) and v:
      sub: List[str] = []
      _emit(list(v) if isinstance(v, tuple) else v, indent + 2, sub)
      first = sub[0][indent + 2:]
      out.append(f"{pad}- {first}")
      out.extend(sub[1:])
    else:
      out.append(f"{pad}- {_inline(v)}")


def _inline(v) -> str:
  if isinstance(v, dict):
    return "{}"
  if isinstance(v, (list, tuple)):
    return "[]"
  return _scalar(v)


def safe_dump(obj, stream=None) -> Optional[str]:
  """Write ``obj`` as block YAML; to ``stream`` when given, else return
  the text."""
  if isinstance(obj, (dict, list, tuple)) and obj:
    lines: List[str] = []
    _emit(list(obj) if isinstance(obj, tuple) else obj, 0, lines)
    text = "\n".join(lines) + "\n"
  else:
    text = _inline(obj) + "\n...\n"
  if stream is None:
    return text
  stream.write(text)
  return None
