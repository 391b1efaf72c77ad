"""A reader and writer for the YAML the configs use, without PyYAML.

The subset: block mappings and sequences (a sequence may sit at its key's
indentation, as PyYAML writes it, and an item may open a mapping, ``- lr:
0.001``), flow sequences and mappings (``[Adam, {lr: 0.001}]``), comments,
single- and double-quoted and plain scalars. Plain scalars resolve as
PyYAML's safe loader resolves them (YAML 1.1): ``null``/``~``/empty,
``true``/``yes``/``on`` and their opposites, ints (decimal, ``0x``, ``0b``,
octal ``0...``, ``_`` separators), and floats only with a dot, an exponent
sign and ``.inf``/``.nan`` (so ``1e-3`` stays the string '1e-3', as there).
Anchors, tags, block scalars and multiple documents are not part of it and
raise. ``dumps`` writes block style in insertion order, as
``yaml.safe_dump(..., sort_keys=False)`` does, quoting a string wherever its
plain form would read back as something else.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)


class YAMLError(ValueError):
    pass


def _sexagesimal(text: str, cast):
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _to_int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    body = t.lstrip("+-")
    if ":" in body:
        return _sexagesimal(t, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _to_float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return -math.inf if t.startswith("-") else math.inf
    if t == ".nan":
        return math.nan
    if ":" in t:
        return float(_sexagesimal(t, float))
    return float(t)


def resolve_plain(text: str) -> Any:
    """A plain scalar as PyYAML's safe loader types it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    return text


# ----------------------------------------------------------------- reading
def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (a # that starts the line or
    follows a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                continue
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive-descent parser of one flow node or scalar."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def parse(self) -> Any:
        self._ws()
        value = self._node(top=True)
        self._ws()
        if self.i != len(self.s):
            raise YAMLError(f"unexpected text after a value: {self.s[self.i:]!r}")
        return value

    def _node(self, top=False) -> Any:
        self._ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            return self._quoted()
        if ch in "&*!|>%@`":
            raise YAMLError(f"unsupported YAML syntax: {self.s[self.i:]!r}")
        return self._plain(top)

    def _quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise YAMLError("unterminated quoted scalar")
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                simple = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0",
                          "r": "\r", " ": " "}
                if esc in simple:
                    out.append(simple[esc])
                    self.i += 2
                    continue
                if esc in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[esc]
                    out.append(chr(int(self.s[self.i + 2:self.i + 2 + n], 16)))
                    self.i += 2 + n
                    continue
                raise YAMLError(f"unsupported escape \\{esc}")
            out.append(ch)
            self.i += 1

    def _plain(self, top: bool) -> Any:
        start = self.i
        stops = "" if top else ",]}"
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops:
                break
            if ch == ":" and not top and (self.i + 1 == len(self.s)
                                          or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        return resolve_plain(self.s[start:self.i].strip())

    def _seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.i >= len(self.s):
                raise YAMLError("unterminated flow sequence")
            if self.s[self.i] == "]":
                self.i += 1
                return out
            item = self._node()
            self._ws()
            if self.s[self.i:self.i + 1] == ":":  # a single-pair mapping inside [...]
                self.i += 1
                item = {item: self._node()}
                self._ws()
            out.append(item)
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "]":
                raise YAMLError(f"expected , or ] in a flow sequence: {self.s!r}")

    def _map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self._ws()
            if self.i >= len(self.s):
                raise YAMLError("unterminated flow mapping")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key = self._node()
            self._ws()
            value = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                value = self._node()
                self._ws()
            out[key] = value
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "}":
                raise YAMLError(f"expected , or }} in a flow mapping: {self.s!r}")


def _flow_depth(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of every line that holds a node, comments removed and
    a flow collection spread over several lines joined into one."""
    out: List[Tuple[int, str]] = []
    pending = None
    for raw in text.splitlines():
        if raw.strip() in ("---", "...") and pending is None:
            if out:
                raise YAMLError("multiple documents are not supported")
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLError("tabs in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
        else:
            pending = (len(line) - len(line.lstrip(" ")), line.strip())
        if _flow_depth(pending[1]) <= 0:
            out.append(pending)
            pending = None
    if pending is not None:
        raise YAMLError("unterminated flow collection")
    return out


def _split_key(content: str):
    """'key: value' -> (key, value text); None when the line is no mapping entry."""
    if content[0] in "'\"":
        p = _Flow(content)
        p._quoted()
        rest = content[p.i:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return _Flow(content[:p.i]).parse(), rest[1:].strip()
        return None
    if content[0] in "[{":
        return None
    m = re.match(r"^([^#]*?):(?:\s+(.*))?$", content)
    if m is None or "'" in m.group(1) or '"' in m.group(1):
        return None
    return resolve_plain(m.group(1).strip()), (m.group(2) or "").strip()


class _Block:
    def __init__(self, lines):
        self.lines, self.i = lines, 0

    def node(self, indent: int) -> Any:
        """The node whose lines start at the current line, at ``indent``."""
        ind, content = self.lines[self.i]
        if content.startswith("- ") or content == "-":
            return self.seq(ind)
        if _split_key(content) is not None:
            return self.map(ind)
        self.i += 1
        return _Flow(content).parse()

    def value(self, text: str, parent_indent: int, seq_ok: bool) -> Any:
        """The value after 'key:' or '- ': inline text, or the block below."""
        if text:
            return _Flow(text).parse()
        if self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind > parent_indent or (seq_ok and ind == parent_indent
                                       and (content.startswith("- ") or content == "-")):
                return self.node(ind)
        return None

    def map(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"bad indentation at {content!r}")
            kv = _split_key(content)
            if kv is None:
                break
            self.i += 1
            key, text = kv
            out[key] = self.value(text, indent, seq_ok=True)
        return out

    def seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind != indent or not (content.startswith("- ") or content == "-"):
                if ind > indent:
                    raise YAMLError(f"bad indentation at {content!r}")
                break
            rest = content[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.value("", indent, seq_ok=False))
                continue
            # the item's content is a node of its own, indented past the dash
            self.lines[self.i] = (indent + len(content) - len(rest), rest)
            out.append(self.node(self.lines[self.i][0]))
        return out


def loads(text: str) -> Any:
    """A YAML document of the subset -> Python objects, as ``yaml.safe_load``."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise YAMLError(f"unexpected line: {lines[block.i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# ----------------------------------------------------------------- writing
_SPECIAL = set("#:[]{},&*!|>'\"%@`")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:  # YAML 1.1 floats need a dot and a signed exponent
            mant, exp = r.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            r = f"{mant}e{exp}"
        elif "." not in r:
            r += ".0"
        return r
    s = str(v)
    plain_ok = (s and s == s.strip() and not (_SPECIAL & set(s)) and "\n" not in s
                and not s.startswith(("- ", "?")) and s != "-"
                and resolve_plain(s) == s and isinstance(resolve_plain(s), str))
    return s if plain_ok else "'" + s.replace("'", "''") + "'"


def _dump(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, item in v.items():
            key = _scalar(k)
            if isinstance(item, dict) and item:
                out.append(f"{pad}{key}:")
                _dump(item, indent + 2, out)
            elif isinstance(item, (list, tuple)) and item:
                out.append(f"{pad}{key}:")
                _dump(item, indent, out)  # sequences sit at their key's indentation
            else:
                out.append(f"{pad}{key}: {_inline(item)}")
    elif isinstance(v, (list, tuple)):
        for item in v:
            if isinstance(item, (dict, list, tuple)) and item:
                sub: List[str] = []
                _dump(item, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(item)}")
    else:
        out.append(pad + _scalar(v))


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dumps(obj: Any) -> str:
    """Block-style YAML of dicts, lists, tuples and scalars."""
    out: List[str] = []
    _dump(obj, 0, out)
    return "\n".join(out) + "\n"
