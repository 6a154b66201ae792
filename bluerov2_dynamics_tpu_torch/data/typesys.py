"""Schema-driven message type system: ``.msg`` / ``.idl`` -> CDR decoder.

The reference registers custom bag message types from ``.msg`` OR ``.idl``
definition files found on disk (``rosbags/bag2csv.py:74-97``) through the
``rosbags`` typestore.  This module is the dependency-free equivalent for
our sqlite3+CDR ingestion path (:mod:`bag_sqlite` / :mod:`cdr`): it parses
both definition formats into a field schema and decodes CDR payloads
generically from that schema — so bags containing types without a
hand-written decoder (``cdr.DECODERS``) can still be read.

Supported subset (covers ROS 2 / PX4 uORB interface definitions):

* primitive scalars, fixed-size arrays ``T[N]``, unbounded/bounded
  sequences ``T[]`` / ``T[<=N]``, strings, and nested registered types;
* ``.msg``: constants (``T NAME=value``) skipped, defaults tolerated;
* ``.idl``: the ``rosidl_adapter`` output shape — nested ``module`` blocks,
  ``typedef`` array aliases, ``@annotations``, constant modules, comments,
  ``sequence<T>`` / ``sequence<T, N>``, ``string``/``wstring``.

Counterpart of ``bluerov2_dynamics_tpu/data/typesys.py``.
"""

from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional

from bluerov2_dynamics_tpu_torch.data.cdr import _FMT, CdrReader

# IDL primitive name -> ROS primitive name
_IDL_PRIMS = {
    "boolean": "bool",
    "octet": "uint8",
    "char": "uint8",
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "uint16": "uint16",
    "int32": "int32", "uint32": "uint32",
    "int64": "int64", "uint64": "uint64",
    "short": "int16", "unsigned short": "uint16",
    "long": "int32", "unsigned long": "uint32",
    "long long": "int64", "unsigned long long": "uint64",
    "float": "float32", "double": "float64",
    "string": "string", "wstring": "wstring",
}

# ROS .msg aliases
_MSG_PRIMS = {k: k for k in _FMT}
_MSG_PRIMS.update({
    "bool": "bool", "byte": "uint8", "char": "uint8",
    "string": "string", "wstring": "wstring",
})


class Field(NamedTuple):
    """One message field.

    ``kind``: a primitive name from :data:`cdr._FMT`, ``'string'``, or a
    full nested type name (``'pkg/msg/Type'``).  ``count``: ``None`` for a
    scalar, ``n >= 0`` for a fixed array, ``-1`` for a length-prefixed
    sequence (bounded sequences decode identically).
    """

    name: str
    kind: str
    count: Optional[int] = None


# ---------------------------------------------------------------------------
# .msg parsing
# ---------------------------------------------------------------------------

_MSG_FIELD = re.compile(
    r"^\s*([\w/]+(?:<=\s*\d+)?)\s*(\[(<=?\s*)?(\d*)\])?\s+(\w+)\s*(=.*|\s.*)?$"
)


def parse_msg(text: str, typename: str = "") -> List[Field]:
    """Parse a ROS 2 ``.msg`` definition body into a field schema.

    Constants (``TYPE NAME=value``) define no wire data and are skipped;
    default values after the field name are tolerated; bounded strings
    (``string<=N``) decode like unbounded ones (same wire format).  A bare
    nested type (``Header header``) is namespaced against ``typename``'s
    package when it carries no ``/``.  A non-empty line that parses as
    neither a field nor a constant raises — silently skipping one would
    shift the CDR offsets of every subsequent field (wrong values, no
    error).
    """
    fields: List[Field] = []
    pkg = typename.split("/")[0] if "/" in typename else ""
    for line in text.splitlines():
        line = line.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        m = _MSG_FIELD.match(line)
        if not m:
            raise ValueError(
                f"unparseable .msg field line {line!r} in {typename or '<msg>'}"
                " — a skipped field would silently misalign the CDR decode"
            )
        kind, arr, bounded, n, name, trailer = m.groups()
        kind = re.sub(r"<=\s*\d+$", "", kind)  # bounded string: same wire fmt
        if trailer and trailer.strip().startswith("="):
            continue  # constant
        if kind in _MSG_PRIMS:
            kind = _MSG_PRIMS[kind]
        elif "/" not in kind:
            if kind == "Header":
                kind = "std_msgs/msg/Header"
            elif pkg:
                kind = f"{pkg}/msg/{kind}"
        elif kind.count("/") == 1:  # two-part ROS name pkg/Type
            a, b = kind.split("/")
            kind = f"{a}/msg/{b}"
        if arr is None:
            count: Optional[int] = None
        elif n == "" or bounded:  # unbounded or bounded sequence
            count = -1
        else:
            count = int(n)
        fields.append(Field(name, kind, count))
    return fields


# ---------------------------------------------------------------------------
# .idl parsing
# ---------------------------------------------------------------------------

def _strip_idl(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)     # block comments
    text = re.sub(r"//[^\n]*", " ", text)                  # line comments
    # annotations: @name or @name (...) possibly spanning lines.  The
    # parenthesised payload may contain ')' INSIDE quoted strings — e.g.
    # rosidl's @verbatim (language="comment", text="Heading (rad)") — so
    # the content pattern consumes quoted strings atomically.
    text = re.sub(
        r"@\w+\s*(\((?:[^()\"']|\"[^\"]*\"|'[^']*')*\))?", " ", text,
        flags=re.S,
    )
    # blank remaining string literals (const string values): a '{' inside
    # one would otherwise corrupt the module-brace scanner's stack and
    # register every later struct under the wrong module path
    text = re.sub(r'"(?:[^"\\]|\\.)*"', '""', text)
    text = re.sub(r"'(?:[^'\\]|\\.)*'", "''", text)
    return text


def parse_idl(text: str) -> Dict[str, List[Field]]:
    """Parse a ``rosidl``-style ``.idl`` file; returns
    ``{'pkg/msg/Type': [Field, ...], ...}`` for every struct found.

    Handles the module nesting ``module pkg { module msg { struct T {...};
    }; };``, array ``typedef``s, ``sequence<T[, N]>``, and constant
    modules (skipped — they define no wire data).
    """
    text = _strip_idl(text)
    # module path tracking via a simple scanner
    typedefs: Dict[str, tuple] = {}  # alias -> (kind, count)
    out: Dict[str, List[Field]] = {}

    for td in re.finditer(
        r"typedef\s+([\w :<>,]+?)\s+(\w+)\s*(\[\s*(\d+)\s*\])?\s*;", text
    ):
        base, alias, arr, n = td.groups()
        kind, count = _idl_type(base.strip(), typedefs)
        if arr:
            count = int(n)
        typedefs[alias] = (kind, count)

    # find structs with their module path
    pos = 0
    stack: List[str] = []
    token = re.compile(r"module\s+(\w+)\s*\{|struct\s+(\w+)\s*\{|\{|\}")
    while True:
        m = token.search(text, pos)
        if not m:
            break
        mod, struct = m.group(1), m.group(2)
        if mod is not None:
            stack.append(mod)
            pos = m.end()
        elif struct is not None:
            depth = 1
            i = m.end()
            while depth and i < len(text):
                if text[i] == "{":
                    depth += 1
                elif text[i] == "}":
                    depth -= 1
                i += 1
            body = text[m.end(): i - 1]
            # constant modules end in _Constants and contain only consts
            path = [p for p in stack
                    if p != "\0" and not p.endswith("_Constants")]
            typename = "/".join(path + [struct])
            out[typename] = _parse_idl_struct(body, typedefs)
            pos = i
        elif m.group(0) == "{":  # non-module brace: push a sentinel so the
            stack.append("\0")   # matching } does not pop a real module
            pos = m.end()
        else:  # }
            if stack:
                stack.pop()
            pos = m.end()
    return out


def _idl_type(spec: str, typedefs: Dict[str, tuple]) -> tuple:
    """IDL type spec -> (kind, count) with count None/-1/n."""
    spec = spec.strip()
    seq = re.match(r"sequence\s*<\s*([\w :]+?)\s*(,\s*\d+\s*)?>", spec)
    if seq:
        kind, _ = _idl_type(seq.group(1), typedefs)
        return kind, -1
    spec = re.sub(r"\s+", " ", spec)
    strm = re.match(r"(w?)string\s*(<\s*\d+\s*>)?$", spec)
    if strm:
        return ("wstring" if strm.group(1) else "string"), None
    if spec in _IDL_PRIMS:
        return _IDL_PRIMS[spec], None
    if spec in typedefs:
        return typedefs[spec]
    # nested type reference pkg::msg::Type
    return spec.replace("::", "/"), None


def _parse_idl_struct(body: str, typedefs: Dict[str, tuple]) -> List[Field]:
    fields: List[Field] = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl or decl.startswith("const "):
            continue
        m = re.match(r"(.+?)\s+(\w+)\s*(\[\s*(\d+)\s*\])?$", decl, flags=re.S)
        if not m:
            continue
        spec, name, arr, n = m.groups()
        kind, count = _idl_type(spec, typedefs)
        if arr:
            count = int(n)
        fields.append(Field(name, kind, count))
    return fields


# ---------------------------------------------------------------------------
# Generic decode + registry
# ---------------------------------------------------------------------------

class TypeStore:
    """Registry of field schemas with a generic CDR decoder.

    Mirrors the role of the reference's rosbags typestore registration
    (``rosbags/bag2csv.py:74-97``) for the dependency-free reader: types
    registered from ``.msg``/``.idl`` text or files decode via
    :meth:`decode` into attribute namespaces.
    """

    def __init__(self):
        self.types: Dict[str, List[Field]] = {}

    def register(self, typename: str, fields: List[Field]) -> None:
        self.types[typename] = list(fields)

    def register_msg(self, typename: str, text: str) -> None:
        self.register(typename, parse_msg(text, typename))

    def register_idl(self, text: str) -> List[str]:
        found = []
        for typename, fields in parse_idl(text).items():
            self.register(typename, fields)
            found.append(typename)
        return found

    def load_directory(self, base) -> List[str]:
        """Register every ``pkg/msg/*.msg`` / ``*.idl`` under ``base``
        (the reference's directory-scan contract,
        ``rosbags/bag2csv.py:74-97``).  Returns registered type names."""
        base = Path(base)
        found: List[str] = []
        if not base.exists():
            return found
        for ext in (".msg", ".idl"):
            for path in sorted(base.rglob(f"*{ext}")):
                if path.parent.name.lower() != "msg" or not path.is_file():
                    continue
                pkg = path.parent.parent.name
                typename = f"{pkg}/msg/{path.stem}"
                try:
                    text = path.read_text(encoding="utf-8")
                    if ext == ".msg":
                        self.register_msg(typename, text)
                        found.append(typename)
                    else:
                        found.extend(self.register_idl(text))
                except Exception as e:  # pragma: no cover - diagnostics
                    from bluerov2_dynamics_tpu_torch.utils.log import warn

                    warn(f"Could not register {typename} from {path}: {e}")
        return found

    def decode(self, typename: str, data: bytes) -> SimpleNamespace:
        """Decode one CDR payload of a registered type."""
        r = CdrReader(data)
        return self._decode_fields(self.types[typename], r)

    def _decode_fields(self, fields: List[Field], r: CdrReader) -> SimpleNamespace:
        out = SimpleNamespace()
        for f in fields:
            setattr(out, f.name, self._decode_field(f, r))
        return out

    def _decode_field(self, f: Field, r: CdrReader):
        if f.kind in ("string", "wstring"):
            read = r.string if f.kind == "string" else r.wstring
            if f.count is None:
                return read()
            n = f.count if f.count >= 0 else r.prim("uint32")
            return [read() for _ in range(n)]
        if f.kind in _FMT:
            if f.count is None:
                return r.prim(f.kind)
            n = f.count if f.count >= 0 else r.prim("uint32")
            return r.array(f.kind, n)
        # nested registered type
        sub = self.types.get(f.kind)
        if sub is None:
            raise KeyError(f"nested type {f.kind!r} is not registered")
        if f.count is None:
            return self._decode_fields(sub, r)
        n = f.count if f.count >= 0 else r.prim("uint32")
        return [self._decode_fields(sub, r) for _ in range(n)]


_STD_HEADER = """\
builtin_interfaces/Time stamp
string frame_id
"""

_BUILTIN_TIME = """\
int32 sec
uint32 nanosec
"""


def default_typestore(extra_dirs=()) -> TypeStore:
    """TypeStore preloaded with the PX4 definitions
    (:mod:`.px4_msgs`) and common builtins, plus any ``.msg``/``.idl``
    trees in ``extra_dirs``."""
    from bluerov2_dynamics_tpu_torch.data.px4_msgs import DEFINITIONS

    ts = TypeStore()
    ts.register_msg("builtin_interfaces/msg/Time", _BUILTIN_TIME)
    ts.register_msg("std_msgs/msg/Header", _STD_HEADER)
    for typename, text in DEFINITIONS.items():
        ts.register_msg(typename, text)
    for d in extra_dirs:
        ts.load_directory(d)
    return ts
