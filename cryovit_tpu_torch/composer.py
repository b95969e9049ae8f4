"""Minimal YAML config composition engine (port of ``cryovit_tpu/composer.py``).

The JAX package composes its experiments from the YAML tree under its
``configs/`` with a hydra-compatible subset; the port keeps its own copy of
that tree (``cryovit_tpu_torch/configs``, each ``_target_`` naming the port's
class) and the same engine:

- ``compose(name, overrides)``     — build a config from the YAML tree
- ``instantiate(node)``            — construct objects from ``_target_``
- ``expand_sweep(cfg)``            — expand ``sweep.params`` grids
- ``DotDict``                      — attribute-access nested dict

The port runs where pyyaml may not be installed, so the YAML is read by a
reader of this module's own (:func:`_yaml_load`) for the subset the config
tree uses: block mappings and sequences, flow sequences and mappings on one line,
single- and double-quoted and plain scalars, comments (``# @package
_global_`` is one). Plain scalars resolve as the JAX package's loader
resolves them: pyyaml's ``SafeLoader`` (YAML 1.1 booleans, nulls, ints
with ``0b``/``0x``/octal/sexagesimal forms) plus its YAML 1.2 float rule,
so ``lr: 1e-4`` is a float. Anything else (anchors, aliases, tags, ``|``
and ``>`` block scalars, multi-line scalars, timestamps, document
markers) raises :class:`ConfigError` naming the file and line; it is never
parsed silently.

Supported defaults-list entry forms::

    - _self_                  # position of the file's own body
    - some_schema             # registered structured-config schema
    - sibling_file            # another option in the same group dir
    - optional sibling        # ignored if absent
    - group: option           # compose configs/<group>/<option>.yaml
    - group: [opt1, opt2]     # merge several options of a group
    - override /group: option # (experiments) replace a root group choice

Interpolations: ``${a.b.c}`` (root-relative), ``${choices.<group>}`` (the
selected option of a group — hydra's ``${hydra:runtime.choices.*}``), and
``${env:VAR,default}``. ``???`` marks required values (checked by
validators).
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import itertools
import math
import os
import re
from functools import partial
from pathlib import Path
from typing import Any

__all__ = [
    "MISSING",
    "ConfigError",
    "DotDict",
    "compose",
    "instantiate",
    "expand_sweep",
    "expand_sweep_file",
    "register_schema",
    "missing_keys",
    "to_plain",
]

MISSING = "???"

_DEFAULT_CONFIG_DIR = Path(__file__).parent / "configs"

# Registered structured-config schemas: name -> plain dict of defaults.
_SCHEMA_REGISTRY: dict[str, dict] = {}


class ConfigError(Exception):
    """Raised on malformed configs, bad overrides, or missing files."""


class DotDict(dict):
    """A dict with attribute access, returning nested DotDicts."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return DotDict({k: DotDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [DotDict.wrap(v) for v in obj]
        return obj


def to_plain(obj: Any) -> Any:
    """Recursively convert DotDicts back to plain dicts."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_plain(v) for v in obj]
    return obj


def register_schema(name: str, schema: Any) -> None:
    """Register a structured-config schema (dataclass instance or dict)."""
    if dataclasses.is_dataclass(schema) and not isinstance(schema, type):
        schema = dataclasses.asdict(schema)
    elif dataclasses.is_dataclass(schema):
        schema = dataclasses.asdict(schema())
    _SCHEMA_REGISTRY[name] = _normalize(schema)


def _normalize(obj: Any) -> Any:
    """Make schema values YAML-plain (Paths → str, Enums → value)."""
    if isinstance(obj, dict):
        return {k: _normalize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_normalize(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    if hasattr(obj, "value") and obj.__class__.__module__ != "builtins":
        return obj.value
    return obj


def _deep_merge(base: dict, new: dict) -> dict:
    """Merge ``new`` into ``base`` (new wins; dicts merge, lists replace).

    OmegaConf parity: a ``???`` (MISSING) value never overwrites an existing
    value — schemas appearing late in a defaults list only fill gaps.
    """
    for key, val in new.items():
        if key in base and isinstance(base[key], dict) and isinstance(val, dict):
            _deep_merge(base[key], val)
        elif val == MISSING and key in base:
            continue
        else:
            base[key] = copy.deepcopy(val)
    return base


def _set_path(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = DotDict()
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def _get_path(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            raise KeyError(dotted)
        node = node[p]
    return node


# ---- the YAML subset reader -------------------------------------------------

# pyyaml SafeLoader's implicit resolvers (YAML 1.1), by the scalar's first
# character, in pyyaml's order, with the JAX loader's YAML 1.2 float last
_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_BOOL_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"~", "null", "Null", "NULL", ""}
_FLOAT_11 = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_FLOAT_12 = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_RESOLVERS: dict[str, list[str]] = {}
for _tag, _first in (
    ("bool", "yYnNtTfFoO"), ("float", "-+0123456789."), ("int", "-+0123456789"),
    ("merge", "<"), ("null", "~nN"), ("timestamp", "0123456789"), ("value", "="),
    ("float12", "-+0123456789."),
):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append(_tag)


def _sexagesimal(text: str, cast) -> Any:
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _construct_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Reader:
    """Reads one YAML document of the subset (module docstring) into plain
    dicts, lists and scalars, as ``yaml.load`` with the JAX package's loader
    reads it. ``source`` names the text in errors."""

    def __init__(self, text: str, source: str) -> None:
        self.source = source
        self.lines: list[list] = []  # [line number, indent, content]
        for number, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            indent = len(raw) - len(body)
            if body.startswith("\t"):
                self.fail(number, "a tab in the indentation")
            if not body.strip() or body.startswith("#"):
                continue
            if body.startswith(("---", "...")) and body[3:4] in ("", " "):
                self.fail(number, "document markers (--- / ...)")
            if body.startswith("%"):
                self.fail(number, "directives (%)")
            self.lines.append([number, indent, body.rstrip()])

    def fail(self, number: int, what: str) -> None:
        raise ConfigError(f"{self.source}:{number}: {what} is outside the YAML subset the "
                          "composer reads")

    # ---- scalars and flow collections --------------------------------------

    def resolve(self, number: int, text: str) -> Any:
        """A plain scalar's value (pyyaml's implicit resolvers)."""
        for tag in _RESOLVERS.get(text[:1], []) if text else ["null"]:
            if tag == "bool" and (text in _BOOL_TRUE or text in _BOOL_FALSE):
                return text in _BOOL_TRUE
            if tag == "float" and _FLOAT_11.match(text):
                return _construct_float(text)
            if tag == "int" and _INT.match(text):
                try:
                    return _construct_int(text)
                except ValueError:
                    self.fail(number, f"the integer {text!r}")
            if tag == "merge" and text == "<<":
                self.fail(number, "merge keys (<<)")
            if tag == "null" and text in _NULL:
                return None
            if tag == "timestamp" and _TIMESTAMP.match(text):
                self.fail(number, f"a timestamp ({text!r})")
            if tag == "value" and text == "=":
                self.fail(number, "the value key (=)")
            if tag == "float12" and _FLOAT_12.match(text):
                return _construct_float(text)
        return text

    def quoted(self, number: int, s: str, i: int) -> tuple[str, int]:
        quote, out, i = s[i], [], i + 1
        while i < len(s):
            ch = s[i]
            if quote == "'" and ch == "'":
                if s[i + 1 : i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if quote == '"' and ch == '"':
                return "".join(out), i + 1
            if quote == '"' and ch == "\\":
                esc = s[i + 1 : i + 2]
                simple = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
                          "0": "\0", " ": " "}
                if esc in simple:
                    out.append(simple[esc])
                    i += 2
                    continue
                width = {"x": 2, "u": 4, "U": 8}.get(esc)
                code = s[i + 2 : i + 2 + width] if width else ""
                if not width or len(code) != width or not all(
                        c in "0123456789abcdefABCDEF" for c in code):
                    self.fail(number, f"the escape \\{esc}")
                out.append(chr(int(code, 16)))
                i += 2 + width
                continue
            out.append(ch)
            i += 1
        self.fail(number, "a quoted scalar that does not close on its line")

    def scalar(self, number: int, s: str, i: int, flow: bool) -> tuple[Any, int]:
        """The node starting at ``s[i]`` (a quoted or plain scalar, or a flow
        collection) and the index after it."""
        while i < len(s) and s[i] == " ":
            i += 1
        if i >= len(s) or s[i] == "#":
            return None, i
        ch, nxt = s[i], s[i + 1 : i + 2]
        if ch in "'\"":
            return self.quoted(number, s, i)
        if ch in "[{":
            return self.flow(number, s, i)
        if ch in "&*!|>%@`":
            what = {"&": "anchors (&)", "*": "aliases (*)", "!": "tags (!)",
                    "|": "block scalars (|)", ">": "block scalars (>)"}.get(ch, f"'{ch}'")
            self.fail(number, what)
        if ch in "]},":
            self.fail(number, f"a stray '{ch}'")
        if ch in "-?:" and nxt in ("", " ") + ((",", "[", "]", "{", "}") if flow else ()):
            self.fail(number, f"the indicator '{ch}' here")
        j = i
        while j < len(s):
            c = s[j]
            if c == "#" and s[j - 1] == " ":
                break
            if c == ":" and (s[j + 1 : j + 2] in ("", " ")
                             or (flow and s[j + 1 : j + 2] in ",[]{}")):
                break
            if flow and c in ",[]{}":
                break
            j += 1
        return self.resolve(number, s[i:j].rstrip(" ")), j

    def flow(self, number: int, s: str, i: int) -> tuple[Any, int]:
        close = "]" if s[i] == "[" else "}"
        out: Any = [] if close == "]" else {}
        i += 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i >= len(s) or s[i] == "#":
                self.fail(number, "a flow collection that does not close on its line")
            if s[i] == close:
                return out, i + 1
            if s[i] == ",":
                self.fail(number, "an empty entry in a flow collection")
            item, i = self.scalar(number, s, i, flow=True)
            while i < len(s) and s[i] == " ":
                i += 1
            if close == "}":
                if s[i : i + 1] != ":":
                    self.fail(number, "a flow mapping entry without a value")
                value, i = self.scalar(number, s, i + 1, flow=True)
                if isinstance(item, (dict, list)):
                    self.fail(number, "a collection as a mapping key")
                out[item] = value
            elif s[i : i + 1] == ":":
                self.fail(number, "a mapping inside a flow sequence")
            else:
                out.append(item)
            while i < len(s) and s[i] == " ":
                i += 1
            if s[i : i + 1] == ",":
                i += 1
            elif s[i : i + 1] != close:
                self.fail(number, "a flow collection that does not close on its line")

    def inline(self, number: int, s: str, i: int) -> Any:
        """A node that must end its line (after an optional comment)."""
        value, j = self.scalar(number, s, i, flow=False)
        while j < len(s) and s[j] == " ":
            j += 1
        if j < len(s) and s[j] != "#":
            self.fail(number, f"text after a value ({s[j:]!r})")
        return value

    # ---- block structure ------------------------------------------------------

    @staticmethod
    def is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def entry(self, number: int, text: str) -> tuple[Any, int] | None:
        """``(key, index after its ':')`` when the line is a mapping entry."""
        if text[:1] in "[{" or text.startswith("? ") or text == "?":
            return None
        key, j = self.scalar(number, text, 0, flow=False)
        while j < len(text) and text[j] == " ":
            j += 1
        if text[j : j + 1] == ":" and text[j + 1 : j + 2] in ("", " "):
            if isinstance(key, (dict, list)):
                self.fail(number, "a collection as a mapping key")
            return key, j + 1
        return None

    def block(self, pos: int, parent: int) -> tuple[Any, int]:
        """The block node starting at line ``pos`` (deeper than ``parent``)."""
        number, indent, text = self.lines[pos]
        if self.is_item(text):
            return self.sequence(pos, indent)
        if self.entry(number, text) is not None:
            return self.mapping(pos, indent)
        value = self.inline(number, text, 0)
        if pos + 1 < len(self.lines) and self.lines[pos + 1][1] > parent:
            self.fail(self.lines[pos + 1][0], "a multi-line scalar or a stray indentation")
        return value, pos + 1

    def mapping(self, pos: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while pos < len(self.lines):
            number, ind, text = self.lines[pos]
            if ind < indent:
                break
            if ind > indent:
                self.fail(number, "an unexpected indentation")
            found = self.entry(number, text)
            if found is None:
                self.fail(number, "a line that is not a mapping entry among mapping entries")
            key, j = found
            rest = text[j:].strip()
            pos += 1
            if rest and not rest.startswith("#"):
                out[key] = self.inline(number, text, j)
                if pos < len(self.lines) and self.lines[pos][1] > indent:
                    self.fail(self.lines[pos][0], "a multi-line scalar or a stray indentation")
            elif pos < len(self.lines) and self.lines[pos][1] > indent:
                out[key], pos = self.block(pos, indent)
            elif pos < len(self.lines) and self.lines[pos][1] == indent and \
                    self.is_item(self.lines[pos][2]):
                out[key], pos = self.sequence(pos, indent)
            else:
                out[key] = None
        return out, pos

    def sequence(self, pos: int, indent: int) -> tuple[list, int]:
        out: list = []
        while pos < len(self.lines):
            number, ind, text = self.lines[pos]
            if ind < indent or (ind == indent and not self.is_item(text)):
                break
            if ind > indent:
                self.fail(number, "an unexpected indentation")
            rest = text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                pos += 1
                if pos < len(self.lines) and self.lines[pos][1] > indent:
                    item, pos = self.block(pos, indent)
                else:
                    item = None
            else:
                # the item's own node starts where its text does
                self.lines[pos] = [number, ind + len(text) - len(rest), rest]
                item, pos = self.block(pos, indent)
            out.append(item)
        return out, pos

    def document(self) -> Any:
        if not self.lines:
            return None
        value, pos = self.block(0, -1)
        if pos != len(self.lines):
            self.fail(self.lines[pos][0], "a line outside the document's top node")
        return value


def _yaml_load(text: str, source: str = "<string>") -> Any:
    """One YAML document of the subset the config tree uses (module
    docstring), as the JAX package's pyyaml loader reads it."""
    return _Reader(text, source).document()


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML scalar rules."""
    if text.startswith("[") or text.startswith("{"):
        return _yaml_load(text, f"override value {text!r}")
    if "," in text:
        return [_yaml_load(v.strip(), f"override value {text!r}") for v in text.split(",")]
    return _yaml_load(text, f"override value {text!r}")


def _is_global_package(path: Path) -> bool:
    """True if the file opens with a ``# @package _global_`` directive."""
    with open(path) as f:
        for line in f:
            stripped = line.strip()
            if not stripped:
                continue
            return stripped.startswith("#") and "@package _global_" in stripped
    return False


def _load_yaml(path: Path) -> dict:
    if not path.exists():
        raise ConfigError(f"config file not found: {path}")
    with open(path) as f:
        data = _yaml_load(f.read(), str(path))
    return data or {}


@dataclasses.dataclass
class _Composer:
    config_dir: Path
    choices: dict[str, str] = dataclasses.field(default_factory=dict)

    # ---- defaults-list processing -------------------------------------

    def compose_file(self, rel: str, group: str = "") -> dict:
        """Compose one YAML file (resolving its own defaults list)."""
        path = self.config_dir / f"{rel}.yaml"
        body = _load_yaml(path)
        defaults = body.pop("defaults", None)
        if defaults is None:
            return body

        cfg: dict = {}
        self_merged = False
        for entry in defaults:
            if entry == "_self_":
                _deep_merge(cfg, body)
                self_merged = True
            elif isinstance(entry, str):
                self._merge_named(cfg, entry, group)
            elif isinstance(entry, dict):
                for key, option in entry.items():
                    self._merge_group_entry(cfg, key, option, group)
            else:
                raise ConfigError(f"bad defaults entry in {path}: {entry!r}")
        if not self_merged:
            _deep_merge(cfg, body)
        return cfg

    def _merge_named(self, cfg: dict, entry: str, group: str) -> None:
        optional = entry.startswith("optional ")
        name = entry.removeprefix("optional ")
        if name in _SCHEMA_REGISTRY:
            _deep_merge(cfg, copy.deepcopy(_SCHEMA_REGISTRY[name]))
            return
        rel = f"{group}/{name}" if group else name
        if not (self.config_dir / f"{rel}.yaml").exists():
            if optional:
                return
            raise ConfigError(f"defaults entry '{entry}' not found (in group '{group}')")
        _deep_merge(cfg, self.compose_file(rel, group))

    def _merge_group_entry(self, cfg: dict, key: str, option: Any, group: str) -> None:
        if key.startswith("override "):
            # experiment-style root group override: `override /model: cryovit`
            target = key.removeprefix("override ").lstrip("/")
            if target.startswith("hydra"):
                return
            self.choices.setdefault(target, option)
            return
        optional = key.startswith("optional ")
        key = key.removeprefix("optional ")
        if key.startswith("hydra"):
            return
        subgroup = f"{group}/{key}" if group else key
        # an explicit user choice for this group wins over the file default
        option = self.choices.get(subgroup, option)
        if option is None:
            return
        if option == MISSING:
            raise ConfigError(
                f"config group '{subgroup}' is required: pass '{subgroup}=<option>'"
            )
        if isinstance(option, str) and option.startswith("${"):
            # deferred choice like `optional trainer_model: ${model}`
            ref = option[2:-1]
            option = self.choices.get(ref)
            if option is None:
                return
            optional = True
        options = option if isinstance(option, list) else [option]
        merged_any = False
        for opt in options:
            rel = f"{subgroup}/{opt}"
            path = self.config_dir / f"{rel}.yaml"
            if not path.exists():
                if optional:
                    continue
                raise ConfigError(f"config group '{subgroup}' has no option '{opt}'")
            sub = self.compose_file(rel, subgroup)
            merged_any = True
            if subgroup.endswith("experiments") or _is_global_package(path):
                _deep_merge(cfg, sub)  # @package _global_
            else:
                node = cfg
                for part in key.split("/"):
                    node = node.setdefault(part, {})
                _deep_merge(node, sub)
        if merged_any and not isinstance(option, list):
            self.choices.setdefault(subgroup, str(option))


# ---- interpolation ------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _resolve_interp(root: dict, choices: dict, text: str, seen: tuple = ()) -> Any:
    def lookup(expr: str) -> Any:
        expr = expr.strip()
        if expr in seen:
            raise ConfigError(f"interpolation cycle at ${{{expr}}}")
        if expr.startswith("env:"):
            spec = expr[4:]
            var, _, default = spec.partition(",")
            return os.environ.get(var.strip(), default.strip() or None)
        if expr.startswith("choices.") or expr.startswith("hydra:runtime.choices."):
            grp = expr.split("choices.", 1)[1]
            return choices.get(grp, "any")
        try:
            val = _get_path(root, expr)
        except KeyError:
            raise ConfigError(f"interpolation key not found: ${{{expr}}}") from None
        if isinstance(val, str) and _INTERP_RE.search(val):
            return _resolve_interp(root, choices, val, seen + (expr,))
        return val

    full = _INTERP_RE.fullmatch(text)
    if full:
        return lookup(full.group(1))
    return _INTERP_RE.sub(lambda m: str(lookup(m.group(1))), text)


def _resolve_all(root: dict, choices: dict, node: Any) -> Any:
    if isinstance(node, dict):
        return DotDict({k: _resolve_all(root, choices, v) for k, v in node.items()})
    if isinstance(node, list):
        return [_resolve_all(root, choices, v) for v in node]
    if isinstance(node, str) and "${" in node:
        return _resolve_all(root, choices, _resolve_interp(root, choices, node))
    return node


# ---- public API ----------------------------------------------------------

def compose(
    config_name: str,
    overrides: list[str] | None = None,
    config_dir: str | Path | None = None,
    resolve: bool = True,
) -> DotDict:
    """Compose a root config with hydra-style overrides.

    Override forms: ``group=option`` (group choice), ``+experiments=name``
    (merge an experiment at root), ``key.path=value`` (leaf set).
    """
    config_dir = Path(config_dir) if config_dir else _DEFAULT_CONFIG_DIR
    overrides = list(overrides or [])

    group_choices: dict[str, str] = {}
    experiment: str | None = None
    leaf_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        add = ov.startswith("+")
        key, sep, value = ov.lstrip("+").partition("=")
        if not sep:
            raise ConfigError(f"bad override (expected key=value): {ov!r}")
        if key == "experiments" or key == "experiment":
            experiment = value
        elif (
            not add
            and "." not in key
            and (config_dir / key).is_dir()
            and (config_dir / key / f"{value}.yaml").exists()
        ):
            group_choices[key] = value
        elif not add and "." in key and (config_dir / key.replace(".", "/") / f"{value}.yaml").exists():
            group_choices[key.replace(".", "/")] = value
        else:
            leaf_overrides.append((key, _parse_value(value)))

    # Experiment files may pin group choices via `override /group:`; peek at
    # them before composing so defaults resolve with the right options.
    composer = _Composer(config_dir=config_dir, choices=dict(group_choices))
    exp_body: dict | None = None
    if experiment is not None:
        exp_body = _load_yaml(config_dir / "experiments" / f"{experiment}.yaml")
        for entry in exp_body.get("defaults", []) or []:
            if isinstance(entry, dict):
                for key, option in entry.items():
                    if key.startswith("override "):
                        target = key.removeprefix("override ").lstrip("/")
                        if not target.startswith("hydra"):
                            composer.choices.setdefault(target, option)

    cfg = composer.compose_file(config_name)

    if exp_body is not None:
        body = {k: v for k, v in exp_body.items() if k not in ("defaults", "hydra")}
        _deep_merge(cfg, body)

    for key, value in leaf_overrides:
        _set_path(cfg, key, value)

    cfg = DotDict.wrap(cfg)
    if resolve:
        cfg = _resolve_all(cfg, composer.choices, cfg)
    cfg["_choices_"] = DotDict(composer.choices)
    return cfg


def missing_keys(cfg: dict, prefix: str = "") -> list[str]:
    """List dotted paths whose value is the ``???`` MISSING sentinel."""
    out: list[str] = []
    for key, val in cfg.items():
        if key == "_choices_":
            continue
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.extend(missing_keys(val, prefix=f"{path}."))
        elif val == MISSING:
            out.append(path)
    return out


def _import_target(target: str) -> Any:
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ConfigError(f"bad _target_: {target!r}")
    if module_name.split(".")[0] == "cryovit_tpu":
        # a config copied from the JAX package's tree: never import it
        raise ConfigError(
            f"_target_ {target!r} names the JAX package; the port's counterpart is "
            f"'cryovit_tpu_torch{target[len('cryovit_tpu'):]}'"
        )
    module = importlib.import_module(module_name)
    try:
        return getattr(module, attr)
    except AttributeError as e:
        raise ConfigError(f"no attribute {attr!r} in {module_name}") from e


def instantiate(node: Any, **kwargs: Any) -> Any:
    """Recursively construct objects from ``_target_`` nodes.

    ``_partial_: true`` returns ``functools.partial``. Non-target dicts are
    returned as DotDicts with children instantiated.
    """
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    children = {
        k: instantiate(v)
        for k, v in node.items()
        if k not in ("_target_", "_partial_", "_choices_")
    }
    if "_target_" not in node:
        return DotDict(children)
    fn = _import_target(node["_target_"])
    children.update(kwargs)
    if node.get("_partial_", False):
        return partial(fn, **children)
    return fn(**children)


def expand_sweep_file(
    experiment: str, config_dir: str | Path | None = None
) -> list[list[str]]:
    """Expand the sweep grid of an experiment YAML without composing the
    full config (sweep params may themselves fill required config groups,
    e.g. ``test_experiment`` sweeps ``datamodule``)."""
    config_dir = Path(config_dir) if config_dir else _DEFAULT_CONFIG_DIR
    body = _load_yaml(config_dir / "experiments" / f"{experiment}.yaml")
    return expand_sweep(body)


def expand_sweep(cfg: dict) -> list[list[str]]:
    """Expand a ``sweep.params`` grid into a list of override lists.

    The reference expresses sweeps via hydra MULTIRUN
    (``configs/experiments/*.yaml``); the JAX package and the port keep the
    same grids under a ``sweep: params:`` key. Values may be lists or
    comma-strings.
    """
    sweep = cfg.get("sweep") or {}
    params: dict[str, Any] = sweep.get("params") or {}
    if not params:
        return [[]]
    keys, value_lists = [], []
    for key, vals in params.items():
        if isinstance(vals, str):
            vals = [v.strip() for v in vals.split(",")]
        elif not isinstance(vals, list):
            vals = [vals]
        keys.append(key)
        value_lists.append(vals)
    return [
        [f"{k}={v}" for k, v in zip(keys, combo)]
        for combo in itertools.product(*value_lists)
    ]
