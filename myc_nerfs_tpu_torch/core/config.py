"""Config loading (counterpart of myc_nerfs_tpu/core/config.py).

- Python-module configs with ``_base_`` file inheritance and ``_cover_``
  subtree replacement (jnerf utils/config.py:33-101), as ``configs/ngp/*.py``
  use them;
- YAML configs with ``_parent_`` chains (barf options.py:54-67), as
  ``configs/barf/*.yaml`` use them, read by this module's own reader
  (``parse_yaml``), so no yaml package is needed;
- dot-path overrides ``--a.b.c=v``, ``--flag`` and ``--flag!``
  (barf options.py:16-39, 69-85).
"""
from __future__ import annotations

import ast
import copy
import importlib.util
import os
import re
from typing import Any, Dict, List, Optional, Tuple


class Config(dict):
    """Nested dict with attribute access (edict-style)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(d: Any) -> Any:
        if isinstance(d, dict):
            return Config({k: Config.wrap(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Config.wrap(v) for v in d]
        return d


def _module_globals(path: str) -> Dict[str, Any]:
    spec = importlib.util.spec_from_file_location("_cfg_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(importlib))}


def _merge(base: Dict, child: Dict) -> Dict:
    """Recursive merge; a child subtree with ``_cover_: True`` replaces the
    base subtree outright."""
    out = copy.deepcopy(base)
    for k, v in child.items():
        if isinstance(v, dict) and v.pop("_cover_", False):
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_py_config(path: str) -> Config:
    """Python-module config with ``_base_`` inheritance."""
    cfg = _module_globals(path)
    base = cfg.pop("_base_", None)
    if base:
        bases = base if isinstance(base, (list, tuple)) else [base]
        merged: Dict[str, Any] = {}
        for b in bases:
            bpath = os.path.join(os.path.dirname(path), b)
            merged = _merge(merged, dict(load_py_config(bpath)))
        cfg = _merge(merged, cfg)
    return Config.wrap(cfg)


# -- the YAML reader -----------------------------------------------------------
#
# The subset of YAML 1.1 that configs use: maps nested by indentation, block
# and flow lists of scalars (flow lists nest), plain and quoted scalars, and
# comments. Plain scalars resolve as PyYAML's safe_load resolves them (its
# implicit resolvers for null, bool, int and float). Anything else raises
# ValueError: a number in another form (octal, hex, binary, sexagesimal),
# anchors, aliases, tags, block scalars, flow maps, lists of maps or lists,
# multi-line flow lists.

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_FLOAT_SPECIAL = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                  "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
                  ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
_FLOAT_OTHER = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_DQ_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
               "0": "\0", "b": "\b"}


def _plain_scalar(text: str) -> Any:
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _FLOAT_SPECIAL:
        return _FLOAT_SPECIAL[text]
    if _INT_OTHER.match(text) or _FLOAT_OTHER.match(text):
        raise ValueError(f"YAML number {text!r} is in a form this reader does not read")
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"YAML construct {text!r} is not in the subset read here")
    return text


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    """The quoted string starting at text[pos] and the position after it."""
    quote = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _DQ_ESCAPES:
                raise ValueError(f"YAML escape \\{esc} is not in the subset read here")
            out.append(_DQ_ESCAPES[esc])
            i += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"unterminated YAML string: {text[pos:]!r}")


def _flow(text: str, pos: int) -> Tuple[Any, int]:
    """The flow list or scalar starting at text[pos]; returns (value,
    position after it)."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if text[pos:pos + 1] == "[":
        items: List[Any] = []
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise ValueError(f"unterminated YAML flow list: {text!r}")
            if text[pos] == "]":
                return items, pos + 1
            value, pos = _flow(text, pos)
            items.append(value)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if text[pos:pos + 1] == ",":
                pos += 1
            elif text[pos:pos + 1] != "]":
                raise ValueError(f"malformed YAML flow list: {text!r}")
    if text[pos:pos + 1] == "{":
        raise ValueError(f"YAML flow maps are not in the subset read here: {text!r}")
    if text[pos:pos + 1] in ("'", '"'):
        return _quoted(text, pos)
    end = pos
    while end < len(text) and text[end] not in ",]":
        end += 1
    return _plain_scalar(text[pos:end].strip()), end


def _value(text: str) -> Any:
    """A whole inline value: a flow list, a quoted or a plain scalar."""
    value, end = _flow(text, 0)
    if text[end:].strip():
        raise ValueError(f"unexpected text after a YAML value: {text!r}")
    return value


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str) -> Optional[Tuple[Any, str]]:
    """(key, rest) of a ``key: rest`` map entry, or None."""
    if content[:1] in "'\"":
        key, end = _quoted(content, 0)
        rest = content[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, rest[1:].strip()
        return None
    m = re.match(r"^([^\[\]{},#'\"][^:]*?|[^\[\]{},#'\"]):(?: (.*)|)$", content)
    if m is None:
        return None
    return _plain_scalar(m.group(1).strip()), (m.group(2) or "").strip()


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at lines[i], at ``indent``."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        out: List[Any] = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].lstrip()
            if not rest or _split_key(rest) is not None:
                raise ValueError(f"YAML lists of maps or lists are not in the subset read "
                                 f"here: {lines[i][1]!r}")
            out.append(_value(rest))
            i += 1
        return out, i
    out_map: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        entry = _split_key(lines[i][1])
        if entry is None:
            raise ValueError(f"not a YAML map entry: {lines[i][1]!r}")
        key, rest = entry
        if key in out_map:
            raise ValueError(f"duplicate YAML key {key!r}")
        i += 1
        if rest:
            out_map[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-"
                                           or lines[i][1].startswith("- ")))):
            out_map[key], i = _block(lines, i, lines[i][0])
        else:
            out_map[key] = None
    return out_map, i


def parse_yaml(text: str) -> Any:
    """The value of a YAML document in the subset that configs use (see
    above), equal to ``yaml.safe_load(text)`` on it; None when empty."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip() or (not lines and line.strip() == "---"):
            continue
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError("YAML indentation must be spaces")
        lines.append((len(line) - len(body), body))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"bad YAML indentation at {lines[i][1]!r}")
    return value


def load_yaml_config(path: str) -> Config:
    """YAML config with ``_parent_`` chains (barf options.py:54-67)."""
    with open(path) as f:
        cfg = parse_yaml(f.read()) or {}
    parent = cfg.pop("_parent_", None)
    if parent:
        candidates = [parent,
                      os.path.join(os.path.dirname(path), parent),
                      os.path.join(os.path.dirname(path),
                                   os.path.basename(parent))]
        ppath = next((c for c in candidates if os.path.exists(c)), parent)
        cfg = _merge(dict(load_yaml_config(ppath)), cfg)
    return Config.wrap(cfg)


def load_config(path: str) -> Config:
    if path.endswith(".py"):
        return load_py_config(path)
    return load_yaml_config(path)


def parse_value(s: str) -> Any:
    """A Python literal where ``s`` is one, else the string itself."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_overrides(cfg: Config, args: List[str], strict: bool = True) -> Config:
    """Dot-path overrides: --a.b.c=v, --flag (True), --flag! (False).

    With ``strict`` a key the config does not have raises KeyError (in place
    of the reference's interactive prompt, options.py:76-83). Returns a new
    Config; ``cfg`` is not modified.
    """
    cfg = Config.wrap(copy.deepcopy(dict(cfg)))
    for arg in args:
        if not arg.startswith("--"):
            raise ValueError(f"override must start with --: {arg}")
        body = arg[2:]
        if "=" in body:
            key, val = body.split("=", 1)
            value = parse_value(val)
        elif body.endswith("!"):
            key, value = body[:-1], False
        else:
            key, value = body, True
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                if strict and p not in node:
                    raise KeyError(f"unknown config path: {key}")
                node[p] = Config()
            node = node[p]
        if strict and parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        node[parts[-1]] = value
    return cfg


_global_cfg: Optional[Config] = None


def init_cfg(cfg_or_path) -> Config:
    """Set the global config singleton (jnerf config.py:144-155)."""
    global _global_cfg
    _global_cfg = (load_config(cfg_or_path) if isinstance(cfg_or_path, str)
                   else Config.wrap(cfg_or_path))
    return _global_cfg


def get_cfg() -> Optional[Config]:
    return _global_cfg
