"""Config system: a three-document YAML file, an argparse parser made
from it, and command-line overrides merged onto its defaults.

Port of ``mindrec_tpu/config.py`` (``Config``, ``parse_yaml``,
``parse_cli_to_yaml``, ``get_config``), with the same behaviour.  A YAML
file holds up to three documents: the defaults, a help string per
option and the allowed choices per option.

PyYAML is not among the packages of every machine the port runs on, so
:func:`parse_yaml` reads, with its own code, the subset of YAML that
these files use, and gives the values ``yaml.safe_load_all`` gives:

* documents separated by ``---`` lines (at most three);
* ``key: value`` lines at the left margin, and ``#`` comments (a plain
  key is resolved as a scalar is, so ``off:`` is the key False);
* scalars resolved as PyYAML's YAML 1.1 resolver resolves them: null
  (``~``, ``null``, nothing), booleans (``true``/``yes``/``on`` and their
  negatives, in three cases), decimal integers and floats (a float has a
  dot; ``1e-5`` is a string), ``.inf`` and ``.nan``, else a string;
  single- and double-quoted strings;
* flow lists ``[a, b, ...]`` of those scalars, nested or empty.

Anything else (nested or block mappings, block lists, anchors, tags,
multi-line values, flow mappings, octal, hex or sexagesimal numbers)
raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import argparse
import ast
import math
import re
from pathlib import Path


class Config:
    """Attribute-style dict (reference ``Config``)."""

    def __init__(self, d: dict):
        for k, v in d.items():
            setattr(self, k, Config(v) if isinstance(v, dict) else v)

    def __repr__(self):
        return "Config(" + ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items()) + ")"

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out


# PyYAML's implicit resolvers (yaml/resolver.py), the forms this parser
# supports
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# other numeric forms PyYAML resolves (octal, binary, hex, base 60)
_OTHER_NUMBER = re.compile(r"[-+]?0[0-7_]+$|[-+]?0b[01_]+$|[-+]?0x[0-9a-fA-F_]+$"
                           r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*$")


class _Line:
    """One value being parsed: its text and line number (for errors)."""

    def __init__(self, text: str, lineno: int):
        self.text, self.pos, self.lineno = text, 0, lineno

    def fail(self, msg: str):
        raise ValueError(f"yaml line {self.lineno}: {msg}: {self.text!r}")

    def peek(self) -> str:
        return self.text[self.pos: self.pos + 1]

    def skip_space(self):
        while self.peek() in (" ", "\t") and self.peek():
            self.pos += 1


def _plain(word: str, line: _Line):
    """Resolve a plain (unquoted) scalar as PyYAML does."""
    if word in _NULL:
        return None
    if word in _BOOL:
        return _BOOL[word]
    if _INT.match(word):
        return int(word.replace("_", ""))
    if _FLOAT.match(word):
        return float(word.replace("_", ""))
    if _INF.match(word):
        return -math.inf if word.startswith("-") else math.inf
    if _NAN.match(word):
        return math.nan
    if _OTHER_NUMBER.match(word):
        line.fail("octal, binary, hex and base-60 numbers are not supported")
    if word[0] in "&*!|>%@`{":
        line.fail("anchors, aliases, tags, block scalars and flow mappings "
                  "are not supported")
    if word.startswith("- ") or word == "-":
        line.fail("block lists are not supported")
    return word


def _quoted(line: _Line) -> str:
    q = line.peek()
    line.pos += 1
    out = []
    while True:
        c = line.peek()
        if not c:
            line.fail("unterminated quoted string")
        line.pos += 1
        if c == q:
            if q == "'" and line.peek() == "'":  # '' inside '...'
                out.append("'")
                line.pos += 1
                continue
            return "".join(out)
        if c == "\\" and q == '"':
            e = line.peek()
            line.pos += 1
            esc = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
                   "r": "\r", "0": "\0", " ": " "}
            if e not in esc:
                line.fail(f"unsupported escape \\{e}")
            out.append(esc[e])
            continue
        out.append(c)


def _value(line: _Line, in_list: bool):
    """One value from the current position: a quoted string, a flow list
    or a plain scalar (ended by ``,`` or ``]`` inside a list, by a
    `` #`` comment or the end of the line)."""
    line.skip_space()
    c = line.peek()
    if c in ("'", '"'):
        return _quoted(line)
    if c == "[":
        line.pos += 1
        items = []
        line.skip_space()
        if line.peek() == "]":
            line.pos += 1
            return items
        while True:
            items.append(_value(line, in_list=True))
            line.skip_space()
            c = line.peek()
            line.pos += 1
            if c == "]":
                return items
            if c != ",":
                line.fail("expected ',' or ']' in a flow list")
    start = line.pos
    while True:
        c = line.peek()
        if not c:
            break
        if in_list and c in ",]":
            break
        if c == "#" and line.pos > start and line.text[line.pos - 1] in " \t":
            break
        if c == ":" and line.text[line.pos + 1: line.pos + 2] in ("", " "):
            line.fail("nested mappings are not supported")
        line.pos += 1
    word = line.text[start: line.pos].strip()
    if in_list and not word:
        line.fail("empty item in a flow list")
    return _plain(word, line)


def _document(lines) -> dict | None:
    """``(lineno, text)`` lines of one document -> its mapping (None when
    it holds nothing, as ``yaml.safe_load`` gives)."""
    out = {}
    for lineno, text in lines:
        body = text.rstrip()
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        line = _Line(body, lineno)
        if body[0] in " \t":
            line.fail("indented lines (nested or block values) are not "
                      "supported")
        if body.startswith("- ") or body == "-":
            line.fail("block lists are not supported")
        if body.startswith(("'", '"')):
            key = _quoted(line)
        else:
            m = re.match(r"[^:#]*", body)
            key = m.group(0).rstrip()
            line.pos = len(m.group(0))
            if not _KEY.match(key):
                line.fail("expected 'key: value' with a plain key")
            key = _plain(key, line)  # PyYAML resolves keys too
        line.skip_space()
        if line.peek() != ":" or line.text[line.pos + 1: line.pos + 2] not in ("", " ", "\t"):
            line.fail("expected 'key: value'")
        line.pos += 1
        value = _value(line, in_list=False)
        line.skip_space()
        rest = line.text[line.pos:]
        if rest and not rest.startswith("#"):
            line.fail("unexpected text after the value")
        if key in out:
            line.fail(f"duplicate key {key!r}")
        out[key] = value
    return out or None


def load_documents(text: str) -> list:
    """The documents of a YAML text in the supported subset, each a dict
    (or None for an empty document), as ``list(yaml.safe_load_all(text))``
    gives them."""
    docs, cur, started = [], [], False

    def has_content(lines):
        return any(t.strip() and not t.lstrip().startswith("#")
                   for _n, t in lines)

    for lineno, raw in enumerate(text.splitlines(), start=1):
        if raw.startswith("%"):
            raise ValueError(f"yaml line {lineno}: directives are not "
                             f"supported: {raw!r}")
        if raw.rstrip() == "...":
            raise ValueError(f"yaml line {lineno}: document end markers are "
                             f"not supported")
        if raw.rstrip() == "---" or raw.startswith("--- "):
            tail = raw[3:].strip()
            if tail and not tail.startswith("#"):
                raise ValueError(f"yaml line {lineno}: content after '---' "
                                 f"is not supported: {raw!r}")
            if started or has_content(cur):
                docs.append(_document(cur))
            cur, started = [], True
            continue
        cur.append((lineno, raw))
    if started or has_content(cur):
        docs.append(_document(cur))
    return docs


def parse_yaml(path: str | Path) -> tuple[dict, dict, dict]:
    """Parse a 1-3 document yaml: (defaults, helps, choices)."""
    with open(path, encoding="utf-8") as f:
        docs = load_documents(f.read())
    docs = [d or {} for d in docs]
    if len(docs) == 1:
        return docs[0], {}, {}
    if len(docs) == 2:
        return docs[0], docs[1], {}
    if len(docs) == 3:
        return docs[0], docs[1], docs[2]
    raise ValueError("at most 3 yaml documents supported")


def _coerce(value_str: str, default):
    """Parse a CLI string into the type of the default value."""
    if isinstance(default, bool):
        return value_str.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(value_str)
    if isinstance(default, float):
        return float(value_str)
    if isinstance(default, (list, tuple)):
        return ast.literal_eval(value_str)
    return value_str


def parse_cli_to_yaml(defaults: dict, helps: dict, choices: dict, argv=None,
                      description: str = "config"):
    """Generate argparse options from yaml defaults and merge overrides."""
    parser = argparse.ArgumentParser(description=description)
    for key, _default in defaults.items():
        parser.add_argument(
            f"--{key}",
            type=str,
            default=None,
            help=str(helps.get(key, "")),
        )
    args, _ = parser.parse_known_args(argv)
    merged = dict(defaults)
    for key, default in defaults.items():
        v = getattr(args, key, None)
        if v is not None:
            v = _coerce(v, default)
            if key in choices and v not in choices[key]:
                raise ValueError(f"{key}={v!r} not in choices {choices[key]}")
            merged[key] = v
    return merged


def get_config(yaml_path: str | Path, argv=None) -> Config:
    """Load defaults from yaml, apply CLI overrides, return Config."""
    defaults, helps, choices = parse_yaml(yaml_path)
    merged = parse_cli_to_yaml(defaults, helps, choices, argv)
    return Config(merged)
