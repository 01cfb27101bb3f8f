"""Scene-description-language (SDL) parser (``akari_tpu/scene/sdl.py``).

Recursive-descent parser for ``.akari`` files: statements
``import "file" as alias`` / ``let name = value`` / ``export name = value``;
values are numbers, strings, booleans, arrays, ``$accessor.path``
cross-module references, and ``Type { field: value, ... }`` object
creation resolved through a node registry (scene/sdl_nodes.py). ``//``
line comments. An exception a node factory raises becomes an ``SDLError``
naming the type and the source location, as in the reference.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass


class SDLError(Exception):
    def __init__(self, msg, loc=None):
        super().__init__(f"{loc}: {msg}" if loc else msg)
        self.loc = loc


@dataclass
class SourceLoc:
    """ref: parser.h SourceLoc error reporting."""

    file: str
    line: int
    col: int

    def __str__(self):
        return f"{self.file}:{self.line}:{self.col}"


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
  | (?P<number>-?\d+(\.\d*)?([eE][+-]?\d+)?|-?\.\d+)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<accessor>\$[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<punct>[{}\[\]:,=])
""",
    re.VERBOSE,
)

_KEYWORDS = {"import", "as", "let", "export", "true", "false"}


def _tokenize(src, filename):
    pos = 0
    line = 1
    line_start = 0
    tokens = []
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            loc = SourceLoc(filename, line, pos - line_start + 1)
            raise SDLError(f"unexpected character {src[pos]!r}", loc)
        kind = m.lastgroup
        text = m.group()
        if kind not in ("ws", "comment"):
            tokens.append(
                (kind, text, SourceLoc(filename, line, m.start() - line_start + 1))
            )
        nl = text.count("\n")
        if nl:
            line += nl
            line_start = m.start() + text.rfind("\n") + 1
        pos = m.end()
    tokens.append(("eof", "", SourceLoc(filename, line, 1)))
    return tokens


class Module:
    """ref: parser.h Module{submodules, exports, locals}."""

    def __init__(self, name=""):
        self.name = name
        self.submodules = {}
        self.exports = {}
        self.locals = {}

    def lookup(self, path):
        parts = path.split(".")
        mod = self
        for p in parts[:-1]:
            if p in mod.submodules:
                mod = mod.submodules[p]
            else:
                raise SDLError(f"unknown module {p!r} in ${path}")
        name = parts[-1]
        if name in mod.exports:
            return mod.exports[name]
        if mod is self and name in mod.locals:
            return mod.locals[name]
        raise SDLError(f"unknown name {name!r} in ${path}")


class Parser:
    """Recursive-descent SDL parser with a node-factory registry hook
    (``do_parse_object_creation`` analog, ref parser.cpp:267-298)."""

    def __init__(self, registry=None, search_paths=()):
        from . import sdl_nodes

        self.registry = registry if registry is not None else sdl_nodes.REGISTRY
        self.search_paths = list(search_paths)

    # ---- token helpers ----
    def _peek(self):
        return self.tokens[self.i]

    def _next(self):
        t = self.tokens[self.i]
        self.i += 1
        return t

    def _expect(self, kind=None, text=None):
        k, t, loc = self._next()
        if kind and k != kind:
            raise SDLError(f"expected {kind}, got {t!r}", loc)
        if text and t != text:
            raise SDLError(f"expected {text!r}, got {t!r}", loc)
        return k, t, loc

    # ---- entry points ----
    def parse_file(self, path, module_name=""):
        with open(path) as f:
            src = f.read()
        base = os.path.dirname(os.path.abspath(path))
        return self.parse_string(src, filename=path, base_dir=base,
                                 module_name=module_name)

    def parse_string(self, src, filename="<string>", base_dir=".", module_name=""):
        saved = getattr(self, "tokens", None), getattr(self, "i", 0), \
            getattr(self, "module", None), getattr(self, "base_dir", ".")
        self.tokens = _tokenize(src, filename)
        self.i = 0
        self.module = Module(module_name)
        self.base_dir = base_dir
        try:
            while self._peek()[0] != "eof":
                self._parse_statement()
            return self.module
        finally:
            if saved[0] is not None:
                self.tokens, self.i, self.module, self.base_dir = saved

    # ---- statements (ref parser.cpp:150-165) ----
    def _parse_statement(self):
        k, t, loc = self._peek()
        if t == "import":
            self._parse_import()
        elif t == "let":
            self._parse_let(export=False)
        elif t == "export":
            self._next()
            self._parse_let(export=True, consumed_kw=True)
        else:
            raise SDLError(f"unexpected token {t!r}", loc)

    def _parse_import(self):
        self._expect(text="import")
        _, fname, loc = self._expect("string")
        fname = fname[1:-1]
        self._expect(text="as")
        _, alias, _ = self._expect("ident")
        path = self._resolve_path(fname, loc)
        sub = Parser(self.registry, self.search_paths).parse_file(path, alias)
        self.module.submodules[alias] = sub

    def _resolve_path(self, fname, loc):
        candidates = [os.path.join(self.base_dir, fname), fname]
        candidates += [os.path.join(p, fname) for p in self.search_paths]
        for c in candidates:
            if os.path.exists(c):
                return c
        raise SDLError(f"cannot find import {fname!r}", loc)

    def _parse_let(self, export, consumed_kw=False):
        if not consumed_kw:
            self._expect(text="let")
        _, name, _ = self._expect("ident")
        self._expect(text="=")
        value = self._parse_value()
        self.module.locals[name] = value
        if export:
            self.module.exports[name] = value

    # ---- values (ref parser.cpp:267-298) ----
    def _parse_value(self):
        k, t, loc = self._peek()
        if k == "number":
            self._next()
            return float(t) if ("." in t or "e" in t or "E" in t) else int(t)
        if k == "string":
            self._next()
            return t[1:-1]
        if t in ("true", "false"):
            self._next()
            return t == "true"
        if k == "accessor":
            self._next()
            return self.module.lookup(t[1:])
        if t == "[":
            return self._parse_array()
        if k == "ident":
            return self._parse_object()
        raise SDLError(f"unexpected value token {t!r}", loc)

    def _parse_array(self):
        self._expect(text="[")
        items = []
        while True:
            if self._peek()[1] == "]":
                self._next()
                return items
            items.append(self._parse_value())
            if self._peek()[1] == ",":
                self._next()

    def _parse_object(self):
        _, type_name, loc = self._expect("ident")
        self._expect(text="{")
        fields = {}
        while True:
            k, t, floc = self._peek()
            if t == "}":
                self._next()
                break
            _, fname, _ = self._expect("ident")
            self._expect(text=":")
            fields[fname] = self._parse_value()
            if self._peek()[1] == ",":
                self._next()
        factory = self.registry.get(type_name)
        if factory is None:
            raise SDLError(f"unknown node type {type_name!r}", loc)
        try:
            return factory(fields, base_dir=self.base_dir)
        except SDLError:
            raise
        except Exception as e:
            raise SDLError(f"creating {type_name}: {e}", loc)


def parse_file(path, registry=None):
    return Parser(registry).parse_file(path)


def parse_string(src, registry=None, base_dir="."):
    return Parser(registry).parse_string(src, base_dir=base_dir)
