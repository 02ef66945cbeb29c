# Verbatim copy of svdfeature_tpu/config.py; tests/test_torch_data.py keeps the two identical.
"""Config-file parsing with the reference's semantics.

The reference parses ``name = val`` files with a hand-rolled tokenizer
(apex-utils/apex_config.h:31-124): ``#`` starts a comment to end of line,
values may be double-quoted with ``\\`` escapes, ``=`` is a token by itself,
and a name/=/val triple must not span a newline between name and ``=`` or
``=`` and val.  CLI arguments ``key=val`` are overlaid at high priority via
ConfigSaver (apex-utils/apex_config.h:131-181) and replayed in order into
every component's ``set_param``.  Unknown keys are silently ignored — that
is the extension mechanism.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple


class ConfigError(ValueError):
    pass


def _tokenize(text: str) -> Iterator[Tuple[str, bool]]:
    """Yield (token, saw_newline_before_token) mirroring get_next_token
    (apex-utils/apex_config.h:57-100)."""
    i, n = 0, len(text)
    new_line = False
    buf: List[str] = []
    while i < n:
        ch = text[i]
        if ch == "#":
            while i < n and text[i] not in "\r\n":
                i += 1
            new_line = True
        elif ch == '"':
            if buf:
                raise ConfigError("token followed directly by string")
            i += 1
            sbuf: List[str] = []
            while True:
                if i >= n:
                    raise ConfigError("unterminated string")
                c = text[i]
                if c == "\\":
                    i += 1
                    if i < n:
                        sbuf.append(text[i])
                    i += 1
                elif c == '"':
                    i += 1
                    break
                elif c in "\r\n":
                    raise ConfigError("unterminated string")
                else:
                    sbuf.append(c)
                    i += 1
            yield "".join(sbuf), new_line
            new_line = False
        elif ch == "=":
            if not buf:
                yield "=", new_line
                new_line = False
                i += 1
            else:
                yield "".join(buf), new_line
                buf = []
                new_line = False
                # do not consume '='; re-process it next round
        elif ch in "\r\n\t ":
            if ch in "\r\n" and not buf:
                new_line = True
            i += 1
            if buf:
                yield "".join(buf), new_line
                buf = []
                new_line = False
        else:
            buf.append(ch)
            i += 1
    if buf:
        yield "".join(buf), new_line


class ConfigReader:
    """Parse a reference-format config file into (name, val) pairs.

    Equivalent of apex_utils::ConfigIterator (apex-utils/apex_config.h:31-124):
    silently stops yielding on a malformed triple (the reference's next()
    returns false), so trailing junk is ignored rather than an error.
    """

    def __init__(self, path: str | None = None, text: str | None = None):
        if text is None:
            if path is None:
                raise ValueError("need path or text")
            with open(path, "r") as f:
                text = f.read()
        self._pairs = list(self._parse(text))

    @staticmethod
    def _parse(text: str) -> Iterator[Tuple[str, str]]:
        toks = _tokenize(text)
        while True:
            try:
                name, _ = next(toks)
            except StopIteration:
                return
            if name == "=":
                return
            try:
                eq, nl_eq = next(toks)
                val, nl_val = next(toks)
            except StopIteration:
                return
            if nl_eq or eq != "=":
                return
            if nl_val or val == "=":
                return
            yield name, val

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return iter(self._pairs)

    def items(self) -> List[Tuple[str, str]]:
        return list(self._pairs)


class ConfigSaver:
    """Ordered replay store with a high-priority (CLI) overlay.

    Equivalent of apex_utils::ConfigSaver (apex-utils/apex_config.h:131-181):
    normal entries replay first in insertion order, then high-priority
    entries, so CLI ``key=val`` overrides win because each component's
    set_param takes the last value it sees.
    """

    def __init__(self) -> None:
        self._low: List[Tuple[str, str]] = []
        self._high: List[Tuple[str, str]] = []

    def push_back(self, name: str, val: str) -> None:
        self._low.append((name, val))

    def push_back_high(self, name: str, val: str) -> None:
        self._high.append((name, val))

    def load_file(self, path: str) -> None:
        for name, val in ConfigReader(path):
            self.push_back(name, val)

    def load_cli(self, args: List[str]) -> None:
        """Parse trailing CLI args of the form key=val (apex_task.h:42-47)."""
        for a in args:
            if "=" not in a:
                raise ConfigError(f"unknown arg (expected key=val): {a}")
            name, val = a.split("=", 1)
            self.push_back_high(name, val)

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        yield from self._low
        yield from self._high

    def replay(self, *sinks) -> None:
        """Feed every (name, val) in order into each sink's set_param."""
        for name, val in self:
            for sink in sinks:
                sink.set_param(name, val)

    def get(self, name: str, default: str | None = None) -> str | None:
        """Last-wins lookup for a single key."""
        out = default
        for n, v in self:
            if n == name:
                out = v
        return out
