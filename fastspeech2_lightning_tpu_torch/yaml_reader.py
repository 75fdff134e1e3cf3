"""A YAML reader without ``yaml``: ``safe_load(text)`` returns what
``yaml.safe_load`` (PyYAML, YAML 1.1) returns for the same text.

The reader follows PyYAML's pipeline. A scanner turns the text into tokens:
block structure comes from indentation, and a "simple key" is a one-line
scalar or flow collection that turns out to be a key once its ``:`` is found.
A recursive-descent parser builds nodes from the tokens, with anchors,
aliases and tags, and resolves the tags of plain scalars. A constructor
builds Python values from the nodes: ``<<`` merge keys, timestamps as
``datetime.date`` / ``datetime.datetime`` and ``!!binary`` as bytes. The
tags read are the standard ``!!str``, ``!!int``, ``!!float``, ``!!bool``,
``!!null``, ``!!map``, ``!!seq``, ``!!binary`` and ``!!timestamp``; any
other (``!!python/...``, a local ``!tag``; also ``!!set``, ``!!omap`` and
``!!pairs``, which no config uses) is refused, as is a stream of more than
one document; an empty stream is None.

Everything ``yaml.safe_load`` refuses raises ``YAMLError``, a ValueError
whose message gives the line and column (1-based). The reader never returns
the raw text of a document it could not read."""

from __future__ import annotations

import base64
import binascii
import collections.abc
import datetime
import re
from typing import Any, Dict, List, Optional, Tuple

Mark = Tuple[int, int, int]  # (index, line, column), 0-based


class YAMLError(ValueError):
    """A document ``yaml.safe_load`` refuses. ``line`` and ``column`` are
    1-based, as in PyYAML's messages."""

    def __init__(self, problem: str, mark: Optional[Mark] = None,
                 context: Optional[str] = None, context_mark: Optional[Mark] = None):
        def where(m):
            return f"line {m[1] + 1}, column {m[2] + 1}"

        parts = []
        if context:
            parts.append(context + (f" (at {where(context_mark)})" if context_mark else ""))
        parts.append(problem + (f" at {where(mark)}" if mark else ""))
        super().__init__("; ".join(parts))
        self.line = mark[1] + 1 if mark else None
        self.column = mark[2] + 1 if mark else None


# ---------------------------------------------------------------------------
# Scalar resolution: PyYAML's implicit resolvers for plain scalars (YAML 1.1)
# ---------------------------------------------------------------------------

TAG_PREFIX = "tag:yaml.org,2002:"
STR, NULL, BOOL, INT, FLOAT = (TAG_PREFIX + t for t in ("str", "null", "bool", "int", "float"))
TIMESTAMP, MERGE, VALUE = (TAG_PREFIX + t for t in ("timestamp", "merge", "value"))
SEQ, MAP = TAG_PREFIX + "seq", TAG_PREFIX + "map"

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
# (tag, pattern, the first characters it is tried on), in PyYAML's order
_RESOLVERS = ((BOOL, _BOOL, "yYnNtTfFoO"), (FLOAT, _FLOAT, "-+0123456789."),
              (INT, _INT, "-+0123456789"), (MERGE, re.compile(r"^(?:<<)$"), "<"),
              (NULL, _NULL, "~nN"), (TIMESTAMP, _TIMESTAMP, "0123456789"),
              (VALUE, re.compile(r"^(?:=)$"), "="))


def resolve_plain(value: str) -> str:
    """The tag of a plain (unquoted, untagged) scalar."""
    if value == "":
        return NULL
    for tag, pattern, first in _RESOLVERS:
        if value[0] in first and pattern.match(value):
            return tag
    return STR


def _sexagesimal(text: str, cast):
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def yaml_int(text: str) -> int:
    """``SafeConstructor.construct_yaml_int``: ints in decimal, octal
    (``010``), hex, binary and base 60, with ``_`` separators."""
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def yaml_float(text: str) -> float:
    """``SafeConstructor.construct_yaml_float``: ``.inf``, ``.nan``, base 60."""
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


_TIMESTAMP_PARTS = re.compile(
    r"^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])"
    r"(?:\.(?P<fraction>[0-9]*))?(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)"
    r"(?::(?P<tz_minute>[0-9][0-9]))?))?)?$")


def yaml_timestamp(text: str):
    """``SafeConstructor.construct_yaml_timestamp``: a date, or a datetime
    (with its time zone when one is written)."""
    m = _TIMESTAMP_PARTS.match(text)
    if m is None:
        raise ValueError(f"not a timestamp: {text!r}")
    v = m.groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0")) if v["fraction"] else 0
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tzinfo)


# ---------------------------------------------------------------------------
# Scanner: text -> tokens (PyYAML's scanner.py)
# ---------------------------------------------------------------------------

# token ids, as PyYAML names them in its messages
STREAM_START, STREAM_END = "<stream start>", "<stream end>"
DIRECTIVE, DOC_START, DOC_END = "<directive>", "<document start>", "<document end>"
BLOCK_SEQ, BLOCK_MAP, BLOCK_END = ("<block sequence start>", "<block mapping start>",
                                   "<block end>")
FLOW_SEQ, FLOW_MAP, FLOW_SEQ_END, FLOW_MAP_END = "[", "{", "]", "}"
BLOCK_ENTRY, FLOW_ENTRY, KEY, VALUE_IND = "-", ",", "?", ":"
ALIAS, ANCHOR, TAG, SCALAR = "<alias>", "<anchor>", "<tag>", "<scalar>"

_BREAK = "\r\n\x85\u2028\u2029"
_END = "\0" + _BREAK
_BLANK_END = "\0 \t" + _BREAK
_WORD = frozenset("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz-_")
_URI = _WORD | frozenset(";/?:@&=+$,.!~*'()[]%")
_HEX = frozenset("0123456789ABCDEFabcdef")
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                            "\U00010000-\U0010ffff]")
ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
           "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
           "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}


class _Token:
    __slots__ = ("id", "value", "start", "end", "plain", "style")

    def __init__(self, id: str, start: Mark, end: Mark, value: Any = None,
                 plain: bool = False, style: Optional[str] = None):
        self.id, self.value, self.start, self.end = id, value, start, end
        self.plain, self.style = plain, style


class _SimpleKey:
    __slots__ = ("token_number", "required", "index", "line", "column", "mark")

    def __init__(self, token_number, required, mark):
        self.token_number, self.required, self.mark = token_number, required, mark
        self.index, self.line, self.column = mark


class _Scanner:
    def __init__(self, text: str):
        bad = _NON_PRINTABLE.search(text)
        if bad:
            idx = bad.start()
            line = len(re.findall("\r\n|[\r\n\x85\u2028\u2029]", text[:idx]))
            col = idx - max(text.rfind(c, 0, idx) for c in "\r\n\x85\u2028\u2029") - 1
            raise YAMLError(f"unacceptable character #x{ord(bad.group()):04x}: special "
                            "characters are not allowed", (idx, line, col))
        self.buf = text + "\0\0\0\0"  # room to look a few characters past the end
        self.ptr = self.line = self.col = 0
        self.done = False
        self.flow_level = 0
        self.tokens: List[_Token] = [_Token(STREAM_START, (0, 0, 0), (0, 0, 0))]
        self.tokens_taken = 0
        self.indent = -1
        self.indents: List[int] = []
        self.allow_simple_key = True
        self.possible: Dict[int, _SimpleKey] = {}

    # -- reading the text ----------------------------------------------------

    def peek(self, i: int = 0) -> str:
        return self.buf[self.ptr + i]

    def prefix(self, n: int) -> str:
        return self.buf[self.ptr:self.ptr + n]

    def forward(self, n: int = 1) -> None:
        buf = self.buf
        for _ in range(n):
            ch = buf[self.ptr]
            self.ptr += 1
            if ch in "\n\x85\u2028\u2029" or (ch == "\r" and buf[self.ptr] != "\n"):
                self.line += 1
                self.col = 0
            elif ch != "\ufeff":
                self.col += 1

    def mark(self) -> Mark:
        return (self.ptr, self.line, self.col)

    # -- the token queue -----------------------------------------------------

    def _fill(self) -> None:
        while self._need_more():
            self._fetch_more()

    def _need_more(self) -> bool:
        """More tokens are scanned while the queue is empty or its head may
        still turn out to be a simple key (a KEY token goes in front of it)."""
        if self.done:
            return False
        if not self.tokens:
            return True
        self._stale()
        return self._next_possible() == self.tokens_taken

    def check(self, *ids: str) -> bool:
        self._fill()
        return bool(self.tokens) and self.tokens[0].id in ids

    def peek_token(self) -> _Token:
        self._fill()
        return self.tokens[0]

    def get_token(self) -> _Token:
        self._fill()
        self.tokens_taken += 1
        return self.tokens.pop(0)

    # -- simple keys ---------------------------------------------------------

    def _next_possible(self) -> Optional[int]:
        return min((k.token_number for k in self.possible.values()), default=None)

    def _stale(self) -> None:
        """Drop the possible simple keys that can no longer be keys (another
        line, or 1024 characters on)."""
        for level in list(self.possible):
            key = self.possible[level]
            if key.line != self.line or self.ptr - key.index > 1024:
                if key.required:
                    raise YAMLError("could not find expected ':'", self.mark(),
                                    "while scanning a simple key", key.mark)
                del self.possible[level]

    def _save_possible(self) -> None:
        required = not self.flow_level and self.indent == self.col
        if self.allow_simple_key:
            self._remove_possible()
            self.possible[self.flow_level] = _SimpleKey(
                self.tokens_taken + len(self.tokens), required, self.mark())

    def _remove_possible(self) -> None:
        key = self.possible.pop(self.flow_level, None)
        if key is not None and key.required:
            raise YAMLError("could not find expected ':'", self.mark(),
                            "while scanning a simple key", key.mark)

    # -- indentation ---------------------------------------------------------

    def _unwind(self, column: int) -> None:
        if self.flow_level:
            return
        while self.indent > column:
            m = self.mark()
            self.indent = self.indents.pop()
            self.tokens.append(_Token(BLOCK_END, m, m))

    def _add_indent(self, column: int) -> bool:
        if self.indent < column:
            self.indents.append(self.indent)
            self.indent = column
            return True
        return False

    # -- fetchers ------------------------------------------------------------

    def _fetch_more(self) -> None:
        self._skip_to_next_token()
        self._stale()
        self._unwind(self.col)
        ch = self.peek()
        if ch == "\0":
            return self._fetch_stream_end()
        if ch == "%" and self.col == 0:
            return self._fetch_directive()
        if ch == "-" and self._at_document_indicator("---"):
            return self._fetch_document_indicator(DOC_START)
        if ch == "." and self._at_document_indicator("..."):
            return self._fetch_document_indicator(DOC_END)
        if ch in "[{":
            return self._fetch_flow_start(FLOW_SEQ if ch == "[" else FLOW_MAP)
        if ch in "]}":
            return self._fetch_flow_end(FLOW_SEQ_END if ch == "]" else FLOW_MAP_END)
        if ch == ",":
            return self._fetch_flow_entry()
        if ch == "-" and self.peek(1) in _BLANK_END:
            return self._fetch_block_entry()
        if ch == "?" and (self.flow_level or self.peek(1) in _BLANK_END):
            return self._fetch_key()
        if ch == ":" and (self.flow_level or self.peek(1) in _BLANK_END):
            return self._fetch_value()
        if ch in "*&":
            return self._fetch_property(self._scan_anchor)
        if ch == "!":
            return self._fetch_property(self._scan_tag)
        if ch in "|>" and not self.flow_level:
            self.allow_simple_key = True
            self._remove_possible()
            self.tokens.append(self._scan_block_scalar(folded=ch == ">"))
            return
        if ch in "'\"":
            return self._fetch_property(lambda: self._scan_flow_scalar(double=ch == '"'))
        if self._check_plain():
            return self._fetch_property(self._scan_plain)
        raise YAMLError(f"found character {ch!r} that cannot start any token", self.mark(),
                        "while scanning for the next token")

    def _at_document_indicator(self, text: str) -> bool:
        return self.col == 0 and self.prefix(3) == text and self.peek(3) in _BLANK_END

    def _check_plain(self) -> bool:
        ch = self.peek()
        return ch not in "\0 \t\r\n\x85\u2028\u2029-?:,[]{}#&*!|>'\"%@`" or (
            self.peek(1) not in _BLANK_END
            and (ch == "-" or (not self.flow_level and ch in "?:")))

    def _fetch_stream_end(self) -> None:
        self._unwind(-1)
        self._remove_possible()
        self.allow_simple_key = False
        self.possible = {}
        m = self.mark()
        self.tokens.append(_Token(STREAM_END, m, m))
        self.done = True

    def _fetch_directive(self) -> None:
        self._unwind(-1)
        self._remove_possible()
        self.allow_simple_key = False
        self.tokens.append(self._scan_directive())

    def _fetch_document_indicator(self, kind: str) -> None:
        self._unwind(-1)
        self._remove_possible()
        self.allow_simple_key = False
        start = self.mark()
        self.forward(3)
        self.tokens.append(_Token(kind, start, self.mark()))

    def _fetch_flow_start(self, kind: str) -> None:
        self._save_possible()
        self.flow_level += 1
        self.allow_simple_key = True
        start = self.mark()
        self.forward()
        self.tokens.append(_Token(kind, start, self.mark()))

    def _fetch_flow_end(self, kind: str) -> None:
        self._remove_possible()
        self.flow_level -= 1
        self.allow_simple_key = False
        start = self.mark()
        self.forward()
        self.tokens.append(_Token(kind, start, self.mark()))

    def _fetch_flow_entry(self) -> None:
        self.allow_simple_key = True
        self._remove_possible()
        start = self.mark()
        self.forward()
        self.tokens.append(_Token(FLOW_ENTRY, start, self.mark()))

    def _fetch_block_entry(self) -> None:
        if not self.flow_level:
            if not self.allow_simple_key:
                raise YAMLError("sequence entries are not allowed here", self.mark())
            if self._add_indent(self.col):
                m = self.mark()
                self.tokens.append(_Token(BLOCK_SEQ, m, m))
        self.allow_simple_key = True
        self._remove_possible()
        start = self.mark()
        self.forward()
        self.tokens.append(_Token(BLOCK_ENTRY, start, self.mark()))

    def _fetch_key(self) -> None:
        if not self.flow_level:
            if not self.allow_simple_key:
                raise YAMLError("mapping keys are not allowed here", self.mark())
            if self._add_indent(self.col):
                m = self.mark()
                self.tokens.append(_Token(BLOCK_MAP, m, m))
        self.allow_simple_key = not self.flow_level
        self._remove_possible()
        start = self.mark()
        self.forward()
        self.tokens.append(_Token(KEY, start, self.mark()))

    def _fetch_value(self) -> None:
        key = self.possible.pop(self.flow_level, None)
        if key is not None:
            at = key.token_number - self.tokens_taken
            self.tokens.insert(at, _Token(KEY, key.mark, key.mark))
            if not self.flow_level and self._add_indent(key.column):
                self.tokens.insert(at, _Token(BLOCK_MAP, key.mark, key.mark))
            self.allow_simple_key = False
        else:
            if not self.flow_level:
                if not self.allow_simple_key:
                    raise YAMLError("mapping values are not allowed here", self.mark())
                if self._add_indent(self.col):
                    m = self.mark()
                    self.tokens.append(_Token(BLOCK_MAP, m, m))
            self.allow_simple_key = not self.flow_level
            self._remove_possible()
        start = self.mark()
        self.forward()
        self.tokens.append(_Token(VALUE_IND, start, self.mark()))

    def _fetch_property(self, scan) -> None:
        """An alias, anchor, tag, quoted or plain scalar: each may start a
        simple key."""
        self._save_possible()
        self.allow_simple_key = False
        self.tokens.append(scan())

    # -- scanners ------------------------------------------------------------

    def _skip_to_next_token(self) -> None:
        if self.ptr == 0 and self.peek() == "\ufeff":
            self.forward()
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in _END:
                    self.forward()
            if not self._line_break():
                return
            if not self.flow_level:
                self.allow_simple_key = True

    def _line_break(self) -> str:
        ch = self.peek()
        if ch in "\r\n\x85":
            self.forward(2 if self.prefix(2) == "\r\n" else 1)
            return "\n"
        if ch in "\u2028\u2029":
            self.forward()
            return ch
        return ""

    def _skip_spaces(self) -> None:
        while self.peek() == " ":
            self.forward()

    def _ignored_line(self, start: Mark, what: str) -> None:
        self._skip_spaces()
        if self.peek() == "#":
            while self.peek() not in _END:
                self.forward()
        if self.peek() not in _END:
            raise YAMLError(f"expected a comment or a line break, but found {self.peek()!r}",
                            self.mark(), f"while scanning a {what}", start)
        self._line_break()

    def _scan_directive(self) -> _Token:
        start = self.mark()
        self.forward()
        n = 0
        while self.peek(n) in _WORD:
            n += 1
        if not n or self.peek(n) not in "\0 \r\n\x85\u2028\u2029":
            self.forward(n)
            raise YAMLError("expected alphabetic or numeric character, but found "
                            f"{self.peek()!r}", self.mark(), "while scanning a directive", start)
        name = self.prefix(n)
        self.forward(n)
        value = None
        if name == "YAML":
            self._skip_spaces()
            major = self._directive_number(start)
            if self.peek() != ".":
                raise YAMLError(f"expected a digit or '.', but found {self.peek()!r}",
                                self.mark(), "while scanning a directive", start)
            self.forward()
            minor = self._directive_number(start)
            if self.peek() not in "\0 \r\n\x85\u2028\u2029":
                raise YAMLError(f"expected a digit or ' ', but found {self.peek()!r}",
                                self.mark(), "while scanning a directive", start)
            value = (major, minor)
        elif name == "TAG":
            self._skip_spaces()
            handle = self._scan_tag_handle("directive", start)
            if self.peek() != " ":
                raise YAMLError(f"expected ' ', but found {self.peek()!r}", self.mark(),
                                "while scanning a directive", start)
            self._skip_spaces()
            prefix = self._scan_tag_uri("directive", start)
            if self.peek() not in "\0 \r\n\x85\u2028\u2029":
                raise YAMLError(f"expected ' ', but found {self.peek()!r}", self.mark(),
                                "while scanning a directive", start)
            value = (handle, prefix)
        end = self.mark()
        if name not in ("YAML", "TAG"):
            while self.peek() not in _END:
                self.forward()
        self._ignored_line(start, "directive")
        return _Token(DIRECTIVE, start, end, value=(name, value))

    def _directive_number(self, start: Mark) -> int:
        if not "0" <= self.peek() <= "9":
            raise YAMLError(f"expected a digit, but found {self.peek()!r}", self.mark(),
                            "while scanning a directive", start)
        n = 0
        while "0" <= self.peek(n) <= "9":
            n += 1
        value = int(self.prefix(n))
        self.forward(n)
        return value

    def _scan_anchor(self) -> _Token:
        start = self.mark()
        kind, name = (ALIAS, "alias") if self.peek() == "*" else (ANCHOR, "anchor")
        self.forward()
        n = 0
        while self.peek(n) in _WORD:
            n += 1
        if not n or self.peek(n) not in "\0 \t\r\n\x85\u2028\u2029?:,]}%@`":
            self.forward(n)
            raise YAMLError(f"expected alphabetic or numeric character, but found "
                            f"{self.peek()!r}", self.mark(), f"while scanning an {name}", start)
        value = self.prefix(n)
        self.forward(n)
        return _Token(kind, start, self.mark(), value=value)

    def _scan_tag(self) -> _Token:
        start = self.mark()
        ch = self.peek(1)
        if ch == "<":
            handle = None
            self.forward(2)
            suffix = self._scan_tag_uri("tag", start)
            if self.peek() != ">":
                raise YAMLError(f"expected '>', but found {self.peek()!r}", self.mark(),
                                "while parsing a tag", start)
            self.forward()
        elif ch in _BLANK_END:
            handle, suffix = None, "!"
            self.forward()
        else:
            n, use_handle = 1, False
            while ch not in "\0 \r\n\x85\u2028\u2029":
                if ch == "!":
                    use_handle = True
                    break
                n += 1
                ch = self.peek(n)
            if use_handle:
                handle = self._scan_tag_handle("tag", start)
            else:
                handle = "!"
                self.forward()
            suffix = self._scan_tag_uri("tag", start)
        if self.peek() not in "\0 \r\n\x85\u2028\u2029":
            raise YAMLError(f"expected ' ', but found {self.peek()!r}", self.mark(),
                            "while scanning a tag", start)
        return _Token(TAG, start, self.mark(), value=(handle, suffix))

    def _scan_tag_handle(self, name: str, start: Mark) -> str:
        if self.peek() != "!":
            raise YAMLError(f"expected '!', but found {self.peek()!r}", self.mark(),
                            f"while scanning a {name}", start)
        n = 1
        if self.peek(n) != " ":
            while self.peek(n) in _WORD:
                n += 1
            if self.peek(n) != "!":
                self.forward(n)
                raise YAMLError(f"expected '!', but found {self.peek()!r}", self.mark(),
                                f"while scanning a {name}", start)
            n += 1
        value = self.prefix(n)
        self.forward(n)
        return value

    def _scan_tag_uri(self, name: str, start: Mark) -> str:
        chunks, n = [], 0
        while self.peek(n) in _URI:
            if self.peek(n) == "%":
                chunks.append(self.prefix(n))
                self.forward(n)
                n = 0
                chunks.append(self._scan_uri_escapes(name, start))
            else:
                n += 1
        if n:
            chunks.append(self.prefix(n))
            self.forward(n)
        if not chunks:
            raise YAMLError(f"expected URI, but found {self.peek()!r}", self.mark(),
                            f"while parsing a {name}", start)
        return "".join(chunks)

    def _scan_uri_escapes(self, name: str, start: Mark) -> str:
        codes = bytearray()
        mark = self.mark()
        while self.peek() == "%":
            self.forward()
            for k in range(2):
                if self.peek(k) not in _HEX:
                    raise YAMLError("expected URI escape sequence of 2 hexadecimal numbers, "
                                    f"but found {self.peek(k)!r}", self.mark(),
                                    f"while scanning a {name}", start)
            codes.append(int(self.prefix(2), 16))
            self.forward(2)
        try:
            return codes.decode("utf-8")
        except UnicodeDecodeError as exc:
            raise YAMLError(str(exc), mark, f"while scanning a {name}", start) from None

    def _scan_block_scalar(self, folded: bool) -> _Token:
        chunks: List[str] = []
        start = self.mark()
        self.forward()
        chomping, increment = self._block_scalar_indicators(start)
        self._ignored_line(start, "block scalar")
        min_indent = max(self.indent + 1, 1)
        if increment is None:
            breaks, max_indent, end = self._block_scalar_indentation()
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks, end = self._block_scalar_breaks(indent)
        line_break = ""
        while self.col == indent and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            n = 0
            while self.peek(n) not in _END:
                n += 1
            chunks.append(self.prefix(n))
            self.forward(n)
            line_break = self._line_break()
            breaks, end = self._block_scalar_breaks(indent)
            if self.col == indent and self.peek() != "\0":
                if (folded and line_break == "\n" and leading_non_space
                        and self.peek() not in " \t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return _Token(SCALAR, start, end, value="".join(chunks), style=">" if folded else "|")

    def _block_scalar_indicators(self, start: Mark):
        chomping = increment = None

        def read_increment():
            value = int(self.peek())
            if value == 0:
                raise YAMLError("expected indentation indicator in the range 1-9, but found 0",
                                self.mark(), "while scanning a block scalar", start)
            self.forward()
            return value

        ch = self.peek()
        if ch in "+-":
            chomping = ch == "+"
            self.forward()
            if self.peek() in "0123456789":
                increment = read_increment()
        elif ch in "0123456789":
            increment = read_increment()
            if self.peek() in "+-":
                chomping = self.peek() == "+"
                self.forward()
        if self.peek() not in "\0 \r\n\x85\u2028\u2029":
            raise YAMLError("expected chomping or indentation indicators, but found "
                            f"{self.peek()!r}", self.mark(), "while scanning a block scalar",
                            start)
        return chomping, increment

    def _block_scalar_indentation(self):
        chunks, max_indent, end = [], 0, self.mark()
        while self.peek() in " \r\n\x85\u2028\u2029":
            if self.peek() != " ":
                chunks.append(self._line_break())
                end = self.mark()
            else:
                self.forward()
                max_indent = max(max_indent, self.col)
        return chunks, max_indent, end

    def _block_scalar_breaks(self, indent: int):
        chunks, end = [], self.mark()
        while self.col < indent and self.peek() == " ":
            self.forward()
        while self.peek() in _BREAK:
            chunks.append(self._line_break())
            end = self.mark()
            while self.col < indent and self.peek() == " ":
                self.forward()
        return chunks, end

    def _scan_flow_scalar(self, double: bool) -> _Token:
        chunks: List[str] = []
        start = self.mark()
        quote = self.peek()
        self.forward()
        chunks.extend(self._flow_scalar_non_spaces(double, start))
        while self.peek() != quote:
            chunks.extend(self._flow_scalar_spaces(start))
            chunks.extend(self._flow_scalar_non_spaces(double, start))
        self.forward()
        return _Token(SCALAR, start, self.mark(), value="".join(chunks),
                      style='"' if double else "'")

    def _flow_scalar_non_spaces(self, double: bool, start: Mark) -> List[str]:
        chunks = []
        while True:
            n = 0
            while self.peek(n) not in "'\"\\\0 \t\r\n\x85\u2028\u2029":
                n += 1
            if n:
                chunks.append(self.prefix(n))
                self.forward(n)
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.forward()
            elif double and ch == "\\":
                self.forward()
                ch = self.peek()
                if ch in ESCAPES:
                    chunks.append(ESCAPES[ch])
                    self.forward()
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    self.forward()
                    for k in range(n):
                        if self.peek(k) not in _HEX:
                            raise YAMLError(
                                f"expected escape sequence of {n} hexadecimal numbers, but "
                                f"found {self.peek(k)!r}", self.mark(),
                                "while scanning a double-quoted scalar", start)
                    chunks.append(chr(int(self.prefix(n), 16)))
                    self.forward(n)
                elif ch in _BREAK:
                    self._line_break()
                    chunks.extend(self._flow_scalar_breaks(start))
                else:
                    raise YAMLError(f"found unknown escape character {ch!r}", self.mark(),
                                    "while scanning a double-quoted scalar", start)
            else:
                return chunks

    def _flow_scalar_spaces(self, start: Mark) -> List[str]:
        n = 0
        while self.peek(n) in " \t":
            n += 1
        whitespace = self.prefix(n)
        self.forward(n)
        ch = self.peek()
        if ch == "\0":
            raise YAMLError("found unexpected end of stream", self.mark(),
                            "while scanning a quoted scalar", start)
        if ch not in _BREAK:
            return [whitespace]
        line_break = self._line_break()
        breaks = self._flow_scalar_breaks(start)
        chunks = []
        if line_break != "\n":
            chunks.append(line_break)
        elif not breaks:
            chunks.append(" ")
        return chunks + breaks

    def _flow_scalar_breaks(self, start: Mark) -> List[str]:
        chunks = []
        while True:
            if self.prefix(3) in ("---", "...") and self.peek(3) in _BLANK_END:
                raise YAMLError("found unexpected document separator", self.mark(),
                                "while scanning a quoted scalar", start)
            while self.peek() in " \t":
                self.forward()
            if self.peek() not in _BREAK:
                return chunks
            chunks.append(self._line_break())

    def _scan_plain(self) -> _Token:
        chunks: List[str] = []
        start = end = self.mark()
        indent = self.indent + 1
        spaces: Optional[List[str]] = []
        stops = ",[]{}" if self.flow_level else ""
        while self.peek() != "#":
            n = 0
            while True:
                ch = self.peek(n)
                if (ch in _BLANK_END
                        or (ch == ":" and self.peek(n + 1) in _BLANK_END + stops)
                        or (self.flow_level and ch in ",?[]{}")):
                    break
                n += 1
            if n == 0:
                break
            self.allow_simple_key = False
            chunks.extend(spaces)
            chunks.append(self.prefix(n))
            self.forward(n)
            end = self.mark()
            spaces = self._plain_spaces()
            if (not spaces or self.peek() == "#"
                    or (not self.flow_level and self.col < indent)):
                break
        return _Token(SCALAR, start, end, value="".join(chunks), plain=True)

    def _plain_spaces(self) -> Optional[List[str]]:
        n = 0
        while self.peek(n) == " ":
            n += 1
        whitespace = self.prefix(n)
        self.forward(n)
        if self.peek() not in _BREAK:
            return [whitespace] if whitespace else []
        line_break = self._line_break()
        self.allow_simple_key = True
        if self.prefix(3) in ("---", "...") and self.peek(3) in _BLANK_END:
            return None
        breaks = []
        while self.peek() in " \r\n\x85\u2028\u2029":
            if self.peek() == " ":
                self.forward()
            else:
                breaks.append(self._line_break())
                if self.prefix(3) in ("---", "...") and self.peek(3) in _BLANK_END:
                    return None
        chunks = []
        if line_break != "\n":
            chunks.append(line_break)
        elif not breaks:
            chunks.append(" ")
        return chunks + breaks


# ---------------------------------------------------------------------------
# Parser and composer: tokens -> nodes (PyYAML's parser.py and composer.py)
# ---------------------------------------------------------------------------

DEFAULT_HANDLES = {"!": "!", "!!": TAG_PREFIX}


class _Node:
    __slots__ = ("kind", "tag", "value", "start")

    def __init__(self, kind: str, tag: str, value: Any, start: Mark):
        self.kind, self.tag, self.value, self.start = kind, tag, value, start


class _Parser(_Scanner):
    def __init__(self, text: str):
        super().__init__(text)
        self.anchors: Dict[str, _Node] = {}
        self.handles = dict(DEFAULT_HANDLES)

    def single_document(self) -> Optional[_Node]:
        self.get_token()  # stream start
        tok = self.peek_token()
        root = None
        if tok.id in (DIRECTIVE, DOC_START):
            self._directives()
            if not self.check(DOC_START):
                tok = self.peek_token()
                raise YAMLError(f"expected '<document start>', but found {tok.id!r}",
                                tok.start)
            self.get_token()
            root = (self._empty(self.peek_token().start)
                    if self.check(DIRECTIVE, DOC_START, DOC_END, STREAM_END)
                    else self._node(block=True))
        elif tok.id != STREAM_END:
            root = self._node(block=True)
        while self.check(DOC_END):
            self.get_token()
        tok = self.peek_token()
        if tok.id in (DIRECTIVE, DOC_START):
            raise YAMLError("but found another document", tok.start,
                            "expected a single document in the stream",
                            root.start if root else None)
        if tok.id != STREAM_END:
            raise YAMLError(f"expected '<document start>', but found {tok.id!r}", tok.start)
        return root

    def _directives(self) -> None:
        version = None
        tags: Dict[str, str] = {}
        while self.check(DIRECTIVE):
            tok = self.get_token()
            name, value = tok.value
            if name == "YAML":
                if version is not None:
                    raise YAMLError("found duplicate YAML directive", tok.start)
                if value[0] != 1:
                    raise YAMLError("found incompatible YAML document (version 1.* is "
                                    "required)", tok.start)
                version = value
            elif name == "TAG":
                handle, prefix = value
                if handle in tags:
                    raise YAMLError(f"duplicate tag handle {handle!r}", tok.start)
                tags[handle] = prefix
        self.handles = {**DEFAULT_HANDLES, **tags}

    @staticmethod
    def _empty(mark: Mark) -> _Node:
        return _Node("scalar", NULL, "", mark)

    def _node(self, block: bool, indentless: bool = False) -> _Node:
        tok = self.peek_token()
        if tok.id == ALIAS:
            self.get_token()
            if tok.value not in self.anchors:
                raise YAMLError(f"found undefined alias {tok.value!r}", tok.start)
            return self.anchors[tok.value]
        anchor = tag = start = tag_mark = None
        if tok.id == ANCHOR:
            self.get_token()
            start, anchor = tok.start, tok.value
            if self.check(TAG):
                t = self.get_token()
                tag_mark, tag = t.start, t.value
        elif tok.id == TAG:
            self.get_token()
            start = tag_mark = tok.start
            tag = tok.value
            if self.check(ANCHOR):
                anchor = self.get_token().value
        if tag is not None:
            handle, suffix = tag
            if handle is not None:
                if handle not in self.handles:
                    raise YAMLError(f"found undefined tag handle {handle!r}", tag_mark,
                                    "while parsing a node", start)
                tag = self.handles[handle] + suffix
            else:
                tag = suffix
        tok = self.peek_token()
        if start is None:
            start = tok.start
        if anchor is not None and anchor in self.anchors:
            raise YAMLError("second occurrence", start,
                            f"found duplicate anchor {anchor!r}; first occurrence",
                            self.anchors[anchor].start)
        implicit = tag is None or tag == "!"
        if tok.id == SCALAR:
            self.get_token()
            if (tok.plain and tag is None) or tag == "!":
                tag = resolve_plain(tok.value)
            elif tag is None:
                tag = STR
            return self._register(_Node("scalar", tag, tok.value, start), anchor)
        kind = {FLOW_SEQ: "seq", FLOW_MAP: "map"}.get(tok.id)
        if block and kind is None:
            kind = {BLOCK_SEQ: "seq", BLOCK_MAP: "map"}.get(tok.id)
        if indentless and tok.id == BLOCK_ENTRY:
            kind = "seq"
        if kind is not None:
            node = self._register(
                _Node(kind, (SEQ if kind == "seq" else MAP) if implicit else tag, None, start),
                anchor)
            if indentless and tok.id == BLOCK_ENTRY:
                node.value = self._indentless_sequence()
            else:
                node.value = {FLOW_SEQ: self._flow_sequence, FLOW_MAP: self._flow_mapping,
                              BLOCK_SEQ: self._block_sequence,
                              BLOCK_MAP: self._block_mapping}[tok.id]()
            return node
        if anchor is not None or tag is not None:
            # an empty scalar may carry a tag or an anchor
            return self._register(_Node("scalar", NULL if implicit else tag, "", start), anchor)
        raise YAMLError(f"expected the node content, but found {tok.id!r}", tok.start,
                        f"while parsing a {'block' if block else 'flow'} node", start)

    def _register(self, node: _Node, anchor: Optional[str]) -> _Node:
        if anchor is not None:
            self.anchors[anchor] = node
        return node

    def _entry(self, stops: Tuple[str, ...], mark: Mark, block: bool) -> _Node:
        """The node after an indicator, or an empty scalar when one of
        `stops` follows it."""
        if self.check(*stops):
            return self._empty(mark)
        return self._node(block=block, indentless=block)

    def _block_sequence(self) -> list:
        start = self.get_token().start
        items = []
        while True:
            if self.check(BLOCK_ENTRY):
                tok = self.get_token()
                if self.check(BLOCK_ENTRY, BLOCK_END):
                    items.append(self._empty(tok.end))
                else:
                    items.append(self._node(block=True))
            elif self.check(BLOCK_END):
                self.get_token()
                return items
            else:
                tok = self.peek_token()
                raise YAMLError(f"expected <block end>, but found {tok.id!r}", tok.start,
                                "while parsing a block collection", start)

    def _indentless_sequence(self) -> list:
        items = []
        while self.check(BLOCK_ENTRY):
            tok = self.get_token()
            if self.check(BLOCK_ENTRY, KEY, VALUE_IND, BLOCK_END):
                items.append(self._empty(tok.end))
            else:
                items.append(self._node(block=True))
        return items

    def _block_mapping(self) -> list:
        start = self.get_token().start
        pairs = []
        stops = (KEY, VALUE_IND, BLOCK_END)
        while True:
            if self.check(KEY):
                key = self._entry(stops, self.get_token().end, block=True)
                if self.check(VALUE_IND):
                    value = self._entry(stops, self.get_token().end, block=True)
                else:
                    value = self._empty(self.peek_token().start)
                pairs.append((key, value))
            elif self.check(BLOCK_END):
                self.get_token()
                return pairs
            else:
                tok = self.peek_token()
                raise YAMLError(f"expected <block end>, but found {tok.id!r}", tok.start,
                                "while parsing a block mapping", start)

    def _flow_pair(self, end: str) -> Tuple[_Node, _Node]:
        """``KEY flow_node? (VALUE flow_node?)?`` inside a flow collection."""
        key = self._entry((VALUE_IND, FLOW_ENTRY, end), self.get_token().end, block=False)
        if self.check(VALUE_IND):
            value = self._entry((FLOW_ENTRY, end), self.get_token().end, block=False)
        else:
            value = self._empty(self.peek_token().start)
        return key, value

    def _flow_collection(self, end: str, what: str, entry) -> list:
        start = self.get_token().start
        items = []
        first = True
        while not self.check(end):
            if not first:
                if not self.check(FLOW_ENTRY):
                    tok = self.peek_token()
                    raise YAMLError(f"expected ',' or '{end}', but got {tok.id!r}", tok.start,
                                    f"while parsing a flow {what}", start)
                self.get_token()
            first = False
            if not self.check(end):
                items.append(entry())
        self.get_token()
        return items

    def _flow_sequence(self) -> list:
        def entry():
            if self.check(KEY):
                mark = self.peek_token().start
                return _Node("map", MAP, [self._flow_pair(FLOW_SEQ_END)], mark)
            return self._node(block=False)

        return self._flow_collection(FLOW_SEQ_END, "sequence", entry)

    def _flow_mapping(self) -> list:
        def entry():
            if self.check(KEY):
                return self._flow_pair(FLOW_MAP_END)
            key = self._node(block=False)
            return key, self._empty(self.peek_token().start)

        return self._flow_collection(FLOW_MAP_END, "mapping", entry)


# ---------------------------------------------------------------------------
# Constructor: nodes -> Python values (PyYAML's SafeConstructor)
# ---------------------------------------------------------------------------

_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}


def _binary(text: str) -> bytes:
    try:
        return base64.decodebytes(text.encode("ascii"))
    except (UnicodeEncodeError, binascii.Error) as exc:
        raise ValueError(f"failed to decode base64 data: {exc}") from None


_SCALARS = {STR: str, NULL: lambda v: None, BOOL: lambda v: _BOOLS[v.lower()], INT: yaml_int,
            FLOAT: yaml_float, TIMESTAMP: yaml_timestamp, TAG_PREFIX + "binary": _binary}
_KIND_NAMES = {"scalar": "scalar", "seq": "sequence", "map": "mapping"}


class _Constructor:
    def __init__(self):
        # node -> value; a collection registers itself before its items, so
        # an alias inside it to itself gives the same object, as in PyYAML
        self.done: Dict[int, Any] = {}

    def construct(self, node: _Node) -> Any:
        key = id(node)
        if key in self.done:
            return self.done[key]
        tag = node.tag
        if tag in _SCALARS:
            self._expect(node, "scalar")
            try:
                value = self.done[key] = _SCALARS[tag](node.value)
            except (KeyError, ValueError, IndexError) as exc:
                raise YAMLError(f"cannot construct {tag!r} from {node.value!r} ({exc})",
                                node.start) from None
            return value
        if tag == SEQ:
            self._expect(node, "seq")
            out: Any = []
            self.done[key] = out
            out.extend(self.construct(n) for n in node.value)
            return out
        if tag == MAP:
            self._expect(node, "map")
            out = self.done[key] = {}
            for k, v in self._pairs(node):
                out[k] = v
            return out
        raise YAMLError(f"could not determine a constructor for the tag {tag!r}", node.start,
                        "while constructing a Python object")

    @staticmethod
    def _expect(node: _Node, kind: str) -> None:
        if node.kind != kind:
            raise YAMLError(f"expected a {_KIND_NAMES[kind]} node, but found "
                            f"{_KIND_NAMES[node.kind]}", node.start)

    def _pairs(self, node: _Node):
        self._flatten(node)
        for key_node, value_node in node.value:
            key = self.construct(key_node)
            if not isinstance(key, collections.abc.Hashable):
                raise YAMLError("found unhashable key", key_node.start,
                                "while constructing a mapping", node.start)
            yield key, self.construct(value_node)

    def _flatten(self, node: _Node) -> None:
        """Move ``<<`` merge keys' pairs in front of the mapping's own
        (``SafeConstructor.flatten_mapping``); a later pair wins."""
        merge: list = []
        index = 0
        while index < len(node.value):
            key_node, value_node = node.value[index]
            if key_node.tag == MERGE:
                del node.value[index]
                if value_node.kind == "map":
                    self._flatten(value_node)
                    merge.extend(value_node.value)
                elif value_node.kind == "seq":
                    subs = []
                    for sub in value_node.value:
                        if sub.kind != "map":
                            raise YAMLError("expected a mapping for merging, but found "
                                            f"{_KIND_NAMES[sub.kind]}", sub.start,
                                            "while constructing a mapping", node.start)
                        self._flatten(sub)
                        subs.append(sub.value)
                    for pairs in reversed(subs):
                        merge.extend(pairs)
                else:
                    raise YAMLError("expected a mapping or list of mappings for merging, but "
                                    f"found {_KIND_NAMES[value_node.kind]}", value_node.start,
                                    "while constructing a mapping", node.start)
            else:
                if key_node.tag == VALUE:
                    key_node.tag = STR
                index += 1
        if merge:
            node.value = merge + node.value


def safe_load(text: str) -> Any:
    """The value of the one YAML document in `text`, as ``yaml.safe_load``
    gives it (None for an empty stream). Raises ``YAMLError`` where
    ``yaml.safe_load`` raises."""
    root = _Parser(text).single_document()
    return None if root is None else _Constructor().construct(root)
