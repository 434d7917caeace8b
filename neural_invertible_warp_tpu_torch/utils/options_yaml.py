"""The YAML the option files, the CLI values and ``options.yaml`` use, read
and written without PyYAML (which the card's machine does not have).

``load(text)`` reads a document of block mappings (any indent, the option
files use 4 spaces), block sequences (``- x``, also at their key's own
indent as ``yaml.safe_dump`` writes them, and ``- key: value`` items),
flow sequences and flow mappings (``[null, 256]``, ``{}``), comments,
single- and double-quoted scalars and plain scalars, over several lines
where ``safe_dump`` folds a long string. ``load_scalar(text)`` reads one
CLI value (``--key=<text>``), a one-line document. Plain scalars resolve
by PyYAML's YAML 1.1 rules (``yaml/resolver.py``, ``yaml/constructor.py``):
``1e-3`` is a string (a float needs a dot), ``5.e-4`` a float, ``yes`` and
``off`` bools, ``~`` and the empty value None, ``010`` 8, ``0x10`` 16,
``1_000`` 1000, ``1:30`` 90, ``.inf`` a float, ``2024-01-01`` a date.
Anchors, aliases, tags, block scalars (``|``, ``>``), complex keys,
directives and multi-document streams are outside the subset: they raise
``ValueError`` naming the line, as does anything PyYAML would reject.
Duplicate keys keep the last value, as PyYAML does.

``dump(obj)`` writes nested dicts as block mappings with 4-space indents,
lists as flow sequences and scalars in a form that ``load`` and PyYAML
both read back to the same value and type.
"""

from __future__ import annotations

import datetime
import math
import re

# PyYAML's implicit resolvers for plain scalars (YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)

_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
# characters that may not start a plain scalar
_NOT_PLAIN_START = set("[]{},#&*!|>'\"%@`")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _int(value):
    value = value.replace("_", "")
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


def _float(value):
    value = value.replace("_", "").lower()
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


def _timestamp(value):
    m = _TIMESTAMP_PARTS.match(value)
    year, month, day = int(m.group("year")), int(m.group("month")), int(m.group("day"))
    if not m.group("hour"):
        return datetime.date(year, month, day)
    fraction = 0
    if m.group("fraction"):
        fraction = int(m.group("fraction")[:6].ljust(6, "0"))
    tzinfo = None
    if m.group("tz_sign"):
        delta = datetime.timedelta(hours=int(m.group("tz_hour")),
                                   minutes=int(m.group("tz_minute") or 0))
        tzinfo = datetime.timezone(-delta if m.group("tz_sign") == "-" else delta)
    elif m.group("tz"):
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m.group("hour")), int(m.group("minute")),
                             int(m.group("second")), fraction, tzinfo=tzinfo)


def resolve_plain(value):
    """A plain scalar's value by PyYAML's implicit resolvers."""
    if _NULL.match(value):
        return None
    if _BOOL.match(value):
        return _BOOL_VALUES[value.lower()]
    if _FLOAT.match(value):
        return _float(value)
    if _INT.match(value):
        return _int(value)
    if _TIMESTAMP.match(value):
        return _timestamp(value)
    if value in ("<<", "="):
        raise ValueError("{!r}: merge keys and value tags are outside the subset".format(value))
    return value


class _Parser:
    """A line-based reader of one YAML document in the subset."""

    def __init__(self, text):
        self.lines = [line.rstrip("\r") for line in text.split("\n")]
        self.i = 0
        self.virtual = None     # (line index, column, text): the rest of a "- " line

    def error(self, message, i=None):
        i = self.i if i is None else i
        line = self.lines[i] if i < len(self.lines) else ""
        return ValueError("YAML line {}: {} ({!r})".format(i + 1, message, line))

    # ------------------------------------------------------------ lines

    def raw(self, i):
        """(indent, text) of line i, the text without its indent."""
        if self.virtual is not None and self.virtual[0] == i:
            return self.virtual[1], self.virtual[2]
        line = self.lines[i]
        text = line.lstrip(" ")
        if text.startswith("\t") and text.strip():
            raise self.error("a tab in the indentation", i)
        return len(line) - len(text), text

    def peek(self):
        """(indent, text without comment) of the next line with content, or
        None at the end; blank and comment lines before it are skipped."""
        while self.i < len(self.lines):
            indent, text = self.raw(self.i)
            body = _strip_comment(text)
            if body:
                if indent == 0 and self.virtual is None and (
                        body.startswith("%") or body in ("---", "...")
                        or body.startswith("--- ")):
                    raise self.error("directives and document markers are outside the subset")
                return indent, body
            self.advance()
        return None

    def advance(self):
        if self.virtual is not None and self.virtual[0] == self.i:
            self.virtual = None
        self.i += 1

    # ------------------------------------------------------------ nodes

    def document(self):
        first = self.peek()
        value = None if first is None else self.node(first[0], -1)
        if self.peek() is not None:
            raise self.error("content after the document's root node")
        return value

    def node(self, indent, parent):
        """The node whose first line is the next one, at ``indent``; a
        scalar's continuation lines are those indented past ``parent``."""
        _, text = self.peek()
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _key_split(text) is not None:
            return self.mapping(indent)
        return self.inline(parent)

    def mapping(self, indent):
        out = {}
        while True:
            ln = self.peek()
            if ln is None or ln[0] < indent:
                return out
            if ln[0] > indent:
                raise self.error("indentation deeper than the mapping's")
            _, raw_text = self.raw(self.i)
            split = _key_split(raw_text)
            if split is None:
                raise self.error("expected a 'key: value' line")
            key_text, rest = split
            key = _key(key_text, self.error)
            if _strip_comment(rest):
                # the value on the key's line: cut the line to it
                self.virtual = (self.i, indent + len(raw_text) - len(rest), rest)
                value = self.inline(indent)
            else:
                self.advance()
                nxt = self.peek()
                if nxt is not None and nxt[0] > indent:
                    value = self.node(nxt[0], indent)
                elif nxt is not None and nxt[0] == indent and (
                        nxt[1] == "-" or nxt[1].startswith("- ")):
                    value = self.sequence(indent)
                else:
                    value = None
            try:
                out[key] = value
            except TypeError:
                raise self.error("an unhashable key") from None

    def sequence(self, indent):
        out = []
        while True:
            ln = self.peek()
            if ln is None or ln[0] < indent:
                return out
            if ln[0] > indent or not (ln[1] == "-" or ln[1].startswith("- ")):
                if ln[0] == indent:
                    return out      # the mapping that holds this sequence goes on
                raise self.error("expected a '- item' line")
            _, raw_text = self.raw(self.i)
            rest = raw_text[1:].lstrip(" ")
            if not _strip_comment(rest):
                self.advance()
                nxt = self.peek()
                out.append(self.node(nxt[0], indent) if nxt is not None and nxt[0] > indent
                           else None)
            else:
                column = indent + len(raw_text) - len(rest)
                self.virtual = (self.i, column, rest)
                out.append(self.node(column, indent))

    def inline(self, parent):
        """The scalar or flow node that starts the next line's text, with its
        continuation lines (indented past ``parent``)."""
        start = self.i
        _, text = self.raw(self.i)
        text = text.lstrip(" ")
        if text[0] in "[{":
            return self.flow(text, parent, start)
        if text[0] in "'\"":
            return self.quoted(text, parent, start)
        return self.plain(text, parent, start)

    def continuation(self, parent):
        """The raw text of the next line if it continues a scalar (indented
        past ``parent`` or blank), else None."""
        if self.i + 1 >= len(self.lines):
            return None
        line = self.lines[self.i + 1]
        if not line.strip():
            return ""
        indent = len(line) - len(line.lstrip(" "))
        return line.strip() if indent > parent else None

    def flow(self, text, parent, start):
        joined = _strip_comment(text)
        while True:
            try:
                value, pos = _Flow(joined).node(0)
                break
            except _Unclosed:
                more = self.continuation(parent)
                if more is None:
                    raise self.error("an unclosed flow collection", start) from None
                self.advance()
                joined += " " + _strip_comment(more)
            except ValueError as e:
                raise self.error(str(e), start) from None
        if _strip_comment(joined[pos:]):
            raise self.error("text after a flow collection", start)
        self.advance()
        return value

    def quoted(self, text, parent, start):
        quote, pieces, pos, line = text[0], [], 1, text
        while True:
            end = _quoted_end(line, pos, quote)
            if end is not None:
                pieces.append(line[pos:end])
                break
            pieces.append(line[pos:].rstrip(" \t"))
            blanks = 0
            while True:
                more = self.continuation(parent)
                if more is None:
                    raise self.error("an unclosed quoted scalar", start)
                self.advance()
                if more:
                    break
                blanks += 1
            pieces.append("\n" * blanks if blanks else " ")
            line, pos = more, 0
        rest = line[end + 1:]
        if _strip_comment(rest):
            raise self.error("text after a quoted scalar", start)
        self.advance()
        body = "".join(pieces)
        if quote == "'":
            return body.replace("''", "'")
        return _unescape(body, lambda m: self.error(m, start))

    def plain(self, text, parent, start):
        body = _strip_comment(text)
        commented = body != text.rstrip(" \t")
        _check_plain(body, lambda m: self.error(m, start))
        parts = [body]
        blanks = 0
        while not commented:
            more = self.continuation(parent)
            if more is None:
                break
            if not more:
                blanks += 1
                self.advance()
                continue
            if more.startswith("#"):
                break
            self.advance()
            line = _strip_comment(more)
            commented = line != more.rstrip(" \t")
            if line.startswith("- ") or line == "-" or _key_split(line) is not None:
                raise self.error("a block node inside a plain scalar")
            _check_plain(line, lambda m: self.error(m), continued=True)
            parts.append("\n" * blanks if blanks else " ")
            parts.append(line)
            blanks = 0
        self.advance()
        return resolve_plain("".join(parts))


class _Unclosed(Exception):
    pass


class _Flow:
    """A flow collection on one (joined) line: ``[a, b]``, ``{k: v}``."""

    def __init__(self, s):
        self.s = s

    def ws(self, pos):
        while pos < len(self.s) and self.s[pos] in " \t":
            pos += 1
        return pos

    def at(self, pos):
        if pos >= len(self.s):
            raise _Unclosed()
        return self.s[pos]

    def node(self, pos):
        pos = self.ws(pos)
        c = self.at(pos)
        if c == "[":
            return self.sequence(pos + 1)
        if c == "{":
            return self.mapping(pos + 1)
        return self.scalar(pos)

    def sequence(self, pos):
        out = []
        while True:
            pos = self.ws(pos)
            if self.at(pos) == "]":
                return out, pos + 1
            item, pos = self.node(pos)
            out.append(item)
            pos = self.ws(pos)
            c = self.at(pos)
            if c == ":":
                raise ValueError("a 'key: value' pair inside a flow sequence")
            if c == ",":
                pos += 1
            elif c != "]":
                raise ValueError("expected ',' or ']' in a flow sequence")

    def mapping(self, pos):
        out = {}
        while True:
            pos = self.ws(pos)
            if self.at(pos) == "}":
                return out, pos + 1
            if self.at(pos) in "[{":
                raise ValueError("a collection as a flow mapping's key")
            key, pos = self.scalar(pos)
            pos = self.ws(pos)
            value = None
            if self.at(pos) == ":":
                pos = self.ws(pos + 1)
                if self.at(pos) not in ",}":
                    value, pos = self.node(pos)
                    pos = self.ws(pos)
            try:
                out[key] = value
            except TypeError:
                raise ValueError("an unhashable key") from None
            c = self.at(pos)
            if c == ",":
                pos += 1
            elif c != "}":
                raise ValueError("expected ',' or '}' in a flow mapping")

    def scalar(self, pos):
        s = self.s
        c = self.at(pos)
        if c in "'\"":
            end = _quoted_end(s, pos + 1, c)
            if end is None:
                raise _Unclosed()
            body = s[pos + 1:end]
            value = body.replace("''", "'") if c == "'" else _unescape(body, ValueError)
            return value, end + 1
        end = pos
        while end < len(s):
            ch = s[end]
            if ch in ",[]{}?":
                break
            if ch == ":" and (end + 1 == len(s) or s[end + 1] in " \t,[]{}"):
                break
            if ch == "#" and s[end - 1] in " \t":
                break
            end += 1
        body = s[pos:end].rstrip(" \t")
        if not body:
            raise ValueError("an empty entry in a flow collection")
        _check_plain(body, ValueError, flow_next=s[pos + 1:pos + 2])
        return resolve_plain(body), end


def _quoted_end(s, pos, quote):
    """The index of the quote that closes a scalar whose body starts at
    ``pos``, or None if the line ends first."""
    while pos < len(s):
        c = s[pos]
        if quote == "'" and c == "'":
            if pos + 1 < len(s) and s[pos + 1] == "'":
                pos += 2
                continue
            return pos
        if quote == '"':
            if c == "\\":
                pos += 2
                continue
            if c == '"':
                return pos
        pos += 1
    return None


def _unescape(body, error):
    out, pos = [], 0
    while pos < len(body):
        c = body[pos]
        if c != "\\":
            out.append(c)
            pos += 1
            continue
        code = body[pos + 1:pos + 2]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            pos += 2
        elif code in _HEX_ESCAPES:
            n = _HEX_ESCAPES[code]
            digits = body[pos + 2:pos + 2 + n]
            if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                raise error("a bad escape in a double-quoted scalar")
            out.append(chr(int(digits, 16)))
            pos += 2 + n
        else:
            raise error("an escape outside the subset in a double-quoted scalar")
    return "".join(out)


def _strip_comment(text):
    """``text`` without its comment (a ``#`` at the start or after a blank,
    outside quotes) and trailing blanks."""
    quote, pos, last = None, 0, None    # last: the last non-blank character
    while pos < len(text):
        c = text[pos]
        prev = text[pos - 1] if pos else " "
        if quote is not None:
            if quote == "'" and c == "'":
                if text[pos + 1:pos + 2] == "'":
                    pos += 1
                else:
                    quote = None
            elif quote == '"' and c == "\\":
                pos += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (last is None or prev in "[{," or (
                prev in " \t" and last in ":-?[{,")):
            quote = c      # a quote opens a scalar only where a token starts
        elif c == "#" and prev in " \t":
            return text[:pos].rstrip(" \t")
        if c not in " \t":
            last = c
        pos += 1
    return text.rstrip(" \t")


def _key_split(text):
    """(key text, value text) of a ``key: value`` line, or None."""
    if not text or text[0] in "[{" or text.startswith("- ") or text == "-":
        return None
    if text[0] in "'\"":
        end = _quoted_end(text, 1, text[0])
        if end is None:
            return None
        after = text[end + 1:].lstrip(" ")
        if after == ":" or after.startswith(": "):
            return text[:end + 1], after[1:].lstrip(" ")
        return None
    pos = 0
    while True:
        pos = text.find(":", pos)
        if pos < 0:
            return None
        if "#" in text[:pos] and re.search(r"[ \t]#", text[:pos]):
            return None
        if pos + 1 == len(text) or text[pos + 1] in " \t":
            return text[:pos].rstrip(" "), text[pos + 1:].lstrip(" ")
        pos += 1


def _key(text, error):
    if text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else _unescape(body, error)
    if text.startswith("? ") or text == "?":
        raise error("complex keys are outside the subset")
    _check_plain(text, error)
    return resolve_plain(text)


def _check_plain(text, error, continued=False, flow_next=None):
    """Raise where ``text`` is no plain scalar. ``flow_next``: in a flow
    collection, the character after the first one, where a ',' or a closing
    bracket lets a lone '-' be the scalar '-', as in PyYAML."""
    if not continued:
        if text[0] in _NOT_PLAIN_START:
            raise error("{!r} cannot start a plain scalar in the subset".format(text[0]))
        if text == "-" and flow_next and flow_next not in " \t":
            return
        if text[0] in "-?:" and (len(text) == 1 or text[1] in " \t"):
            raise error("{!r} followed by a blank cannot start a scalar".format(text[0]))
    if re.search(r":[ \t]", text) or text.endswith(":"):
        raise error("': ' inside a plain scalar")


def load(text):
    """The value of the YAML document ``text`` (None if it is empty)."""
    return _Parser(text).document()


def load_scalar(text):
    """The value of one CLI option value, ``--key=<text>``, as
    ``yaml.safe_load(text)`` gives it."""
    if "\n" in text:
        raise ValueError("an option value must be one line: {!r}".format(text))
    return load(text)


# ------------------------------------------------------------------ dump

BEST_WIDTH = 80       # PyYAML's default line width
INDENT = 4            # as ``save_options_file`` asks ``safe_dump`` for


def _dump_float(x):
    """PyYAML's ``represent_float``."""
    if x != x:
        return ".nan"
    if x in (math.inf, -math.inf):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _analyze(s):
    """(allow_block_plain, allow_single_quoted, multiline) of a string, as
    PyYAML's ``Emitter.analyze_scalar`` decides them (without unicode)."""
    if not s:
        return True, True, False
    blank = "\0 \t\r\n\x85\u2028\u2029"
    breaks = "\n\x85\u2028\u2029"
    block_ind = s.startswith("---") or s.startswith("...")
    line_breaks = special = space_break = break_space = False
    prev_space = prev_break = False
    preceded = True
    followed = len(s) == 1 or s[1] in blank
    for i, ch in enumerate(s):
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed):
                block_ind = True
        elif (ch == ":" and followed) or (ch == "#" and preceded):
            block_ind = True
        if ch in breaks:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True
        if ch == " ":
            break_space = break_space or prev_break
            prev_space, prev_break = True, False
        elif ch in breaks:
            space_break = space_break or prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded = ch in blank
        followed = i + 2 >= len(s) or s[i + 2] in blank
    edge = s[0] in " " + breaks or s[-1] in " " + breaks
    plain = not (edge or break_space or space_break or special or line_breaks or block_ind)
    single = not (break_space or space_break or special)
    return plain, single, line_breaks


def _implicit_str(s):
    """Whether a plain ``s`` reads back as the string ``s``."""
    try:
        return resolve_plain(s) == s and isinstance(resolve_plain(s), str)
    except ValueError:
        return False


class _Emitter:
    """The block layout of ``yaml.safe_dump(obj, default_flow_style=False,
    indent=4)`` for dicts, lists and scalars: keys sorted, nested mappings 4
    deeper, sequences at their key's indent, empty collections in flow style,
    scalars plain where PyYAML writes them plain (folded at a space past
    column 80) and single-quoted otherwise; strings PyYAML would write
    double-quoted (line breaks, characters outside printable ASCII) are
    written double-quoted with escapes, not in PyYAML's bytes."""

    def __init__(self):
        self.out = []
        self.column = 0
        self.whitespace = True

    def write(self, text, whitespace=False):
        self.out.append(text)
        self.column += len(text)
        self.whitespace = whitespace

    def line(self, indent):
        """A new line at ``indent``, or pad the current one to it where only
        an indicator stands before it."""
        if self.out and (self.column > indent or not self.whitespace):
            self.out.append("\n")
            self.column = 0
        self.write(" " * (indent - self.column), whitespace=True)

    def scalar(self, x, indent, simple_key=False):
        if isinstance(x, str):
            self.string(x, indent, simple_key)
            return
        text = _dump_scalar(x)
        self.write(text if self.whitespace else " " + text)

    def string(self, s, indent, simple_key):
        plain, single, multiline = _analyze(s)
        split = not simple_key
        if _implicit_str(s) and plain and not (simple_key and (not s or multiline)):
            if not self.whitespace:
                self.write(" ")
            self.words(s, indent, split, quoted=False)
        elif single and not (simple_key and multiline) and not multiline:
            self.write("'" if self.whitespace else " '")
            self.words(s, indent, split, quoted=True)
            self.write("'")
        else:
            self.write(('"' if self.whitespace else ' "') + _escape(s) + '"')

    def words(self, s, indent, split, quoted):
        """PyYAML's ``write_plain`` / ``write_single_quoted`` of a string
        without line breaks: a single space past column 80 becomes a line
        break to ``indent``."""
        start, spaces = 0, False
        for end in range(len(s) + 1):
            ch = s[end] if end < len(s) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > BEST_WIDTH and split
                            and (not quoted or (start != 0 and end != len(s)))):
                        self.out.append("\n" + " " * indent)
                        self.column = indent
                    else:
                        self.write(s[start:end])
                    start = end
            elif ch is None or ch == " " or (quoted and ch == "'"):
                if start < end:
                    self.write(s[start:end])
                start = end
            if quoted and ch == "'":
                self.write("''")
                start = end + 1
            spaces = ch == " "

    def node(self, x, indent):
        """A value after ``key:`` or ``-`` at ``indent`` (the key's or the
        dash's column)."""
        if isinstance(x, dict) and x:
            self.mapping(x, indent + INDENT)
        elif isinstance(x, list) and x:
            self.sequence(x, indent + INDENT)
        else:
            self.flow(x, indent + INDENT)

    def mapping(self, d, indent):
        for key in sorted(d):
            self.line(indent)
            self.scalar(key, indent + INDENT, simple_key=True)
            self.write(":")
            value = d[key]
            if isinstance(value, list) and value:
                self.sequence(value, indent)          # at the key's own indent
            else:
                self.node(value, indent)

    def sequence(self, items, indent):
        for item in items:
            self.line(indent)
            self.write("-", whitespace=True)
            self.whitespace = False
            if isinstance(item, (dict, list)) and item:
                self.write(" " * (indent + INDENT - self.column), whitespace=True)
            self.node(item, indent)

    def flow(self, x, indent):
        if isinstance(x, (dict, list)):
            self.write(_dump_flow(x) if self.whitespace else " " + _dump_flow(x))
        else:
            self.scalar(x, indent)


def _escape(s):
    """The body of a double-quoted scalar, with PyYAML's escapes."""
    named = {v: k for k, v in _ESCAPES.items() if k not in "\t /"}
    return "".join(
        "\\" + named[c] if c in named else c if " " <= c <= "~" else
        "\\x{:02X}".format(ord(c)) if ord(c) < 256 else
        "\\u{:04X}".format(ord(c)) if ord(c) < 0x10000 else "\\U{:08X}".format(ord(c))
        for c in s)


def _dump_scalar(x):
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        return _dump_float(x)
    if isinstance(x, str):
        plain, single, multiline = _analyze(x)
        if _implicit_str(x) and plain and not any(c in x for c in ",?:[]{}"):
            return x
        if single and not multiline:
            return "'" + x.replace("'", "''") + "'"
        return '"' + _escape(x) + '"'
    if isinstance(x, datetime.datetime):
        return x.isoformat(" ")
    if isinstance(x, datetime.date):
        return x.isoformat()
    raise ValueError("cannot write a {} in the YAML subset".format(type(x).__name__))


def _dump_flow(x):
    """A collection in flow style (empty ones, as PyYAML writes them, and
    anything inside them)."""
    if isinstance(x, list):
        return "[" + ", ".join(_dump_flow(v) for v in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join("{}: {}".format(_dump_scalar(k), _dump_flow(v))
                               for k, v in sorted(x.items())) + "}"
    return _dump_scalar(x)


def dump(obj):
    """YAML text for ``obj`` (a dict of dicts, lists and scalars) that ``load``
    and PyYAML read back to ``obj``, laid out as ``yaml.safe_dump(obj,
    default_flow_style=False, indent=4)`` lays it out (``_Emitter``)."""
    if not isinstance(obj, dict) or not obj:
        return _dump_flow(obj) + "\n"
    emitter = _Emitter()
    emitter.mapping(obj, 0)
    return "".join(emitter.out) + "\n"
