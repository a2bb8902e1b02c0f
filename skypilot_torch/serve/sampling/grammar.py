"""Structured decoding: grammar -> character DFA -> token masks — the
port's copy of ``skypilot_tpu/serve/sampling/grammar.py`` (numpy only;
the JAX package's ``__init__`` imports jax, so the port keeps its own).

Host-side half of the constrained-decode pipeline (docs/sampling.md):
a request's ``response_format`` (a JSON-schema subset or a regex) is
compiled ONCE — cached by grammar hash — into a character-level DFA
via Brzozowski derivatives; the per-request walker then advances one
DFA state per emitted token and produces, before every dispatch, the
bool mask of vocabulary tokens whose full character sequence keeps
the DFA alive. The device steps never see the grammar — only the
``[M, V]`` mask table + traced per-row indices they gather
(sample.gather_masks), so the step is grammar-agnostic.

Matching is FULL-match over the generated text (no anchors): a token
is allowed iff appending its characters can still extend to a string
in the grammar's language; EOS is allowed exactly when the text so
far is a complete match. Constrained output therefore always parses
under its grammar, and generation self-terminates when the grammar
admits no continuation (the mask collapses to {EOS}).

Supported ``response_format`` shapes::

    {"type": "regex", "pattern": "..."}     # subset: literals, (),
        # |, * + ? {m} {m,n}, ., [classes] incl. ranges/negation,
        # escapes \\d \\w \\s \\. etc.
    {"type": "json_schema", "schema": {...}}  # subset: object with
        # properties (emitted in declared order, all present),
        # array of items, string, integer, number, boolean, null,
        # enum, const — compiled to the canonical no-whitespace JSON
        # text and reused through the regex path.

The regex engine is exact for this constructor set: emptiness of a
derivative is syntactic (the smart constructors normalize the empty
language to NULL), so "state is dead" == "no completion exists".
"""
import functools
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class GrammarError(Exception):
    """Typed: unsupported/invalid response_format or grammar. The
    serve plane maps it to HTTP 400 naming the offending piece."""


# ---------------------------------------------------------------------
# Regex AST + Brzozowski derivatives
# ---------------------------------------------------------------------
# Nodes are immutable (hashable) tuples:
#   NULL                        — the empty language
#   EPS                         — {""}
#   ('ch', frozenset, negated)  — one char from (or outside) the set
#   ('cat', a, b)
#   ('alt', (n1, n2, ...))      — sorted, deduped
#   ('star', a)

NULL = ('null',)
EPS = ('eps',)


def _chars(chars: frozenset, negated: bool = False):
    if not negated and not chars:
        return NULL
    return ('ch', chars, negated)


def _cat(a, b):
    if a is NULL or b is NULL or a == NULL or b == NULL:
        return NULL
    if a == EPS:
        return b
    if b == EPS:
        return a
    return ('cat', a, b)


def _alt(nodes) -> tuple:
    flat = []
    for n in nodes:
        if n[0] == 'alt':
            flat.extend(n[1])
        elif n != NULL:
            flat.append(n)
    uniq = sorted(set(flat), key=repr)
    if not uniq:
        return NULL
    if len(uniq) == 1:
        return uniq[0]
    return ('alt', tuple(uniq))


def _star(a):
    if a == NULL or a == EPS:
        return EPS
    if a[0] == 'star':
        return a
    return ('star', a)


def _nullable(n) -> bool:
    kind = n[0]
    if kind == 'eps' or kind == 'star':
        return True
    if kind == 'null' or kind == 'ch':
        return False
    if kind == 'cat':
        return _nullable(n[1]) and _nullable(n[2])
    return any(_nullable(m) for m in n[1])  # alt


@functools.lru_cache(maxsize=200_000)
def _deriv(n, ch: str):
    """Brzozowski derivative: the language of suffixes after ``ch``."""
    kind = n[0]
    if kind in ('null', 'eps'):
        return NULL
    if kind == 'ch':
        return EPS if (ch in n[1]) != n[2] else NULL
    if kind == 'cat':
        first = _cat(_deriv(n[1], ch), n[2])
        if _nullable(n[1]):
            return _alt((first, _deriv(n[2], ch)))
        return first
    if kind == 'alt':
        return _alt(tuple(_deriv(m, ch) for m in n[1]))
    return _cat(_deriv(n[1], ch), n)  # star


# ---------------------------------------------------------------------
# Regex parser (subset; full-match semantics, no anchors)
# ---------------------------------------------------------------------

_ESC_CLASSES = {
    'd': frozenset('0123456789'),
    'w': frozenset('abcdefghijklmnopqrstuvwxyz'
                   'ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_'),
    's': frozenset(' \t\n\r\f\v'),
}
_ESC_CHARS = {'n': '\n', 't': '\t', 'r': '\r', 'f': '\f', 'v': '\v',
              '0': '\0'}
_MAX_REPEAT = 256


class _Parser:

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self._alternation()
        if self.i != len(self.p):
            raise GrammarError(
                f'regex: unexpected {self.p[self.i]!r} at '
                f'position {self.i}')
        return node

    def _alternation(self):
        branches = [self._concat()]
        while self._peek() == '|':
            self._take()
            branches.append(self._concat())
        return _alt(tuple(branches))

    def _concat(self):
        parts = [EPS]
        while self._peek() is not None and self._peek() not in '|)':
            parts.append(self._repeat())
        node = EPS
        for part in parts:
            node = _cat(node, part)
        return node

    def _repeat(self):
        node = self._atom()
        while True:
            ch = self._peek()
            if ch == '*':
                self._take()
                node = _star(node)
            elif ch == '+':
                self._take()
                node = _cat(node, _star(node))
            elif ch == '?':
                self._take()
                node = _alt((node, EPS))
            elif ch == '{':
                node = self._bounded(node)
            else:
                return node

    def _bounded(self, node):
        self._take()  # '{'
        spec = ''
        while self._peek() is not None and self._peek() != '}':
            spec += self._take()
        if self._peek() != '}':
            raise GrammarError('regex: unterminated {m,n}')
        self._take()
        try:
            if ',' in spec:
                lo_s, hi_s = spec.split(',', 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(spec)
        except ValueError:
            raise GrammarError(f'regex: bad repeat {{{spec}}}')
        if lo < 0 or (hi is not None and (hi < lo or
                                          hi > _MAX_REPEAT)) or \
                lo > _MAX_REPEAT:
            raise GrammarError(f'regex: repeat {{{spec}}} out of '
                               f'range (max {_MAX_REPEAT})')
        out = EPS
        for _ in range(lo):
            out = _cat(out, node)
        if hi is None:
            return _cat(out, _star(node))
        opt = _alt((node, EPS))
        for _ in range(hi - lo):
            out = _cat(out, opt)
        return out

    def _atom(self):
        ch = self._take()
        if ch == '(':
            node = self._alternation()
            if self._peek() != ')':
                raise GrammarError('regex: unbalanced (')
            self._take()
            return node
        if ch == '[':
            return self._char_class()
        if ch == '.':
            return _chars(frozenset('\n'), negated=True)
        if ch == '\\':
            return self._escape()
        if ch in '*+?{':
            raise GrammarError(f'regex: dangling {ch!r}')
        return _chars(frozenset(ch))

    def _hex_escape(self, ch: str) -> Optional[str]:
        """\\xHH / \\uXXXX -> the char, or None if ``ch`` is not a
        hex-escape introducer."""
        width = {'x': 2, 'u': 4}.get(ch)
        if width is None:
            return None
        hexs = self.p[self.i:self.i + width]
        if len(hexs) != width:
            raise GrammarError(f'regex: bad \\{ch} escape')
        try:
            code = int(hexs, 16)
        except ValueError:
            raise GrammarError(f'regex: bad \\{ch} escape')
        self.i += width
        return chr(code)

    def _escape(self):
        if self._peek() is None:
            raise GrammarError('regex: trailing backslash')
        ch = self._take()
        if ch in _ESC_CLASSES:
            return _chars(_ESC_CLASSES[ch])
        if ch.upper() in _ESC_CLASSES and ch.isalpha():
            return _chars(_ESC_CLASSES[ch.lower()], negated=True)
        hexed = self._hex_escape(ch)
        if hexed is not None:
            return _chars(frozenset(hexed))
        return _chars(frozenset(_ESC_CHARS.get(ch, ch)))

    def _class_atom(self):
        """One entry inside [...]: either a char-class set (\\d ...)
        or a single char (with escapes resolved)."""
        ch = self._take()
        if ch != '\\':
            return ch
        if self._peek() is None:
            raise GrammarError('regex: trailing backslash in [')
        nxt = self._take()
        if nxt in _ESC_CLASSES:
            return _ESC_CLASSES[nxt]
        hexed = self._hex_escape(nxt)
        if hexed is not None:
            return hexed
        return _ESC_CHARS.get(nxt, nxt)

    def _char_class(self):
        negated = False
        if self._peek() == '^':
            self._take()
            negated = True
        chars: set = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise GrammarError('regex: unterminated [')
            if ch == ']' and not first:
                self._take()
                return _chars(frozenset(chars), negated)
            first = False
            atom = self._class_atom()
            if isinstance(atom, frozenset):
                chars |= atom
                continue
            if self._peek() == '-' and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != ']':
                self._take()
                hi = self._class_atom()
                if isinstance(hi, frozenset) or ord(hi) < ord(atom):
                    raise GrammarError(
                        f'regex: bad range {atom}-{hi}')
                chars |= {chr(c) for c in range(ord(atom),
                                                ord(hi) + 1)}
            else:
                chars.add(atom)


# ---------------------------------------------------------------------
# JSON-schema subset -> canonical-text regex
# ---------------------------------------------------------------------

_REGEX_SPECIALS = set('\\.[]{}()*+?|^$')
# Canonical JSON string body: any char except ", \, and control
# chars; or a short escape; or \uXXXX.
_JSON_STRING = ('"([^"\\\\\\x00-\\x1f]|'
                '\\\\["\\\\/bfnrt]|'
                '\\\\u[0-9a-fA-F]{4})*"')
_JSON_INT = '-?(0|[1-9][0-9]*)'
_JSON_NUMBER = _JSON_INT + r'(\.[0-9]+)?([eE][+-]?[0-9]+)?'


def _lit(text: str) -> str:
    """Escape ``text`` into a literal-matching regex fragment."""
    return ''.join('\\' + c if c in _REGEX_SPECIALS else c
                   for c in text)


def schema_to_regex(schema: Dict[str, Any], depth: int = 0) -> str:
    """Compile a JSON-schema subset to a regex over the CANONICAL
    (no-whitespace, declared-property-order, every-property-present)
    JSON text. Raises GrammarError on unsupported constructs."""
    if depth > 32:
        raise GrammarError('json_schema: nesting deeper than 32')
    if not isinstance(schema, dict):
        raise GrammarError('json_schema: schema must be an object')
    if 'const' in schema:
        return _lit(json.dumps(schema['const'],
                               separators=(',', ':')))
    if 'enum' in schema:
        opts = schema['enum']
        if not isinstance(opts, list) or not opts:
            raise GrammarError('json_schema: enum must be a '
                               'non-empty list')
        return '(' + '|'.join(
            _lit(json.dumps(v, separators=(',', ':')))
            for v in opts) + ')'
    stype = schema.get('type')
    if stype == 'string':
        return _JSON_STRING
    if stype == 'integer':
        return _JSON_INT
    if stype == 'number':
        return _JSON_NUMBER
    if stype == 'boolean':
        return '(true|false)'
    if stype == 'null':
        return 'null'
    if stype == 'object':
        props = schema.get('properties') or {}
        if not isinstance(props, dict):
            raise GrammarError('json_schema: properties must be an '
                               'object')
        if not props:
            return r'\{\}'
        fields = ','.join(
            _lit(json.dumps(k)) + ':' +
            schema_to_regex(v, depth + 1)
            for k, v in props.items())
        return r'\{' + fields + r'\}'
    if stype == 'array':
        item = schema_to_regex(schema.get('items') or {},
                               depth + 1)
        lo = schema.get('minItems', 0)
        hi = schema.get('maxItems')
        if not isinstance(lo, int) or lo < 0 or (
                hi is not None and (not isinstance(hi, int) or
                                    hi < max(lo, 1))):
            raise GrammarError('json_schema: bad minItems/maxItems')
        if hi is None:
            body = f'({item}(,{item})*)'
            body += '?' if lo == 0 else ''
            if lo > 1:
                body = (f'({item}(,{item}){{{lo - 1},}})')
        else:
            if lo == 0:
                body = (f'({item}(,{item}){{0,{hi - 1}}})?')
            else:
                body = (f'({item}(,{item}){{{lo - 1},{hi - 1}}})')
        return r'\[' + body + r'\]'
    if stype is None and not schema:
        # items: {} — any scalar (nested any-JSON is not regular;
        # spell structure out in the schema instead).
        return (f'({_JSON_STRING}|{_JSON_NUMBER}|true|false|null)')
    raise GrammarError(
        f'json_schema: unsupported schema piece {schema!r}')


# ---------------------------------------------------------------------
# Compiled grammar: token-level walker over the char DFA
# ---------------------------------------------------------------------


def grammar_hash(response_format: Dict[str, Any]) -> str:
    """Stable compile-cache key for a response_format payload."""
    return hashlib.sha256(
        json.dumps(response_format, sort_keys=True,
                   separators=(',', ':')).encode()).hexdigest()


class CompiledGrammar:
    """A grammar compiled against one token vocabulary.

    States are regex AST nodes (hashable); ``advance`` walks a whole
    token's characters with (state, token) memoization, ``allowed``
    returns the cached bool [V] mask of tokens that keep the DFA
    alive from a state — the trie walk, amortized across every
    request sharing the grammar.
    """

    def __init__(self, root, vocab: List[Optional[str]],
                 eos_id: Optional[int]):
        self.root = root
        self.vocab = vocab
        self.eos_id = eos_id
        self._step: Dict[Tuple[Any, int], Any] = {}
        self._masks: Dict[Any, np.ndarray] = {}

    @property
    def start(self):
        return self.root

    def is_accepting(self, state) -> bool:
        return state is not None and _nullable(state)

    def advance(self, state, token_id: int):
        """State after emitting ``token_id``; None if the token is
        not viable from ``state`` (dead)."""
        if state is None:
            return None
        if token_id == self.eos_id:
            return state if _nullable(state) else None
        key = (state, token_id)
        hit = self._step.get(key, False)
        if hit is not False:
            return hit
        text = self.vocab[token_id] \
            if 0 <= token_id < len(self.vocab) else None
        nxt = state
        if not text:
            nxt = None  # empty/special tokens never constrained-legal
        else:
            for ch in text:
                nxt = _deriv(nxt, ch)
                if nxt == NULL:
                    nxt = None
                    break
        self._step[key] = nxt
        return nxt

    def allowed(self, state) -> np.ndarray:
        """Bool [V] mask of tokens viable from ``state``. EOS is
        allowed iff the text so far is a complete match; a dead/None
        state falls back to all-allowed (unconstrained) so the
        sampler never faces an empty support."""
        size = len(self.vocab)
        if state is None:
            return np.ones(size, dtype=bool)
        mask = self._masks.get(state)
        if mask is None:
            mask = np.zeros(size, dtype=bool)
            for tid in range(size):
                if self.advance(state, tid) is not None and \
                        tid != self.eos_id:
                    mask[tid] = True
            if self.eos_id is not None and 0 <= self.eos_id < size \
                    and _nullable(state):
                mask[self.eos_id] = True
            if not mask.any():
                # No viable token and not accepting: the generation
                # is wedged (e.g. the budget forced an early stop
                # upstream) — degrade to unconstrained rather than
                # sample from empty support.
                mask = np.ones(size, dtype=bool)
            self._masks[state] = mask
        return mask


_COMPILE_CACHE: Dict[Tuple[str, int, Optional[int]],
                     CompiledGrammar] = {}


def compile_grammar(response_format: Dict[str, Any],
                    vocab: List[Optional[str]],
                    eos_id: Optional[int]) -> CompiledGrammar:
    """response_format -> CompiledGrammar, cached by grammar hash
    (plus vocab identity + eos — one engine holds one vocab object
    for its lifetime, so repeat grammars compile exactly once)."""
    if not isinstance(response_format, dict):
        raise GrammarError('response_format must be an object')
    kind = response_format.get('type')
    key = (grammar_hash(response_format), id(vocab), eos_id)
    cached = _COMPILE_CACHE.get(key)
    if cached is not None:
        return cached
    if kind == 'regex':
        pattern = response_format.get('pattern')
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError(
                'response_format.pattern must be a non-empty string')
    elif kind == 'json_schema':
        pattern = schema_to_regex(response_format.get('schema'))
    else:
        raise GrammarError(
            "response_format.type must be 'regex' or 'json_schema': "
            f'{kind!r}')
    root = _Parser(pattern).parse()
    if root == NULL:
        raise GrammarError('grammar matches no strings')
    compiled = CompiledGrammar(root, vocab, eos_id)
    if len(_COMPILE_CACHE) > 256:
        _COMPILE_CACHE.clear()
    _COMPILE_CACHE[key] = compiled
    return compiled
