"""Restricted script engine — the Painless/lang-expression analog.

Copy of the reference's ``script/__init__.py``: one recursive-descent
parser over a Painless-shaped grammar and two interpreters over its AST.

- **scalar** (``_ScalarEval``, ``CompiledScript.execute``): tree-walking
  over Python values, used by scripted ``_update`` and bulk ``update``
  items (``ctx._source`` mutation, ``ctx.op``). A statement language
  (if / for-in / def / assignment / return) under an operation budget,
  with the reference's method whitelist.
- **vector** (``_VectorEval``, ``CompiledScript.score_vector``): the
  same AST over torch tensors on the segment's device, for
  ``script_score`` and ``function_score``'s script functions:
  ``doc['f'].value`` is a whole doc-values column and every operator an
  elementwise tensor op, so one evaluation scores every document of a
  segment. ``cosineSimilarity``, ``dotProduct`` and ``l2norm`` read the
  segment's ``dense_vector`` matrix.

The vector interpreter gives the reference's bits: its dtypes, its
XLA:CPU transcendentals and its summation order (see the section
above ``FieldColumn``). Missing values follow lang-expression:
``doc['f'].value`` of a doc without the field is 0, and
``doc['f'].empty`` / ``.size()`` let a script branch.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import EsException
from elasticsearch_tpu_torch.ops.xla_math import (libm_cosf, libm_sinf,
                                                  libm_tanf, x86_nan,
                                                  x86_nan_like, xla_expf,
                                                  xla_divf, xla_ftz,
                                                  xla_gemv, xla_log10f,
                                                  xla_logf, xla_mulf,
                                                  xla_powf, xla_row_sum)


class ScriptException(EsException):
    """Compile or runtime script failure (400, like the reference's
    ScriptException which carries script_stack context)."""
    status = 400


# ----------------------------------------------------------------------
# lexer
# ----------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
  | (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[LlFfDd]?)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|%=|\+\+|--|[-+*/%<>=!?:;,.(){}\[\]])
""", re.VERBOSE)

_KEYWORDS = {"if", "else", "for", "return", "def", "true", "false",
             "null", "in", "new"}


def _lex(src: str) -> List[Tuple[str, str, int]]:
    out: List[Tuple[str, str, int]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise ScriptException(
                f"unexpected character [{src[pos]!r}] at offset {pos}")
        kind = m.lastgroup or ""
        text = m.group()
        pos = m.end()
        if kind in ("ws", "comment"):
            continue
        if kind == "name" and text in _KEYWORDS:
            kind = text
        out.append((kind, text, m.start()))
    out.append(("eof", "", len(src)))
    return out


# ----------------------------------------------------------------------
# AST — plain tuples: (kind, *payload). Small, picklable, cheap.
# ----------------------------------------------------------------------
#   ("num", float|int) ("str", s) ("bool", b) ("null",)
#   ("var", name) ("attr", obj, name) ("index", obj, key)
#   ("call", obj_or_None, name, [args])
#   ("bin", op, l, r) ("un", op, e) ("ternary", c, a, b)
#   ("assign", target, op, value)  op in = += -= *= /= %=
#   ("if", cond, then_block, else_block|None)
#   ("forin", name, iterable, block)
#   ("def", name, value|None) ("return", expr|None) ("expr", e)
#   ("block", [stmts])


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str, int]], src: str):
        self.toks = tokens
        self.i = 0
        self.src = src

    # -- token helpers --
    def peek(self) -> Tuple[str, str, int]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str, int]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, text: str) -> bool:
        kind, tok, _ = self.toks[self.i]
        if tok == text and kind in ("op",) + tuple(_KEYWORDS):
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> None:
        if not self.accept(text):
            kind, tok, off = self.toks[self.i]
            raise ScriptException(
                f"expected [{text}] but found [{tok or kind}] at "
                f"offset {off}")

    # -- statements --
    def parse_program(self) -> tuple:
        stmts = []
        while self.peek()[0] != "eof":
            stmts.append(self.statement())
        return ("block", stmts)

    def statement(self) -> tuple:
        kind, tok, _ = self.peek()
        if kind == "if":
            return self.if_stmt()
        if kind == "for":
            return self.for_stmt()
        if kind == "return":
            self.next()
            if self.accept(";"):
                return ("return", None)
            e = self.expression()
            self.accept(";")
            return ("return", e)
        if kind == "def":
            self.next()
            nk, name, off = self.next()
            if nk != "name":
                raise ScriptException(
                    f"expected identifier after [def] at offset {off}")
            value = None
            if self.accept("="):
                value = self.expression()
            self.accept(";")
            return ("def", name, value)
        if tok == "{":
            return self.block()
        e = self.expression()
        # assignment?
        kind2, tok2, _ = self.peek()
        if tok2 in ("=", "+=", "-=", "*=", "/=", "%="):
            self.next()
            value = self.expression()
            self.accept(";")
            if e[0] not in ("var", "attr", "index"):
                raise ScriptException(
                    "left-hand side of assignment must be a variable, "
                    "field, or index expression")
            return ("assign", e, tok2, value)
        self.accept(";")
        return ("expr", e)

    def block(self) -> tuple:
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            if self.peek()[0] == "eof":
                raise ScriptException("unterminated block: missing [}]")
            stmts.append(self.statement())
        return ("block", stmts)

    def if_stmt(self) -> tuple:
        self.expect("if")
        self.expect("(")
        cond = self.expression()
        self.expect(")")
        then = self.statement()
        otherwise = None
        if self.accept("else"):
            otherwise = self.statement()
        return ("if", cond, then, otherwise)

    def for_stmt(self) -> tuple:
        """Painless-style bounded iteration: for (def x : expr) {...}
        (also accepts `for (x in expr)`); C-style for is rejected —
        unbounded loops don't belong in a restricted engine."""
        self.expect("for")
        self.expect("(")
        self.accept("def")
        nk, name, off = self.next()
        if nk != "name":
            raise ScriptException(
                f"expected loop variable at offset {off}")
        if not self.accept(":") and not self.accept("in"):
            raise ScriptException(
                "only for (x : iterable) loops are supported")
        it = self.expression()
        self.expect(")")
        body = self.statement()
        return ("forin", name, it, body)

    # -- expressions (precedence climbing) --
    def expression(self) -> tuple:
        return self.ternary()

    def ternary(self) -> tuple:
        cond = self.or_expr()
        if self.accept("?"):
            a = self.expression()
            self.expect(":")
            b = self.expression()
            return ("ternary", cond, a, b)
        return cond

    def _binop(self, sub, ops) -> tuple:
        left = sub()
        while True:
            _, tok, _ = self.peek()
            if tok in ops:
                self.next()
                left = ("bin", tok, left, sub())
            else:
                return left

    def or_expr(self):
        return self._binop(self.and_expr, ("||",))

    def and_expr(self):
        return self._binop(self.cmp_expr, ("&&",))

    def cmp_expr(self):
        return self._binop(self.add_expr,
                           ("==", "!=", "<", "<=", ">", ">="))

    def add_expr(self):
        return self._binop(self.mul_expr, ("+", "-"))

    def mul_expr(self):
        return self._binop(self.unary, ("*", "/", "%"))

    def unary(self) -> tuple:
        _, tok, _ = self.peek()
        if tok == "-":
            self.next()
            return ("un", "-", self.unary())
        if tok == "!":
            self.next()
            return ("un", "!", self.unary())
        if tok == "+":
            self.next()
            return self.unary()
        return self.postfix()

    def postfix(self) -> tuple:
        e = self.primary()
        while True:
            if self.accept("."):
                nk, name, off = self.next()
                if nk not in ("name",):
                    raise ScriptException(
                        f"expected member name at offset {off}")
                if self.accept("("):
                    args = self.arg_list()
                    e = ("call", e, name, args)
                else:
                    e = ("attr", e, name)
            elif self.accept("["):
                key = self.expression()
                self.expect("]")
                e = ("index", e, key)
            else:
                return e

    def arg_list(self) -> list:
        args = []
        if self.accept(")"):
            return args
        while True:
            args.append(self.expression())
            if self.accept(")"):
                return args
            self.expect(",")

    def primary(self) -> tuple:
        kind, tok, off = self.next()
        if kind == "num":
            text = tok.rstrip("LlFfDd")
            if ("." in text or "e" in text or "E" in text
                    or tok[-1] in "FfDd"):
                return ("num", float(text))
            return ("num", int(text))
        if kind == "str":
            body = tok[1:-1]
            body = re.sub(r"\\(.)",
                          lambda m: {"n": "\n", "t": "\t"}.get(
                              m.group(1), m.group(1)), body)
            return ("str", body)
        if kind == "true":
            return ("bool", True)
        if kind == "false":
            return ("bool", False)
        if kind == "null":
            return ("null",)
        if kind == "name":
            if self.peek()[1] == "(" and self.peek()[0] == "op":
                self.next()
                return ("call", None, tok, self.arg_list())
            return ("var", tok)
        if tok == "(":
            e = self.expression()
            self.expect(")")
            return e
        if kind == "new":
            raise ScriptException("object construction is not allowed")
        raise ScriptException(
            f"unexpected token [{tok or kind}] at offset {off}")


# ----------------------------------------------------------------------
# function tables
# ----------------------------------------------------------------------

# Math.* (Painless exposes java.lang.Math; lang-expression the same set
# as bare names). One table serves both spellings.
_SCALAR_FUNCS: Dict[str, Callable] = {
    "abs": abs, "ceil": math.ceil, "floor": math.floor,
    "exp": math.exp, "log": math.log, "log10": math.log10,
    "sqrt": math.sqrt, "pow": math.pow, "min": min, "max": max,
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "round": round, "signum": lambda x: (x > 0) - (x < 0),
    "ln": math.log,  # lang-expression alias
}

_OP_BUDGET = 100_000  # scalar interpreter op ceiling per execution


class _Returned(Exception):
    def __init__(self, value):
        self.value = value


# ----------------------------------------------------------------------
# scalar interpreter
# ----------------------------------------------------------------------

class _ScalarEval:
    def __init__(self, variables: Dict[str, Any]):
        self.vars = dict(variables)
        # context bindings (ctx, params, …) may be MUTATED but never
        # rebound — `ctx = 5` is an error, `ctx.x = 5` is the point
        self.protected = frozenset(variables)
        self.ops = 0

    def _tick(self):
        self.ops += 1
        if self.ops > _OP_BUDGET:
            raise ScriptException(
                "script exceeded the operation budget "
                f"[{_OP_BUDGET}] (runaway loop?)")

    def run(self, node) -> Any:
        try:
            self.stmt(node)
        except _Returned as r:
            return r.value
        return None

    def stmt(self, node) -> None:
        self._tick()
        kind = node[0]
        if kind == "block":
            for s in node[1]:
                self.stmt(s)
        elif kind == "expr":
            self.eval(node[1])
        elif kind == "if":
            if _truthy(self.eval(node[1])):
                self.stmt(node[2])
            elif node[3] is not None:
                self.stmt(node[3])
        elif kind == "forin":
            _, name, it_expr, body = node
            it = self.eval(it_expr)
            if isinstance(it, dict):
                it = list(it.keys())
            if not isinstance(it, (list, tuple, str)):
                raise ScriptException(
                    f"cannot iterate over [{type(it).__name__}]")
            for item in it:
                self._tick()
                self.vars[name] = item
                self.stmt(body)
        elif kind == "def":
            _, name, value = node
            self.vars[name] = self.eval(value) if value is not None \
                else None
        elif kind == "return":
            raise _Returned(
                self.eval(node[1]) if node[1] is not None else None)
        elif kind == "assign":
            self.assign(node[1], node[2], node[3])
        else:
            raise ScriptException(f"unsupported statement [{kind}]")

    def assign(self, target, op, value_expr) -> None:
        value = self.eval(value_expr)
        if op != "=":
            current = self.eval(target)
            value = _scalar_binop(op[:-1], current, value)
        kind = target[0]
        if kind == "var":
            name = target[1]
            if name in self.protected:
                raise ScriptException(
                    f"cannot reassign context variable [{name}]")
            self.vars[name] = value
        elif kind in ("attr", "index"):
            container = self.eval(target[1])
            key = target[2] if kind == "attr" else \
                self.eval(target[2])
            if isinstance(container, dict):
                container[key] = value
            elif isinstance(container, list):
                if not isinstance(key, int):
                    raise ScriptException("list index must be an integer")
                container[key] = value
            else:
                raise ScriptException(
                    f"cannot assign into [{type(container).__name__}]")

    def eval(self, node) -> Any:
        self._tick()
        kind = node[0]
        if kind == "num" or kind == "str" or kind == "bool":
            return node[1]
        if kind == "null":
            return None
        if kind == "var":
            name = node[1]
            if name == "Math":
                return _MATH_SENTINEL
            if name in self.vars:
                return self.vars[name]
            raise ScriptException(f"unknown variable [{name}]")
        if kind == "attr":
            return self._attr(self.eval(node[1]), node[2])
        if kind == "index":
            obj = self.eval(node[1])
            key = self.eval(node[2])
            if isinstance(obj, dict):
                return obj.get(key)
            if isinstance(obj, (list, str)):
                if not isinstance(key, int):
                    raise ScriptException("index must be an integer")
                try:
                    return obj[key]
                except IndexError:
                    raise ScriptException(
                        f"index [{key}] out of bounds") from None
            raise ScriptException(
                f"cannot index [{type(obj).__name__}]")
        if kind == "call":
            return self._call(node)
        if kind == "bin":
            op = node[1]
            if op == "&&":
                return _truthy(self.eval(node[2])) and \
                    _truthy(self.eval(node[3]))
            if op == "||":
                return _truthy(self.eval(node[2])) or \
                    _truthy(self.eval(node[3]))
            return _scalar_binop(op, self.eval(node[2]),
                                 self.eval(node[3]))
        if kind == "un":
            v = self.eval(node[2])
            if node[1] == "-":
                _require_num(v)
                return -v
            return not _truthy(v)
        if kind == "ternary":
            return self.eval(node[2]) if _truthy(self.eval(node[1])) \
                else self.eval(node[3])
        raise ScriptException(f"unsupported expression [{kind}]")

    def _attr(self, obj, name):
        if obj is _MATH_SENTINEL_DATA:
            raise ScriptException("Math has no fields")
        if isinstance(obj, dict):
            return obj.get(name)
        if name == "length" and isinstance(obj, (list, str)):
            return len(obj)
        raise ScriptException(
            f"unknown field [{name}] on [{type(obj).__name__}]")

    def _call(self, node):
        _, recv_expr, name, arg_exprs = node
        args = [self.eval(a) for a in arg_exprs]
        if recv_expr is None:
            fn = _SCALAR_FUNCS.get(name)
            if fn is None:
                raise ScriptException(f"unknown function [{name}]")
            try:
                return fn(*args)
            except (TypeError, ValueError, ArithmeticError) as e:
                raise ScriptException(f"[{name}] failed: {e}") from None
        recv = self.eval(recv_expr)
        if recv is _MATH_SENTINEL_DATA:
            fn = _SCALAR_FUNCS.get(name)
            if fn is None:
                raise ScriptException(f"unknown function [Math.{name}]")
            try:
                return fn(*args)
            except (TypeError, ValueError, ArithmeticError) as e:
                raise ScriptException(
                    f"[Math.{name}] failed: {e}") from None
        return _method(recv, name, args)


_MATH_SENTINEL_DATA = object()
_MATH_SENTINEL = _MATH_SENTINEL_DATA


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    if v is None:
        return False
    if isinstance(v, (int, float)):
        return v != 0
    raise ScriptException(
        f"condition must be boolean, got [{type(v).__name__}]")


def _require_num(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ScriptException(
            f"expected a number, got [{type(v).__name__}]")


def _scalar_binop(op, a, b):
    if op == "+":
        if isinstance(a, str) or isinstance(b, str):
            return _to_str(a) + _to_str(b)
        if isinstance(a, list) and isinstance(b, list):
            return a + b
        _require_num(a), _require_num(b)
        return a + b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op in ("<", "<=", ">", ">="):
        if isinstance(a, str) and isinstance(b, str):
            pass
        else:
            _require_num(a), _require_num(b)
        return {"<": a < b, "<=": a <= b,
                ">": a > b, ">=": a >= b}[op]
    _require_num(a), _require_num(b)
    try:
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b if isinstance(a, float) or isinstance(b, float) \
                else (a // b if a % b == 0 else a / b)
        if op == "%":
            return a % b
    except ZeroDivisionError:
        raise ScriptException("division by zero") from None
    raise ScriptException(f"unknown operator [{op}]")


def _to_str(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


_METHODS: Dict[Tuple[type, str], Callable] = {
    (str, "contains"): lambda s, x: x in s,
    (str, "startsWith"): lambda s, x: s.startswith(x),
    (str, "endsWith"): lambda s, x: s.endswith(x),
    (str, "indexOf"): lambda s, x: s.find(x),
    (str, "substring"): lambda s, a, b=None:
        s[a:] if b is None else s[a:b],
    (str, "toLowerCase"): lambda s: s.lower(),
    (str, "toUpperCase"): lambda s: s.upper(),
    (str, "trim"): lambda s: s.strip(),
    (str, "replace"): lambda s, a, b: s.replace(a, b),
    (str, "length"): lambda s: len(s),
    (str, "isEmpty"): lambda s: len(s) == 0,
    (str, "splitOnToken"): lambda s, t: s.split(t),
    (list, "contains"): lambda l, x: x in l,
    (list, "add"): lambda l, x: (l.append(x), True)[1],
    (list, "size"): lambda l: len(l),
    (list, "isEmpty"): lambda l: len(l) == 0,
    (list, "indexOf"): lambda l, x: l.index(x) if x in l else -1,
    (dict, "containsKey"): lambda d, k: k in d,
    (dict, "get"): lambda d, k, default=None: d.get(k, default),
    (dict, "put"): lambda d, k, v: d.__setitem__(k, v),
    (dict, "remove"): lambda d, k: d.pop(k, None),
    (dict, "keySet"): lambda d: list(d.keys()),
    (dict, "values"): lambda d: list(d.values()),
    (dict, "size"): lambda d: len(d),
    (dict, "isEmpty"): lambda d: len(d) == 0,
}


def _list_remove(l: list, x):
    """Painless List.remove(int) removes BY INDEX; remove(Object) by
    value. Mirror the index flavor for ints (the common script idiom)."""
    if isinstance(x, int) and not isinstance(x, bool):
        if 0 <= x < len(l):
            return l.pop(x)
        raise ScriptException(f"index [{x}] out of bounds")
    if x in l:
        l.remove(x)
        return True
    return False


_METHODS[(list, "remove")] = _list_remove


def _method(recv, name, args):
    for base in type(recv).__mro__:
        fn = _METHODS.get((base, name))
        if fn is not None:
            try:
                return fn(recv, *args)
            except ScriptException:
                raise
            except (TypeError, ValueError) as e:
                raise ScriptException(
                    f"[{name}] failed: {e}") from None
    raise ScriptException(
        f"unknown method [{name}] on [{type(recv).__name__}]")


# ----------------------------------------------------------------------
# vector interpreter (script_score)
# ----------------------------------------------------------------------
#
# The reference evaluates a score script as eager jnp ops under its x64
# mode, one XLA:CPU computation per op. The port reproduces each op's
# dtype and rounding with torch ops on the column's device:
#
# * a float32 tensor (`_score`, `doc['f'].value`) is strongly typed; a
#   Python scalar, and what jnp makes of Python scalars alone (a `where`
#   over two literals, `.size()`), is weakly typed (`_Weak`: float64 or
#   int64) and takes the float32 type of a strong operand, as jnp does;
#   a bool tensor in arithmetic counts as a weak int64;
# * float32 arithmetic flushes denormal operands and results to zero
#   (XLA:CPU runs with FTZ/DAZ) and gives a NaN the bits x86 gives it
#   (``x86_nan``: a card makes its own NaN); `%` is the floored
#   remainder;
# * `exp`, `log`/`ln`, `log10` and `pow` are XLA:CPU's (`ops/xla_math`),
#   `pow` with a Python int exponent is jnp's square-and-multiply;
#   `sqrt` is correctly rounded; `sin`, `cos` and `tan` are the C
#   library's float functions, which XLA:CPU calls;
# * `cosineSimilarity`, `dotProduct` and `l2norm` sum in XLA:CPU's
#   association (`xla_math.xla_gemv`, `xla_row_sum`).

class FieldColumn:
    """What `doc['field']` yields in vector mode: a doc-values column
    plus its presence mask, both device tensors."""

    __slots__ = ("values", "present")

    def __init__(self, values, present):
        self.values = values
        self.present = present


class _Weak:
    """A weakly typed array (float64 or int64): jnp's result of an op
    over Python scalars and other weak arrays only."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t


def _is_tensor(v) -> bool:
    return isinstance(v, (torch.Tensor, _Weak))


def _strong_f32(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dtype == torch.float32


def _weak_scalar(v, device) -> "_Weak":
    """A Python number as jnp holds it under x64: int64 or float64, on
    `device`."""
    return _Weak(torch.tensor(v, dtype=torch.int64 if isinstance(v, int)
                              else torch.float64, device=device))


def _weak_of(v):
    """A non-f32 operand as a weak value: a Python number stays one, a
    bool tensor becomes a weak int64."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bool:
            return _Weak(v.to(torch.int64))
        return _Weak(v)
    return v


def _f32_operand(v):
    """A float32 operand of xla_mulf / xla_divf: a Python number
    converted to float32 first, as torch and jnp convert a weak scalar,
    its subnormal read as a zero (DAZ)."""
    if isinstance(v, torch.Tensor):
        return v
    f = float(np.float32(v))
    return math.copysign(0.0, f) if abs(f) < 2.0 ** -126 else f


def _to_f32(v):
    """An operand in float32 arithmetic: tensors converted and flushed,
    Python numbers left for torch to convert, as jnp converts weak
    scalars."""
    if isinstance(v, _Weak):
        v = v.t
    if isinstance(v, torch.Tensor):
        return xla_ftz(v.to(torch.float32))
    return v


def _weak_pair(a, b, want_float: bool):
    """Two weak operands (at least one a tensor) in their common jnp
    dtype: float64 when either is a float or `want_float`, else int64."""
    def is_float(v):
        if isinstance(v, _Weak):
            return v.t.is_floating_point()
        return isinstance(v, float)
    dt = torch.float64 if (want_float or is_float(a) or is_float(b)) \
        else torch.int64
    ref = a.t if isinstance(a, _Weak) else b.t

    def conv(v):
        if isinstance(v, _Weak):
            return v.t.to(dt)
        return torch.tensor(v, dtype=dt, device=ref.device)
    return conv(a), conv(b)


def _floor_mod(a, b):
    """jnp's `%`: fmod, then the divisor's sign (a floored remainder)."""
    m = torch.fmod(a, b)
    adjust = (m != 0) & ((m < 0) != (b < 0))
    return torch.where(adjust, m + b, m)


_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}
_COMPARE = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
}


def _vec_binop(op: str, a, b):
    """One arithmetic or comparison op of two operands, at least one a
    tensor, in jnp's result dtype."""
    if _strong_f32(a) or _strong_f32(b):
        x, y = _to_f32(a), _to_f32(b)
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=torch.float32, device=y.device) \
                if op == "%" else x
        if op in _COMPARE:
            return _COMPARE[op](x, y)
        if op == "%":
            if not isinstance(y, torch.Tensor):
                y = torch.tensor(y, dtype=torch.float32, device=x.device)
            return xla_ftz(x86_nan(_floor_mod(x, y), x, y))
        if op == "*":
            return x86_nan(xla_mulf(_f32_operand(x), _f32_operand(y)), x, y)
        if op == "/":
            return x86_nan(xla_divf(_f32_operand(x), _f32_operand(y)), x, y)
        return xla_ftz(x86_nan(_ARITH[op](x, y), x, y))
    a, b = _weak_of(a), _weak_of(b)
    x, y = _weak_pair(a, b, want_float=op == "/")
    if op in _COMPARE:
        return _COMPARE[op](x, y)
    if op == "%":
        return _Weak(_floor_mod(x, y) if x.is_floating_point()
                     else torch.remainder(x, y))
    return _Weak(_ARITH[op](x, y))


def _f32_fn(name: str, x: torch.Tensor, *rest) -> torch.Tensor:
    """One function of the table on a float32 tensor, as XLA:CPU
    computes it."""
    x = xla_ftz(x)
    if name == "abs":
        return torch.abs(x)
    if name == "signum":
        one = torch.ones_like(x)
        return torch.where(x > 0, one, torch.where(x < 0, -one, x))
    if name in ("log", "ln"):
        return xla_logf(x)
    if name == "log10":
        return xla_log10f(x)
    if name == "sqrt":
        # correctly rounded, as XLA:CPU's sqrt instruction; a negative
        # operand gives the default NaN
        out = torch.sqrt(x.to(torch.float64)).to(torch.float32)
        out = torch.where(x < 0, x86_nan_like(out), out)
    else:
        out = {"ceil": torch.ceil, "floor": torch.floor,
               # half to even, as lax.round
               "round": torch.round, "exp": xla_expf, "sin": libm_sinf,
               "cos": libm_cosf, "tan": libm_tanf}[name](x)
    # a NaN operand comes out quieted, an invalid one as the default NaN
    return x86_nan(out, x)


_UNARY = ("abs", "ceil", "floor", "exp", "log", "ln", "log10", "sqrt",
          "sin", "cos", "tan", "round", "signum")


def _weak_fn(name: str, x, device):
    """A function of a weak value: jnp computes it in float64 (a float
    function of an int64 operand too, except abs/ceil/floor/round/sign,
    which keep the operand's type)."""
    t = x.t if isinstance(x, _Weak) else _weak_scalar(x, device).t
    if name in ("abs", "ceil", "floor", "round", "signum") \
            and not t.is_floating_point():
        if name == "abs":
            return _Weak(torch.abs(t))
        if name == "signum":
            return _Weak(torch.sign(t))
        return _Weak(t)
    t = t.to(torch.float64)
    fn = {"abs": torch.abs, "ceil": torch.ceil, "floor": torch.floor,
          "round": torch.round, "exp": torch.exp, "log": torch.log,
          "ln": torch.log, "log10": torch.log10, "sqrt": torch.sqrt,
          "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
          "signum": lambda v: torch.where(
              v > 0, torch.ones_like(v),
              torch.where(v < 0, -torch.ones_like(v), v))}[name]
    return _Weak(fn(t))


def _vec_unary(name: str, x, device):
    if _strong_f32(x):
        return _f32_fn(name, x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
        x = _Weak(x.to(torch.int64))
    return _weak_fn(name, x, device)


def _integer_pow(x, n: int):
    """lax.integer_pow: square-and-multiply over the exponent's bits, a
    reciprocal for a negative one (refused for an integer base, with
    jnp's TypeError)."""
    if n < 0 and not x.is_floating_point():
        shape = ",".join(str(d) for d in x.shape)
        raise TypeError(f"Integers cannot be raised to negative powers, "
                        f"got integer_pow(~int64[{shape}], {n})")
    if n == 0:
        return torch.ones_like(x)
    recip = n < 0
    n = abs(n)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else x86_nan(_pow_mul(acc, x), acc, x)
        n >>= 1
        if n > 0:
            x = x86_nan(_pow_mul(x, x), x)
    if not recip:
        return acc
    q = xla_divf(1.0, acc) if acc.dtype == torch.float32 else 1.0 / acc
    return xla_ftz(x86_nan(q, acc))


def _pow_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One product of integer_pow: float32 as XLA:CPU rounds and flushes
    it (``xla_mulf``), another dtype as before."""
    if a.dtype == torch.float32:
        return xla_mulf(a, b)
    return xla_ftz(a * b)


def _vec_pow(x, y, device):
    """jnp.power(x, y): a Python int exponent is integer_pow, anything
    else lax.pow (the C library's powf for float32)."""
    if isinstance(y, int) and not isinstance(y, bool):
        if _strong_f32(x):
            return _integer_pow(xla_ftz(x), y)
        # a Python number or a weak array: a weak array
        w = _weak_of(x)
        return _Weak(_integer_pow(
            w.t if isinstance(w, _Weak) else _weak_scalar(w, device).t, y))
    if _strong_f32(x) or _strong_f32(y):
        xt = _to_f32(x)
        yt = _to_f32(y)
        if not isinstance(xt, torch.Tensor):
            xt = torch.full_like(yt, xt)
        return xla_powf(xt, yt)
    x, y = _weak_of(x), _weak_of(y)
    if not _is_tensor(x):
        x = _weak_scalar(x, device)
    xt, yt = _weak_pair(x, y, want_float=True)
    return _Weak(torch.pow(xt, yt))


def _vec_minmax(name: str, a, b, device):
    pick = torch.minimum if name == "min" else torch.maximum
    if _strong_f32(a) or _strong_f32(b):
        x, y = _to_f32(a), _to_f32(b)
        ref = x if isinstance(x, torch.Tensor) else y
        if not isinstance(x, torch.Tensor):
            x = torch.full_like(ref, x)
        if not isinstance(y, torch.Tensor):
            y = torch.full_like(ref, y)
        # a NaN operand propagates as it is, the first one first
        return torch.where(torch.isnan(x), x,
                           torch.where(torch.isnan(y), y, pick(x, y)))
    a, b = _weak_of(a), _weak_of(b)
    if not _is_tensor(a):
        a = _weak_scalar(a, device)
    x, y = _weak_pair(a, b, want_float=False)
    return _Weak(pick(x, y))


class _VectorEval:
    """Expression-only evaluation producing one tensor per AST node.
    Statements other than a single trailing `return` are rejected —
    matching lang-expression, which is expression-only too."""

    def __init__(self, resolver: Callable[[str], FieldColumn],
                 variables: Dict[str, Any],
                 vec_resolver: Optional[Callable[[str], Any]] = None):
        self.resolver = resolver
        self.vec_resolver = vec_resolver
        self.vars = variables
        # the device of the columns (and of `_score`): weak scalars live
        # there too
        self.device = variables["_score"].device

    def eval(self, node):
        kind = node[0]
        if kind in ("num", "str", "bool"):
            return node[1]
        if kind == "null":
            return None
        if kind == "var":
            name = node[1]
            if name == "Math":
                return _MATH_SENTINEL
            if name == "doc":
                return _DOC_SENTINEL
            if name in self.vars:
                return self.vars[name]
            raise ScriptException(f"unknown variable [{name}]")
        if kind == "index":
            obj = self.eval(node[1])
            key = self.eval(node[2])
            if obj is _DOC_SENTINEL:
                if not isinstance(key, str):
                    raise ScriptException("doc[...] takes a field name")
                return self.resolver(key)
            if isinstance(obj, dict):
                return obj.get(key)
            raise ScriptException("only doc[...] and params[...] "
                                  "indexing are supported in scores")
        if kind == "attr":
            obj = self.eval(node[1])
            name = node[2]
            if isinstance(obj, FieldColumn):
                if name == "value":
                    return obj.values
                if name == "empty":
                    return ~obj.present
                raise ScriptException(
                    f"unknown doc-values field [{name}]")
            if isinstance(obj, dict):
                return obj.get(name)
            raise ScriptException(
                f"unknown field [{name}] in score context")
        if kind == "call":
            return self._call(node)
        if kind == "bin":
            op = node[1]
            a = self.eval(node[2])
            b = self.eval(node[3])
            return self._binop(op, a, b)
        if kind == "un":
            v = self.eval(node[2])
            if node[1] == "-":
                v = self._num(v)
                return _Weak(-v.t) if isinstance(v, _Weak) else -v
            b = self._bool(v)
            return (not b) if isinstance(b, bool) else ~b
        if kind == "ternary":
            c = self._bool(self.eval(node[1]))
            a = self._num(self.eval(node[2]))
            b = self._num(self.eval(node[3]))
            return _where(c, a, b, self.device)
        raise ScriptException(
            f"[{kind}] is not allowed in score scripts")

    def _num(self, v):
        if isinstance(v, bool):
            return float(v)
        if v is None:
            raise ScriptException("null in arithmetic context")
        return v

    def _bool(self, v):
        if isinstance(v, bool):
            return v
        if isinstance(v, _Weak):
            return v.t != 0
        if isinstance(v, torch.Tensor):
            return v if v.dtype == torch.bool else v != 0
        raise ScriptException("condition must be boolean")

    def _binop(self, op, a, b):
        if op == "&&":
            return self._bool(a) & self._bool(b)
        if op == "||":
            return self._bool(a) | self._bool(b)
        if op in ("==", "!="):
            if isinstance(a, str) or isinstance(b, str):
                eq = a == b
            else:
                a, b = self._num(a), self._num(b)
                eq = _vec_binop("==", a, b) \
                    if _is_tensor(a) or _is_tensor(b) else a == b
            if op == "==":
                return eq
            return ~eq if isinstance(eq, torch.Tensor) else not eq
        a, b = self._num(a), self._num(b)
        if op not in ("<", "<=", ">", ">=", "+", "-", "*", "/", "%"):
            raise ScriptException(f"unknown operator [{op}]")
        if _is_tensor(a) or _is_tensor(b):
            return _vec_binop(op, a, b)
        # Python numbers: Python's arithmetic, as in the reference
        return {"<": lambda: a < b, "<=": lambda: a <= b,
                ">": lambda: a > b, ">=": lambda: a >= b,
                "+": lambda: a + b, "-": lambda: a - b,
                "*": lambda: a * b, "/": lambda: a / b,
                "%": lambda: a % b}[op]()

    def _call(self, node):
        _, recv_expr, name, arg_exprs = node
        recv = None if recv_expr is None else self.eval(recv_expr)
        if isinstance(recv, FieldColumn):
            if name == "size":
                return _Weak(recv.present.to(torch.int64))
            raise ScriptException(
                f"unknown doc-values method [{name}]")
        if recv is not None and recv is not _MATH_SENTINEL:
            raise ScriptException(
                f"method calls on [{type(recv).__name__}] are not "
                "allowed in score scripts")
        if name in ("cosineSimilarity", "dotProduct", "l2norm"):
            return self._vector_similarity(name, arg_exprs)
        sig = _VECTOR_SIGNATURES.get(name)
        if sig is None:
            raise ScriptException(f"unknown function [{name}]")
        args = [self._num(self.eval(a)) for a in arg_exprs]
        try:
            sig(None, *args)   # the reference's arity errors, verbatim
            return self._apply(name, args)
        except TypeError as e:
            raise ScriptException(f"[{name}] failed: {e}") from None

    def _apply(self, name, args):
        if name in _UNARY:
            return _vec_unary(name, args[0], self.device)
        if name == "pow":
            return _vec_pow(args[0], args[1], self.device)
        if name in ("min", "max"):
            out = args[0]
            for x in args[1:]:
                out = _vec_minmax(name, out, x, self.device)
            return out
        if name == "saturation":
            x, p = args
            return self._binop("/", x, self._binop("+", x, p))
        # sigmoid(x, k, a) = x^a / (k^a + x^a)
        x, k, a = args
        xa = _vec_pow(x, a, self.device)
        return self._binop("/", xa, self._binop(
            "+", _vec_pow(k, a, self.device), xa))

    def _vector_similarity(self, name, arg_exprs):
        """cosineSimilarity(params.qv, 'field') / dotProduct / l2norm —
        the reference's score-script vector access (denseVector
        functions of DenseVectorFieldMapper), over the segment's
        [docs, dims] matrix."""
        if self.vec_resolver is None:
            raise ScriptException(
                f"[{name}] is only available in document score context")
        if len(arg_exprs) != 2:
            raise ScriptException(
                f"[{name}] takes (query_vector, field)")
        qv = self.eval(arg_exprs[0])
        if not isinstance(qv, list) or not all(
                isinstance(x, (int, float)) and not isinstance(x, bool)
                for x in qv):
            raise ScriptException(
                f"[{name}] first argument must be an array of numbers "
                f"(e.g. params.query_vector)")
        fexpr = arg_exprs[1]
        if fexpr[0] != "str":
            raise ScriptException(
                f"[{name}] second argument must be a field name string")
        mat = self.vec_resolver(fexpr[1])  # f32[docs, dims] (NaN = missing)
        q = torch.tensor(np.asarray(qv, dtype=np.float32),
                         device=mat.device)
        if mat.shape[1] != q.shape[0]:
            raise ScriptException(
                f"[{name}] query vector has length {q.shape[0]} but "
                f"field [{fexpr[1]}] has dims {mat.shape[1]}")
        safe = xla_ftz(torch.nan_to_num(mat))
        q = xla_ftz(q)
        if name == "l2norm":
            d = xla_ftz(safe - q[None, :])
            return torch.sqrt(xla_row_sum(xla_mulf(d, d))
                              .to(torch.float64)).to(torch.float32)
        dot = xla_gemv(safe, q)
        if name == "dotProduct":
            return dot
        norms = torch.sqrt(xla_row_sum(xla_mulf(safe, safe))
                           .to(torch.float64)).to(torch.float32)
        qn = torch.sqrt(xla_row_sum(xla_mulf(q, q))
                        .to(torch.float64)).to(torch.float32)
        return xla_divf(dot, torch.clamp(xla_mulf(norms, qn), min=1e-12))


def _where(c, a, b, device):
    """jnp.where(c, a, b) over a bool (Python or tensor) condition:
    float32 when either branch is, else a weak array."""
    if _strong_f32(a) or _strong_f32(b):
        x, y = _to_f32(a), _to_f32(b)
        ref = x if isinstance(x, torch.Tensor) else y
        if not isinstance(x, torch.Tensor):
            x = torch.full_like(ref, x)
        if not isinstance(y, torch.Tensor):
            y = torch.full_like(ref, y)
        if isinstance(c, bool):
            return x if c else y
        return torch.where(c, x, y)
    a, b = _weak_of(a), _weak_of(b)
    if not _is_tensor(a) and not _is_tensor(b):
        dt = torch.int64 if (isinstance(a, int) and isinstance(b, int)) \
            else torch.float64
        x = torch.tensor(a, dtype=dt, device=device)
        y = torch.tensor(b, dtype=dt, device=device)
    else:
        x, y = _weak_pair(a, b, want_float=False)
    if isinstance(c, bool):
        return _Weak(x if c else y)
    return _Weak(torch.where(c, x, y))


_DOC_SENTINEL = object()


def _at_least_two(_jnp, *xs):
    if len(xs) < 2:
        raise TypeError("needs at least 2 arguments")


#: the score functions with the reference's signatures (its table holds
#: lambdas of these parameters; a wrong argument count is its TypeError)
_VECTOR_SIGNATURES: Dict[str, Callable] = {
    "abs": lambda jnp, x: None,
    "ceil": lambda jnp, x: None,
    "floor": lambda jnp, x: None,
    "exp": lambda jnp, x: None,
    "log": lambda jnp, x: None,
    "ln": lambda jnp, x: None,
    "log10": lambda jnp, x: None,
    "sqrt": lambda jnp, x: None,
    "pow": lambda jnp, x, y: None,
    "min": _at_least_two,
    "max": _at_least_two,
    "sin": lambda jnp, x: None,
    "cos": lambda jnp, x: None,
    "tan": lambda jnp, x: None,
    "round": lambda jnp, x: None,
    "signum": lambda jnp, x: None,
    "saturation": lambda jnp, x, p: None,
    "sigmoid": lambda jnp, x, k, a: None,
}


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------

class CompiledScript:
    """One parsed script. `execute` runs the scalar interpreter;
    `score_vector` the vectorized one. Reference: ScriptService#compile
    caching compiled scripts per (lang, source)."""

    def __init__(self, source: str, params: Dict[str, Any],
                 lang: str):
        self.source = source
        self.params = params
        self.lang = lang
        try:
            self.ast = _Parser(_lex(source), source).parse_program()
        except ScriptException as e:
            raise ScriptException(
                f"compile error in script [{source[:80]}]: "
                f"{e.args[0] if e.args else e}") from None
        stmts = self.ast[1]
        self.is_expression = (
            len(stmts) == 1 and stmts[0][0] in ("expr", "return"))

    # -- scalar --
    def execute(self, variables: Dict[str, Any]) -> Any:
        """Run with the given context variables. Dicts passed here are
        mutated in place (that's the point for ctx scripts). Returns
        the `return` value, or the last expression's value for
        single-expression scripts."""
        vars_in = {"params": dict(self.params)}
        for k, v in variables.items():
            vars_in[k] = v
        ev = _ScalarEval(vars_in)
        if self.is_expression:
            node = self.ast[1][0]
            expr = node[1]
            if expr is None:
                return None
            return ev.eval(expr)
        return ev.run(self.ast)

    # -- vector --
    def score_vector(self, resolver: Callable[[str], FieldColumn],
                     score: torch.Tensor,
                     vec_resolver: Optional[Callable] = None
                     ) -> torch.Tensor:
        """Evaluate as one tensor program on `score`'s device: `_score`
        is the base score tensor, `doc['f']` resolves through `resolver`,
        dense_vector fields through `vec_resolver` (cosineSimilarity et
        al.). Returns the per-doc score tensor (float32)."""
        if not self.is_expression:
            raise ScriptException(
                "score scripts must be a single expression "
                "(lang-expression semantics); statements are only "
                "available in update/ingest contexts")
        node = self.ast[1][0]
        expr = node[1]
        if expr is None:
            raise ScriptException("score script returns nothing")
        ev = _VectorEval(resolver, {"_score": score,
                                    "params": dict(self.params)},
                         vec_resolver=vec_resolver)
        out = ev.eval(expr)
        if isinstance(out, (int, float)):
            return torch.full_like(score, float(out))
        if isinstance(out, _Weak):
            out = out.t
        if not isinstance(out, torch.Tensor):
            raise ScriptException(
                f"score script returned [{type(out).__name__}], not a "
                f"number")
        return torch.broadcast_to(out.to(torch.float32), score.shape)


_SUPPORTED_LANGS = ("painless", "expression")


def compile_script(spec: Any, *, default_source_key: str = "source"
                   ) -> CompiledScript:
    """Parse the REST script grammar: a bare string, or
    {"source": ..., "lang": ..., "params": {...}} (reference:
    Script#parse). Stored scripts ("id") are not supported."""
    if isinstance(spec, str):
        return CompiledScript(spec, {}, "painless")
    if not isinstance(spec, dict):
        raise ScriptException(
            "script must be a string or an object with [source]")
    if "id" in spec:
        raise ScriptException(
            "stored scripts are not supported; inline [source] only")
    source = spec.get(default_source_key, spec.get("inline"))
    if not isinstance(source, str):
        raise ScriptException("script requires a [source] string")
    lang = spec.get("lang", "painless")
    if lang not in _SUPPORTED_LANGS:
        raise ScriptException(
            f"unsupported script lang [{lang}]; this build implements "
            f"a restricted expression subset under {_SUPPORTED_LANGS}")
    params = spec.get("params") or {}
    if not isinstance(params, dict):
        raise ScriptException("[params] must be an object")
    return CompiledScript(source, params, lang)
