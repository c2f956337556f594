"""The opcode table of the traced entries of the fused evaluation, PyTorch
counterpart of `tpu_bijectors/vectorize/fused_decomp.py`.

A traced entry (`fused_traced.py`) runs a leaf's linked density as a
straight-line tape of scalar operations: the loop kind `kTraced` of the
whole-model kernels interprets it on the card (`kernels/csrc/
traced_tape.cuh`), and `run_tape_plain` evaluates it in torch ops for a
CPU tensor and as the kernel's reference. Both follow the same rules:

- `OPS`: opcode name -> `Op` (its number in traced_tape.cuh's `Opcode`
  enum, arity, whether its result carries a tangent, its value and its
  tangent rule in torch ops, and the JAX primitives it stands for).
  Values are aten's, at the edge points too: softplus with beta 1 and
  threshold 20, sign(NaN) = 0, the NaN of maximum and minimum, logaddexp's
  equal infinities. Tangents are torch's forward-mode rules: the product
  rule of `mul`, `pow`'s guards at base 0 and exponent 0, `clamp`'s slope 1
  inside its closed bounds, `maximum`'s 1/2 at ties, `abs`'s slope 0 at 0,
  `where`'s tangent of the selected branch alone. An operand with no
  tangent (a constant, a comparison's result) contributes no term, so no
  0 * inf forms from it, as torch's zero tangents form none.
- `_OPS`: aten overload -> opcode name, for the elementwise aten ops a
  trace may hold; the scalarizer in fused_traced.py handles the views,
  concatenations and reductions (slice, cat, flip, cumsum, sum, all,
  logsumexp) by unrolling them into these opcodes.
- `_SAFE_PRIMS`: the opcodes a tape may hold. Their JAX names
  (`JAX_NAMES`) are a subset of the JAX package's
  `fused_traced._SAFE_PRIMS`, so the port admits no leaf that the JAX
  package declines for want of a lowering; `erf`, `lgamma` and `atan` of
  the state stay out (SkewNormal declines in both packages), and `cos`
  and `sin` are in, as in the JAX package's (VonMises and Cosine take
  traced entries in both).
- The policy for custom autograd rules (`no_custom_rules`): a trace
  through an autograd.Function keeps its forward and loses its backward,
  so a leaf whose density calls one (the port's kernel wrappers, the
  fused log-density itself, any other outside torch) declines.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable

import torch

from .fused_base import _Unsupported


@dataclass(frozen=True)
class Op:
    code: int
    arity: int
    tangent: bool  # whether the result carries a tangent
    value: Callable  # (x, y, z) -> value
    dual: Callable | None  # (x, y, z, r, tx, ty, tz) -> tangent; None: no tangent
    jax: tuple  # the JAX primitives it stands for
    dual_ops: int = 1  # scalar operations of its tangent rule (the budget)


def _t(*terms):
    """The sum of the present terms (None: an operand with no tangent)."""
    out = None
    for t in terms:
        if t is not None:
            out = t if out is None else out + t
    return out


def _f(cond, like):
    """A comparison's result as 0/1 in the value's dtype."""
    return cond.to(like.dtype)


def _nz(x):
    return x != 0


def _softplus_value(x, *_):
    return torch.nn.functional.softplus(x)


def _softplus_dual(x, y, z, r, tx, ty, tz):
    e = torch.exp(x)
    return torch.where(x > 20.0, tx, tx * e / (e + 1.0))


def _pow_dual(x, y, z, r, tx, ty, tz):
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    a = None if tx is None else torch.where(y == 0.0, zero, tx * (y * torch.pow(x, y - 1.0)))
    b = None if ty is None else ty * torch.where((x == 0.0) & (y >= 0.0), zero, r * torch.log(x))
    return _t(a, b)


def _max_value(x, y, *_):
    return torch.maximum(x, y)


def _min_value(x, y, *_):
    return torch.minimum(x, y)


def _tie_dual(w):
    """max / min: w of x's tangent, 1 - w of y's (w = 1/2 at ties)."""

    def dual(x, y, z, r, tx, ty, tz):
        ww = w(x, y)
        return _t(None if tx is None else ww * tx, None if ty is None else (1.0 - ww) * ty)

    return dual


def _where_dual(c, x, y, r, tc, tx, ty):
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where(_nz(c), zero if tx is None else tx, zero if ty is None else ty)


def _logaddexp_dual(x, y, z, r, tx, ty, tz):
    return _t(None if tx is None else tx / (1.0 + torch.exp(y - x)),
              None if ty is None else ty / (1.0 + torch.exp(x - y)))


def _clamp_min_dual(x, y, z, r, tx, ty, tz):
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return _t(None if tx is None else torch.where(x >= y, tx, zero),
              None if ty is None else torch.where(x < y, ty, zero))


def _clamp_max_dual(x, y, z, r, tx, ty, tz):
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return _t(None if tx is None else torch.where(x <= y, tx, zero),
              None if ty is None else torch.where(x > y, ty, zero))


def _clamp_dual(x, y, z, r, tx, ty, tz):
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where((x >= y) & (x <= z), tx, zero)


def _fin0(x, *_):
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


def _sign(x, *_):
    return torch.sign(x)


_LAE = ("max", "sub", "ne", "add", "abs", "neg", "exp", "log1p", "select_n")

OPS = {
    "add": Op(1, 2, True, lambda x, y, z: x + y,
              lambda x, y, z, r, tx, ty, tz: _t(tx, ty), ("add",)),
    "sub": Op(2, 2, True, lambda x, y, z: x - y,
              lambda x, y, z, r, tx, ty, tz: _t(tx, None if ty is None else -ty), ("sub",)),
    "mul": Op(3, 2, True, lambda x, y, z: x * y,
              lambda x, y, z, r, tx, ty, tz: _t(None if ty is None else ty * x,
                                                None if tx is None else tx * y),
              ("mul",), 3),
    "div": Op(4, 2, True, lambda x, y, z: x / y,
              lambda x, y, z, r, tx, ty, tz: (
                  (tx if ty is None else (-(ty * r) if tx is None else tx - ty * r)) / y),
              ("div",), 3),
    "neg": Op(5, 1, True, lambda x, y, z: -x,
              lambda x, y, z, r, tx, ty, tz: -tx, ("neg",)),
    "recip": Op(6, 1, True, lambda x, y, z: torch.reciprocal(x),
                lambda x, y, z, r, tx, ty, tz: -tx * (r * r), ("div",), 3),
    "exp": Op(7, 1, True, lambda x, y, z: torch.exp(x),
              lambda x, y, z, r, tx, ty, tz: tx * r, ("exp",)),
    "log": Op(8, 1, True, lambda x, y, z: torch.log(x),
              lambda x, y, z, r, tx, ty, tz: tx / x, ("log",)),
    "log1p": Op(9, 1, True, lambda x, y, z: torch.log1p(x),
                lambda x, y, z, r, tx, ty, tz: tx / (x + 1.0), ("log1p",), 2),
    "expm1": Op(10, 1, True, lambda x, y, z: torch.expm1(x),
                lambda x, y, z, r, tx, ty, tz: tx * (r + 1.0), ("expm1",), 2),
    "sqrt": Op(11, 1, True, lambda x, y, z: torch.sqrt(x),
               lambda x, y, z, r, tx, ty, tz: tx / (2.0 * r), ("sqrt",), 2),
    "rsqrt": Op(12, 1, True, lambda x, y, z: torch.rsqrt(x),
                lambda x, y, z, r, tx, ty, tz: -0.5 * tx * (r * r * r), ("rsqrt",), 4),
    "sigmoid": Op(13, 1, True, lambda x, y, z: torch.sigmoid(x),
                  lambda x, y, z, r, tx, ty, tz: tx * (1.0 - r) * r, ("logistic",), 3),
    "softplus": Op(14, 1, True, _softplus_value, _softplus_dual, _LAE, 5),
    "tanh": Op(15, 1, True, lambda x, y, z: torch.tanh(x),
               lambda x, y, z, r, tx, ty, tz: tx * (1.0 - r * r), ("tanh",), 3),
    "asinh": Op(16, 1, True, lambda x, y, z: torch.asinh(x),
                lambda x, y, z, r, tx, ty, tz: tx * torch.rsqrt(x * x + 1.0), ("asinh",), 4),
    "abs": Op(17, 1, True, lambda x, y, z: torch.abs(x),
              lambda x, y, z, r, tx, ty, tz: tx * torch.sgn(x), ("abs",), 2),
    "sign": Op(18, 1, True, _sign,
               lambda x, y, z, r, tx, ty, tz: torch.zeros_like(tx), ("sign",)),
    "pow": Op(19, 2, True, lambda x, y, z: torch.pow(x, y), _pow_dual, ("pow",), 8),
    "logaddexp": Op(20, 2, True, lambda x, y, z: torch.logaddexp(x, y), _logaddexp_dual,
                    _LAE, 8),
    "max": Op(21, 2, True, _max_value,
              _tie_dual(lambda x, y: torch.where(x == y, 0.5, (x > y).to(x.dtype))),
              ("max",), 4),
    "min": Op(22, 2, True, _min_value,
              _tie_dual(lambda x, y: torch.where(x == y, 0.5, (x < y).to(x.dtype))),
              ("min",), 4),
    "clamp_min": Op(23, 2, True, lambda x, y, z: torch.clamp_min(x, y), _clamp_min_dual,
                    ("max",), 2),
    "clamp_max": Op(24, 2, True, lambda x, y, z: torch.clamp_max(x, y), _clamp_max_dual,
                    ("min",), 2),
    "clamp": Op(25, 3, True, lambda x, y, z: torch.clamp(x, y, z), _clamp_dual,
                ("clamp",), 3),
    "where": Op(26, 3, True, lambda c, x, y: torch.where(_nz(c), x, y), _where_dual,
                ("select_n",)),
    "ge": Op(27, 2, False, lambda x, y, z: _f(x >= y, x), None, ("ge",)),
    "gt": Op(28, 2, False, lambda x, y, z: _f(x > y, x), None, ("gt",)),
    "le": Op(29, 2, False, lambda x, y, z: _f(x <= y, x), None, ("le",)),
    "lt": Op(30, 2, False, lambda x, y, z: _f(x < y, x), None, ("lt",)),
    "eq": Op(31, 2, False, lambda x, y, z: _f(x == y, x), None, ("eq",)),
    "ne": Op(32, 2, False, lambda x, y, z: _f(x != y, x), None, ("ne",)),
    "and": Op(33, 2, False, lambda x, y, z: _f(_nz(x) & _nz(y), x), None, ("and",)),
    "or": Op(34, 2, False, lambda x, y, z: _f(_nz(x) | _nz(y), x), None, ("or",)),
    "not": Op(35, 1, False, lambda x, y, z: _f(~_nz(x), x), None, ("not",)),
    "b2f": Op(36, 1, False, lambda x, y, z: _f(_nz(x), x), None, ("convert_element_type",)),
    # the pieces of logsumexp: its running max and the max with an infinity
    # set to 0 (aten's `logsumexp`), neither carrying a tangent
    "max_sg": Op(37, 2, False, _max_value, None, ("reduce_max", "stop_gradient")),
    "fin0": Op(38, 1, False, _fin0, None, ("is_finite", "select_n")),
    # VonMises' kappa cos(x - loc) and Cosine's log1p(cos(pi z)); torch's
    # forward-mode rules -sin(x) t and cos(x) t
    "cos": Op(39, 1, True, lambda x, y, z: torch.cos(x),
              lambda x, y, z, r, tx, ty, tz: -tx * torch.sin(x), ("cos",), 3),
    "sin": Op(40, 1, True, lambda x, y, z: torch.sin(x),
              lambda x, y, z, r, tx, ty, tz: tx * torch.cos(x), ("sin",), 2),
}

_SAFE_PRIMS = frozenset(OPS)
JAX_NAMES = {name: op.jax for name, op in OPS.items()}
BY_CODE = {op.code: name for name, op in OPS.items()}

_aten = torch.ops.aten
# the elementwise aten overloads a trace may hold -> opcode (the scalarizer
# reads their scalar arguments: alpha, softplus' beta and threshold, the
# rounding mode, a clamp's bounds)
_OPS = {
    _aten.add.Tensor: "add", _aten.add.Scalar: "add",
    _aten.sub.Tensor: "sub", _aten.sub.Scalar: "sub",
    _aten.rsub.Scalar: "sub", _aten.rsub.Tensor: "sub",
    _aten.mul.Tensor: "mul", _aten.mul.Scalar: "mul",
    _aten.div.Tensor: "div", _aten.div.Scalar: "div",
    _aten.neg.default: "neg", _aten.reciprocal.default: "recip",
    _aten.exp.default: "exp", _aten.log.default: "log", _aten.log1p.default: "log1p",
    _aten.expm1.default: "expm1", _aten.sqrt.default: "sqrt", _aten.rsqrt.default: "rsqrt",
    _aten.sigmoid.default: "sigmoid", _aten.softplus.default: "softplus",
    _aten.tanh.default: "tanh", _aten.asinh.default: "asinh", _aten.abs.default: "abs",
    _aten.cos.default: "cos", _aten.sin.default: "sin",
    _aten.sign.default: "sign", _aten.square.default: "mul",
    _aten.pow.Tensor_Tensor: "pow", _aten.pow.Tensor_Scalar: "pow", _aten.pow.Scalar: "pow",
    _aten.logaddexp.default: "logaddexp",
    _aten.maximum.default: "max", _aten.minimum.default: "min",
    _aten.clamp_min.default: "clamp_min", _aten.clamp_max.default: "clamp_max",
    _aten.clamp_min.Tensor: "clamp_min", _aten.clamp_max.Tensor: "clamp_max",
    _aten.clamp.default: "clamp",
    _aten.where.self: "where", _aten.where.ScalarOther: "where",
    _aten.where.ScalarSelf: "where", _aten.where.Scalar: "where",
    _aten.ge.Tensor: "ge", _aten.ge.Scalar: "ge", _aten.gt.Tensor: "gt", _aten.gt.Scalar: "gt",
    _aten.le.Tensor: "le", _aten.le.Scalar: "le", _aten.lt.Tensor: "lt", _aten.lt.Scalar: "lt",
    _aten.eq.Tensor: "eq", _aten.eq.Scalar: "eq", _aten.ne.Tensor: "ne", _aten.ne.Scalar: "ne",
    _aten.bitwise_and.Tensor: "and", _aten.logical_and.default: "and",
    _aten.bitwise_or.Tensor: "or", _aten.logical_or.default: "or",
    _aten.bitwise_not.default: "not", _aten.logical_not.default: "not",
}


def apply_op(name, x, y, z, tx, ty, tz):
    """(value, tangent or None) of one opcode on tensors; a None tangent is
    an operand that carries none."""
    op = OPS[name]
    r = op.value(x, y, z)
    if op.dual is None or all(t is None for t in (tx, ty, tz)[: op.arity]):
        return r, None
    return r, op.dual(x, y, z, r, tx, ty, tz)


# ---------------------------------------------------------------------------
# custom autograd rules
# ---------------------------------------------------------------------------

_PATCH_LOCK = threading.Lock()


@contextlib.contextmanager
def no_custom_rules():
    """While a leaf's density is traced: any autograd.Function it calls,
    other than torch's own, raises `_Unsupported` naming it (a trace would
    keep its forward and drop its rule). torch's own are the operators'
    autograd wrappers, which a trace records as one operator, outside
    `_OPS`, so they decline too."""
    fn = torch.autograd.Function
    orig = fn.__dict__["apply"]

    def apply(cls, *args, **kwargs):
        if not cls.__module__.startswith("torch."):
            raise _Unsupported(f"a custom autograd rule ({cls.__module__}.{cls.__name__})")
        return orig.__func__(cls, *args, **kwargs)

    with _PATCH_LOCK:
        fn.apply = classmethod(apply)
        try:
            yield
        finally:
            fn.apply = orig


# the largest residual a traced entry hoists (floats), as the JAX package
MAX_RESIDUAL = 16
# JAX's op budgets: the v-dependent part's operations for the value, and
# for the value with its tangent rules
VALUE_BUDGET, DERIV_BUDGET = 256, 512
# the kernel's per-thread slot array (traced_tape.cuh kMaxSlots) and the
# longest tape it takes
MAX_SLOTS, MAX_TAPE = 64, 4096
# the rank bound of every v-dependent value (vector entries: rank 1)
MAX_RANK = 1
