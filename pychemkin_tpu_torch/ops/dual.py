"""Forward-mode dual numbers over tensors, for the flame Jacobian's twin.

A :class:`Dual` holds a value tensor and one tangent tensor of the same
shape; arithmetic, indexing and the ``torch`` functions the flame's
transport and convection terms use (through ``__torch_function__``)
propagate both. A plain tensor or Python number is a constant (no
tangent). The derivative rules at clips are ``jax.jacfwd``'s: max/min
take half the slope at a tie, ``where`` the chosen branch's slope.

PyTorch's own forward-mode AD gives the same columns (the tests hold the
two together), but every operation that mixes a dual tensor with a
constant pays a zero-tangent path, and the flame's stencil is hundreds of
such operations per Jacobian. On one thread of an Intel Xeon CPU the blocks
of a 16-point h2o2 flame state take 0.03 s through this class and 0.22 s
through ``torch.func.jacfwd`` of the residual; at 80 points, 0.09 s and
3.7 s.
"""

from __future__ import annotations

import torch


def _vt(x):
    if isinstance(x, Dual):
        return x.v, x.t
    return x, None


def _tan(x, like):
    """The tangent of x broadcast to ``like``'s shape (zeros for a
    constant)."""
    if isinstance(x, Dual):
        return x.t.expand(like.shape) if x.t.shape != like.shape else x.t
    return torch.zeros_like(like)


class Dual:
    """A value tensor ``v`` with one tangent tensor ``t``."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v = v
        self.t = t

    # -- tensor-like attributes ------------------------------------------
    @property
    def shape(self):
        return self.v.shape

    def new_tensor(self, x):
        return self.v.new_tensor(x)

    def __getitem__(self, idx):
        return Dual(self.v[idx], self.t[idx])

    def sum(self, dim=None, keepdim=False):
        if dim is None:
            return Dual(self.v.sum(), self.t.sum())
        return Dual(self.v.sum(dim, keepdim=keepdim),
                    self.t.sum(dim, keepdim=keepdim))

    def expand_as(self, other):
        return Dual(self.v.expand(other.shape), self.t.expand(other.shape))

    # -- comparisons act on the value -------------------------------------
    def __gt__(self, o):
        return self.v > _vt(o)[0]

    def __ge__(self, o):
        return self.v >= _vt(o)[0]

    def __lt__(self, o):
        return self.v < _vt(o)[0]

    def __le__(self, o):
        return self.v <= _vt(o)[0]

    # -- arithmetic --------------------------------------------------------
    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __add__(self, o):
        ov, ot = _vt(o)
        return Dual(self.v + ov, self.t if ot is None else self.t + ot)

    __radd__ = __add__

    def __sub__(self, o):
        ov, ot = _vt(o)
        return Dual(self.v - ov, self.t if ot is None else self.t - ot)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.t)

    def __mul__(self, o):
        ov, ot = _vt(o)
        t = self.t * ov
        if ot is not None:
            t = t + self.v * ot
        return Dual(self.v * ov, t)

    __rmul__ = __mul__

    def __truediv__(self, o):
        ov, ot = _vt(o)
        v = self.v / ov
        if ot is None:
            return Dual(v, self.t / ov)
        return Dual(v, (self.t - v * ot) / ov)

    def __rtruediv__(self, o):
        v = o / self.v
        return Dual(v, -v * self.t / self.v)

    def __pow__(self, p):
        if isinstance(p, Dual):
            raise TypeError("Dual ** Dual is not supported")
        return Dual(self.v ** p, self.t * (p * self.v ** (p - 1)))

    # -- torch functions ---------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        rule = _RULES.get(name)
        if rule is None:
            raise NotImplementedError(f"Dual: no rule for {name}")
        return rule(*args, **kwargs)


def _unary(f, df):
    def rule(x, *a, **k):
        v = f(x.v, *a, **k)
        return Dual(v, x.t * df(x.v, v))
    return rule


def _minimum(a, b):
    av, at = _vt(a)
    bv, bt = _vt(b)
    v = torch.minimum(av, bv)
    ga = torch.where(av < bv, 1.0, torch.where(av == bv, 0.5, 0.0)).to(v)
    t = torch.zeros_like(v)
    if at is not None:
        t = t + at * ga
    if bt is not None:
        t = t + bt * (1.0 - ga)
    return Dual(v, t)


def _maximum_rule(a, b):
    av, at = _vt(a)
    bv, bt = _vt(b)
    v = torch.maximum(av, bv)
    ga = torch.where(av > bv, 1.0, torch.where(av == bv, 0.5, 0.0)).to(v)
    t = torch.zeros_like(v)
    if at is not None:
        t = t + at * ga
    if bt is not None:
        t = t + bt * (1.0 - ga)
    return Dual(v, t)


def _clamp(x, min=None, max=None):
    v = torch.clamp(x.v, min=min, max=max)
    keep = torch.ones_like(v, dtype=torch.bool)
    if min is not None:
        keep = keep & (x.v >= min)
    if max is not None:
        keep = keep & (x.v <= max)
    return Dual(v, torch.where(keep, x.t, torch.zeros_like(x.t)))


def _where(cond, a, b):
    av, at = _vt(a)
    bv, bt = _vt(b)
    v = torch.where(cond, av, bv)
    return Dual(v, torch.where(cond, _tan(a, v), _tan(b, v)))


def _cat(tensors, dim=0):
    vs = [_vt(x)[0] for x in tensors]
    ts = [_tan(x, _vt(x)[0]) for x in tensors]
    return Dual(torch.cat(vs, dim=dim), torch.cat(ts, dim=dim))


def _stack(tensors, dim=0):
    vs = [_vt(x)[0] for x in tensors]
    ts = [_tan(x, _vt(x)[0]) for x in tensors]
    return Dual(torch.stack(vs, dim=dim), torch.stack(ts, dim=dim))


def _diagonal(x, offset=0, dim1=0, dim2=1):
    return Dual(torch.diagonal(x.v, offset, dim1, dim2),
                torch.diagonal(x.t, offset, dim1, dim2))


def _binary(op):
    def rule(a, b, *rest, **k):
        if isinstance(a, Dual):
            return getattr(a, op)(b)
        # a constant on the left of a Dual
        return getattr(b, {"__add__": "__radd__", "__sub__": "__rsub__",
                           "__mul__": "__rmul__",
                           "__truediv__": "__rtruediv__"}[op])(a)
    return rule


_RULES = {
    "exp": _unary(torch.exp, lambda x, v: v),
    "log": _unary(torch.log, lambda x, v: 1.0 / x),
    "sqrt": _unary(torch.sqrt, lambda x, v: 0.5 / v),
    "maximum": _maximum_rule,
    "minimum": _minimum,
    "clamp": _clamp,
    "where": _where,
    "cat": _cat,
    "stack": _stack,
    "diagonal": _diagonal,
    "full_like": lambda x, fill, **k: torch.full_like(_vt(x)[0], fill, **k),
    "zeros_like": lambda x, **k: torch.zeros_like(_vt(x)[0], **k),
    "ones_like": lambda x, **k: torch.ones_like(_vt(x)[0], **k),
    "__add__": _binary("__add__"), "add": _binary("__add__"),
    "__radd__": _binary("__add__"),
    "__sub__": _binary("__sub__"), "sub": _binary("__sub__"),
    "__rsub__": lambda a, b: _binary("__sub__")(b, a),
    "__mul__": _binary("__mul__"), "mul": _binary("__mul__"),
    "__rmul__": _binary("__mul__"),
    "__truediv__": _binary("__truediv__"), "div": _binary("__truediv__"),
    "__rtruediv__": lambda a, b: _binary("__truediv__")(b, a),
}
