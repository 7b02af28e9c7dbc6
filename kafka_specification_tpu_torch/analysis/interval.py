"""Interval abstract interpretation of the port's batched action kernels.

The port's copy of ``kafka_specification_tpu/analysis/interval.py``, for
kernels of the port's shape: a kernel takes a dict of int64[B, *shape]
fields and returns ``(enabled[B, n], next dict of [B, n, *shape])`` for
every choice at once (``models/base.py``).  The proof runs the *shipped*
kernel code, with each field bound to an ``IVal``: an interval-valued
tensor-like object.  ``IVal`` implements the tensor methods the kernels
call (indexing, ``unsqueeze``, ``reshape``, ``expand``, ``gather``,
``clamp``, reductions along a dim, the operators) and handles
``__torch_function__``, so the ``torch.where``, ``torch.minimum``,
``torch.full_like``, ``torch.broadcast_to`` and mixed tensor/``IVal``
operators in the kernels dispatch to it.  No module global is rebound:
a kernel running on real tensors elsewhere in the process is untouched.
Anything outside the domain raises ``AnalysisUnsupported``, and the
caller records an honest skip, never a guessed hull.

Domain: non-relational intervals over Python ints (numpy ``object``
arrays), per element, so field shapes and broadcasting come for free and
a bitset bound can never overflow the analyzer.  Two refinements keep the
kernels precise enough to verify clean, as in the JAX package:

- **guard refinement, per element**: an element that is a direct read of
  a state field element carries its origin (field, (row, *index)); a
  comparison of it records a fact (field, key, "le"|"ge", bound) on that
  element of the boolean result, and only ``&`` of boolean operands
  propagates facts.  Each action runs twice: once at B = 1, where element
  (0, c) of ``enabled`` holds choice c's facts, then at B = n, where row c
  of the state is refined by choice c's facts and the result is read at
  (c, c).  Sound, because the engine commits a successor only where its
  guard held.  ``|``, ``~``, reductions and an undecided ``where`` drop
  facts (weaker, still sound).
- **per-element indices**: reads and writes at concrete indices are
  exact; a ``gather`` at an abstract index joins over the index hull,
  clipped to the axis.

Origins also decide what an action writes: a next-state element whose
origin is the same element of the state it was computed from is passed
through; any other element counts as written.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Optional

import numpy as np
import torch


class AnalysisUnsupported(Exception):
    """The kernel used a construct the abstract domain does not model.
    Callers skip the action (an INFO finding) rather than guess."""


_MinMax = namedtuple("_MinMax", ["values"])


def _obj(x) -> np.ndarray:
    """An object ndarray of Python ints (numpy's astype(object) turns
    int64 and bool elements into Python ints and bools)."""
    a = np.asarray(x)
    return a if a.dtype == object else a.astype(object)


def _idx(a: np.ndarray, key) -> np.ndarray:
    """a[key], kept an object ndarray when it selects one element (which
    may itself be a tuple: an origin or a fact list)."""
    r = a[key]
    if isinstance(r, np.ndarray):
        return r
    out = np.empty((), dtype=object)
    out[()] = r
    return out


def _empty(shape) -> np.ndarray:
    return np.empty(shape, dtype=object)


def _bview(a: Optional[np.ndarray], shape) -> Optional[np.ndarray]:
    return None if a is None else np.broadcast_to(a, shape)


def _cat_cons(a: Optional[np.ndarray], b: Optional[np.ndarray], shape):
    """Element-wise concatenation of fact tuples (None: no facts)."""
    if a is None and b is None:
        return None
    a, b = _bview(a, shape), _bview(b, shape)
    out = _empty(shape)
    for pos in np.ndindex(*shape):
        x = a[pos] if a is not None else None
        y = b[pos] if b is not None else None
        out[pos] = (x or ()) + (y or ())
    return out


def _shape_args(args) -> tuple:
    if len(args) == 1 and isinstance(args[0], (tuple, list, torch.Size)):
        return tuple(int(s) for s in args[0])
    return tuple(int(s) for s in args)


class IVal:
    """An interval-valued tensor: element-wise [lo, hi] (inclusive).

    - ``org``: None, or an object array of the same shape whose entries
      are None or (field, key): the element IS the state's field element
      `key` = (row, *index) (the values guard refinement may constrain).
    - ``cons``: None, or an object array of per-element fact tuples
      (field, key, "le"|"ge", bound), gathered from comparisons; they
      survive only ``&``.
    - ``deps``: the field names whose values flowed into this one.
    - ``is_bool``: the value is a torch bool tensor.
    """

    __slots__ = ("lo", "hi", "org", "cons", "deps", "is_bool")

    def __init__(self, lo, hi, org=None, cons=None, deps=frozenset(), is_bool=False):
        lo, hi = _obj(lo), _obj(hi)
        if lo.shape != hi.shape:
            lo, hi = (np.array(a) for a in np.broadcast_arrays(lo, hi))
        self.lo, self.hi = lo, hi
        self.org = org
        self.cons = cons
        self.deps = deps
        self.is_bool = bool(is_bool)

    # -- construction ------------------------------------------------------
    @classmethod
    def coerce(cls, v) -> "IVal":
        if isinstance(v, IVal):
            return v
        if isinstance(v, (bool, np.bool_)):
            return cls(int(v), int(v), is_bool=True)
        if isinstance(v, (int, np.integer)):
            return cls(int(v), int(v))
        if isinstance(v, torch.Tensor):
            if v.dtype.is_floating_point or v.dtype.is_complex:
                raise AnalysisUnsupported(f"{v.dtype} tensors")
            a = _obj(np.asarray(v.detach().cpu().tolist(), dtype=object).reshape(tuple(v.shape)))
            return cls(a, a.copy(), is_bool=v.dtype == torch.bool)
        if isinstance(v, (list, tuple, np.ndarray)):
            a = np.asarray(v)
            if a.dtype.kind == "f":
                raise AnalysisUnsupported("float values")
            a = _obj(a)
            return cls(a, a.copy(), is_bool=a.size > 0 and np.asarray(v).dtype == bool)
        raise AnalysisUnsupported(f"cannot abstract {type(v).__name__}")

    # -- torch dispatch ----------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        impl = _TORCH_FUNCS.get(name)
        if impl is not None:
            return impl(*args, **kwargs)
        op = _TENSOR_BINOPS.get(name)
        if op is not None and len(args) == 2 and not kwargs:
            return getattr(IVal.coerce(args[0]), op)(args[1])
        raise AnalysisUnsupported(f"torch.{name} is not modeled")

    # -- shape plumbing ----------------------------------------------------
    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.lo.shape)

    @property
    def ndim(self) -> int:
        return self.lo.ndim

    def dim(self) -> int:
        return self.lo.ndim

    @property
    def device(self):
        return torch.device("cpu")

    @property
    def dtype(self):
        return torch.bool if self.is_bool else torch.int64

    def _map(self, fn) -> "IVal":
        """Apply one pure layout function to every component."""
        return IVal(fn(self.lo), fn(self.hi),
                    org=None if self.org is None else fn(self.org),
                    cons=None if self.cons is None else fn(self.cons),
                    deps=self.deps, is_bool=self.is_bool)

    def unsqueeze(self, d: int) -> "IVal":
        d = d if d >= 0 else d + self.ndim + 1
        return self._map(lambda a: np.expand_dims(a, d))

    def reshape(self, *shape) -> "IVal":
        shape = _shape_args(shape)
        return self._map(lambda a: np.reshape(a, shape))

    view = reshape

    def flatten(self, start_dim: int = 0, end_dim: int = -1) -> "IVal":
        nd = self.ndim
        if nd == 0:
            return self.reshape(1)
        s, e = start_dim % nd, end_dim % nd
        sh = self.lo.shape
        new = sh[:s] + (int(np.prod(sh[s : e + 1], dtype=np.int64)),) + sh[e + 1 :]
        return self.reshape(new)

    def expand(self, *sizes) -> "IVal":
        sizes = _shape_args(sizes)
        lead = len(sizes) - self.ndim
        if lead < 0:
            raise AnalysisUnsupported("expand to fewer dims")
        shape = tuple(
            self.lo.shape[i - lead] if (s == -1 and i >= lead) else s
            for i, s in enumerate(sizes)
        )
        return self._map(lambda a: np.broadcast_to(a, shape))

    def transpose(self, d0: int, d1: int) -> "IVal":
        return self._map(lambda a: np.swapaxes(a, d0, d1))

    def to(self, *args, **kwargs) -> "IVal":
        dtype = kwargs.get("dtype")
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
        if dtype is None:
            return self  # a device move
        if dtype == torch.bool:
            if not self._is_boolish():
                t, f = _defi(self)
                return IVal(np.where(t, 1, 0).astype(object), np.where(f, 0, 1).astype(object),
                            deps=self.deps, is_bool=True)
            return IVal(self.lo, self.hi, deps=self.deps, is_bool=True)
        if dtype.is_floating_point:
            raise AnalysisUnsupported(f"cast to {dtype}")
        return IVal(self.lo, self.hi, org=self.org, deps=self.deps)

    def concrete_scalar(self) -> Optional[int]:
        if self.lo.size == 1 and self.lo.reshape(-1)[0] == self.hi.reshape(-1)[0]:
            return int(self.lo.reshape(-1)[0])
        return None

    def is_concrete(self) -> bool:
        return bool(np.all(self.lo == self.hi))

    def __bool__(self):
        c = self.concrete_scalar()
        if c is None:
            raise AnalysisUnsupported("data-dependent Python branch on an abstract value")
        return bool(c)

    def __repr__(self):
        if self.ndim == 0:
            return f"IVal[{self.lo.item()}, {self.hi.item()}]"
        return f"IVal(shape={tuple(self.lo.shape)})"

    # -- arithmetic --------------------------------------------------------
    def _deps(self, o) -> frozenset:
        return self.deps | o.deps

    def __add__(self, other):
        o = IVal.coerce(other)
        return IVal(self.lo + o.lo, self.hi + o.hi, deps=self._deps(o))

    __radd__ = __add__

    def __sub__(self, other):
        o = IVal.coerce(other)
        return IVal(self.lo - o.hi, self.hi - o.lo, deps=self._deps(o))

    def __rsub__(self, other):
        return IVal.coerce(other).__sub__(self)

    def _corners(self, o, op):
        cands = [op(self.lo, o.lo), op(self.lo, o.hi), op(self.hi, o.lo), op(self.hi, o.hi)]
        return IVal(np.minimum.reduce(np.broadcast_arrays(*cands)),
                    np.maximum.reduce(np.broadcast_arrays(*cands)), deps=self._deps(o))

    def __mul__(self, other):
        return self._corners(IVal.coerce(other), lambda a, b: a * b)

    __rmul__ = __mul__

    def __neg__(self):
        return IVal(-self.hi, -self.lo, deps=self.deps)

    def __floordiv__(self, other):
        o = IVal.coerce(other)
        if not bool(np.all(o.lo > 0)):
            raise AnalysisUnsupported("division by a non-positive interval")
        return self._corners(o, lambda a, b: a // b)

    def __mod__(self, other):
        o = IVal.coerce(other)
        n = o.concrete_scalar()
        if n is None or n <= 0:
            raise AnalysisUnsupported("modulo by a non-constant")
        same = (self.lo // n) == (self.hi // n)
        lo = np.where(same, self.lo % n, 0).astype(object)
        hi = np.where(same, self.hi % n, n - 1).astype(object)
        return IVal(lo, hi, deps=self._deps(o))

    def _shift(self, other, op):
        o = IVal.coerce(other)
        if bool(np.any(o.lo < 0)):
            raise AnalysisUnsupported("negative shift amount")
        if bool(np.any(o.hi > 1 << 20)):
            raise AnalysisUnsupported("shift amount too large to bound")
        return self._corners(o, op)

    def __lshift__(self, other):
        return self._shift(other, lambda a, b: a << b)

    def __rlshift__(self, other):
        return IVal.coerce(other).__lshift__(self)

    def __rshift__(self, other):
        return self._shift(other, lambda a, b: a >> b)

    def __rrshift__(self, other):
        return IVal.coerce(other).__rshift__(self)

    # -- bitwise -----------------------------------------------------------
    @staticmethod
    def _mask_hull(a_hi, b_hi):
        """All-ones hull >= a|b for non-negative operands, element-wise."""
        vb = np.frompyfunc(
            lambda x, y: (1 << max(int(max(x, 0)).bit_length(), int(max(y, 0)).bit_length())) - 1,
            2, 1,
        )
        return vb(a_hi, b_hi)

    def _is_boolish(self) -> bool:
        return bool(np.all(self.lo >= 0)) and bool(np.all(self.hi <= 1))

    def __and__(self, other):
        o = IVal.coerce(other)
        deps = self._deps(o)
        if self._is_boolish() and o._is_boolish():
            # guard conjunction: the one operator that keeps facts (if
            # a & b holds, both conjuncts held)
            shape = np.broadcast_shapes(self.lo.shape, o.lo.shape)
            return IVal(self.lo * o.lo, self.hi * o.hi, cons=_cat_cons(self.cons, o.cons, shape),
                        deps=deps, is_bool=self.is_bool and o.is_bool)
        a_nn, b_nn = bool(np.all(self.lo >= 0)), bool(np.all(o.lo >= 0))
        if a_nn and b_nn:
            return IVal(0 * self.lo * o.lo, np.minimum(self.hi + 0 * o.hi, o.hi + 0 * self.hi),
                        deps=deps)
        if b_nn:  # a & b with b >= 0 lies in [0, b.hi]
            return IVal(0 * self.lo * o.lo, o.hi + 0 * self.hi, deps=deps)
        if a_nn:
            return IVal(0 * self.lo * o.lo, self.hi + 0 * o.hi, deps=deps)
        m = self._mask_hull(np.maximum(np.abs(self.lo), np.abs(self.hi)),
                            np.maximum(np.abs(o.lo), np.abs(o.hi)))
        return IVal(-(m + 1), np.maximum(self.hi + 0 * o.hi, o.hi + 0 * self.hi), deps=deps)

    __rand__ = __and__

    def __or__(self, other):
        o = IVal.coerce(other)
        deps = self._deps(o)
        if self._is_boolish() and o._is_boolish():
            return IVal(np.maximum(self.lo + 0 * o.lo, o.lo + 0 * self.lo),
                        np.maximum(self.hi + 0 * o.hi, o.hi + 0 * self.hi),
                        deps=deps, is_bool=self.is_bool and o.is_bool)
        lo = np.minimum(self.lo + 0 * o.lo, o.lo + 0 * self.lo)
        # a | b < 0 iff either operand is < 0
        both_nn = (self.hi + 0 * o.hi >= 0) & (o.hi + 0 * self.hi >= 0)
        hi = np.where(both_nn, self._mask_hull(self.hi, o.hi), -1).astype(object)
        return IVal(lo, hi, deps=deps)

    __ror__ = __or__

    def __xor__(self, other):
        o = IVal.coerce(other)
        if self.is_bool and o.is_bool:
            return IVal(0 * self.lo * o.lo, 0 * self.lo * o.lo + 1, deps=self._deps(o), is_bool=True)
        m = self._mask_hull(np.maximum(np.abs(self.lo), np.abs(self.hi)),
                            np.maximum(np.abs(o.lo), np.abs(o.hi)))
        return IVal(-(m + 1), m, deps=self._deps(o))

    __rxor__ = __xor__

    def __invert__(self):
        if self.is_bool:  # logical not (facts describe the un-negated value)
            return IVal(1 - self.hi, 1 - self.lo, deps=self.deps, is_bool=True)
        return IVal(-self.hi - 1, -self.lo - 1, deps=self.deps)

    # -- comparisons -> abstract booleans in {0, 1} -----------------------
    def _cmp(self, other, defi_true, defi_false, facts):
        o = IVal.coerce(other)
        shape = np.broadcast_shapes(self.lo.shape, o.lo.shape)
        alo, ahi = np.broadcast_to(self.lo, shape), np.broadcast_to(self.hi, shape)
        blo, bhi = np.broadcast_to(o.lo, shape), np.broadcast_to(o.hi, shape)
        t = np.asarray(defi_true(alo, ahi, blo, bhi), dtype=bool)
        f = np.asarray(defi_false(alo, ahi, blo, bhi), dtype=bool)
        lo = np.where(t, 1, 0).astype(object)
        hi = np.where(f, 0, 1).astype(object)
        cons = None
        if facts and (self.org is not None or o.org is not None):
            aorg, borg = _bview(self.org, shape), _bview(o.org, shape)
            cons = _empty(shape)
            for pos in np.ndindex(*shape):
                got = []
                for side, kind, val in facts:
                    org = aorg if side == "a" else borg
                    src = None if org is None else org[pos]
                    if src is not None:
                        got.append((src[0], src[1], kind,
                                    int(val(alo[pos], ahi[pos], blo[pos], bhi[pos]))))
                cons[pos] = tuple(got)
        return IVal(lo, hi, cons=cons, deps=self._deps(o), is_bool=True)

    def __lt__(self, other):
        return self._cmp(other, lambda al, ah, bl, bh: ah < bl, lambda al, ah, bl, bh: al >= bh,
                         [("a", "le", lambda al, ah, bl, bh: bh - 1),
                          ("b", "ge", lambda al, ah, bl, bh: al + 1)])

    def __le__(self, other):
        return self._cmp(other, lambda al, ah, bl, bh: ah <= bl, lambda al, ah, bl, bh: al > bh,
                         [("a", "le", lambda al, ah, bl, bh: bh),
                          ("b", "ge", lambda al, ah, bl, bh: al)])

    def __gt__(self, other):
        return self._cmp(other, lambda al, ah, bl, bh: al > bh, lambda al, ah, bl, bh: ah <= bl,
                         [("a", "ge", lambda al, ah, bl, bh: bl + 1),
                          ("b", "le", lambda al, ah, bl, bh: ah - 1)])

    def __ge__(self, other):
        return self._cmp(other, lambda al, ah, bl, bh: al >= bh, lambda al, ah, bl, bh: ah < bl,
                         [("a", "ge", lambda al, ah, bl, bh: bl),
                          ("b", "le", lambda al, ah, bl, bh: ah)])

    def __eq__(self, other):  # noqa: D105 -- abstract, not identity
        return self._cmp(
            other,
            lambda al, ah, bl, bh: (al == ah) & (bl == bh) & (al == bl),
            lambda al, ah, bl, bh: (ah < bl) | (al > bh),
            [("a", "le", lambda al, ah, bl, bh: bh), ("a", "ge", lambda al, ah, bl, bh: bl),
             ("b", "le", lambda al, ah, bl, bh: ah), ("b", "ge", lambda al, ah, bl, bh: al)],
        )

    def __ne__(self, other):  # noqa: D105
        return self._cmp(other, lambda al, ah, bl, bh: (ah < bl) | (al > bh),
                         lambda al, ah, bl, bh: (al == ah) & (bl == bh) & (al == bl), [])

    __hash__ = None  # abstract == is not an equivalence

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        parts = []
        for part in idx:
            if isinstance(part, (IVal, torch.Tensor)):
                v = IVal.coerce(part)
                if v.is_bool:
                    raise AnalysisUnsupported("boolean mask indexing")
                if not v.is_concrete():
                    raise AnalysisUnsupported("indexing at an abstract index")
                part = v.lo.astype(np.int64)
                if part.ndim == 0:
                    part = int(part)
            elif isinstance(part, (bool, np.bool_)):
                raise AnalysisUnsupported("boolean indexing")
            parts.append(part)
        key = tuple(parts)
        return self._map(lambda a: _idx(a, key))

    def gather(self, dim: int, index) -> "IVal":
        """torch.gather: out[..i..] = self[..index[..i..]..] along `dim`;
        an abstract index joins over its hull, clipped to the axis."""
        ix = IVal.coerce(index)
        dim %= self.ndim
        shape = ix.lo.shape
        sl = tuple(slice(0, shape[d]) if d != dim else slice(None) for d in range(self.ndim))
        src = self._map(lambda a: a[sl])
        n = src.lo.shape[dim]
        deps = self.deps | ix.deps
        if ix.is_concrete():
            ii = ix.lo.astype(np.int64)
            if ii.size and (ii.min() < 0 or ii.max() >= n):
                raise AnalysisUnsupported("gather index out of range")

            def take(a):
                return None if a is None else np.take_along_axis(np.asarray(a), ii, dim)

            return IVal(take(src.lo), take(src.hi), org=take(src.org), cons=None, deps=deps,
                        is_bool=self.is_bool)
        lo, hi = _empty(shape), _empty(shape)
        for pos in np.ndindex(*shape):
            a = max(0, min(int(ix.lo[pos]), n - 1))
            b = max(0, min(int(ix.hi[pos]), n - 1))
            line = list(pos)
            line[dim] = slice(a, b + 1)
            lo[pos] = min(src.lo[tuple(line)])
            hi[pos] = max(src.hi[tuple(line)])
        return IVal(lo, hi, deps=deps, is_bool=self.is_bool)

    # -- elementwise clamps and reductions ---------------------------------
    def clamp(self, min=None, max=None) -> "IVal":  # noqa: A002 -- torch's names
        out = self
        if max is not None:
            out = _minimum(out, max)
        if min is not None:
            out = _maximum(out, min)
        return out

    def _reduce(self, dim, keepdim, fn_lo, fn_hi, is_bool):
        if dim is None:
            lo, hi = fn_lo(self.lo.reshape(-1), 0), fn_hi(self.hi.reshape(-1), 0)
        else:
            d = dim % self.ndim
            lo, hi = fn_lo(self.lo, d), fn_hi(self.hi, d)
            if keepdim:
                lo, hi = np.expand_dims(lo, d), np.expand_dims(hi, d)
        return IVal(lo, hi, deps=self.deps, is_bool=is_bool)

    def _truth(self, dim, keepdim, lo_fn, hi_fn) -> "IVal":
        t, f = _defi(self)
        if dim is None:
            lo, hi = lo_fn(t, None), ~hi_fn(f, None)
        else:
            d = dim % self.ndim
            lo, hi = lo_fn(t, d), ~hi_fn(f, d)
            if keepdim:
                lo, hi = np.expand_dims(lo, d), np.expand_dims(hi, d)
        return IVal(np.asarray(lo).astype(object), np.asarray(hi).astype(object),
                    deps=self.deps, is_bool=True)

    def all(self, dim=None, keepdim=False) -> "IVal":
        return self._truth(dim, keepdim, lambda a, d: np.all(a, axis=d),
                           lambda a, d: np.any(a, axis=d))

    def any(self, dim=None, keepdim=False) -> "IVal":
        return self._truth(dim, keepdim, lambda a, d: np.any(a, axis=d),
                           lambda a, d: np.all(a, axis=d))

    def min(self, dim=None, keepdim=False):
        out = self._reduce(dim, keepdim, lambda a, d: np.minimum.reduce(a, axis=d),
                           lambda a, d: np.minimum.reduce(a, axis=d), self.is_bool)
        return out if dim is None else _MinMax(out)

    def max(self, dim=None, keepdim=False):
        out = self._reduce(dim, keepdim, lambda a, d: np.maximum.reduce(a, axis=d),
                           lambda a, d: np.maximum.reduce(a, axis=d), self.is_bool)
        return out if dim is None else _MinMax(out)

def _defi(x: IVal):
    """(definitely true, definitely false) element masks under torch's
    truthiness: nonzero is true."""
    return (np.asarray((x.lo >= 1) | (x.hi <= -1), dtype=bool),
            np.asarray((x.lo == 0) & (x.hi == 0), dtype=bool))


def _minimum(a, b) -> IVal:
    a, b = IVal.coerce(a), IVal.coerce(b)
    return IVal(np.minimum(a.lo + 0 * b.lo, b.lo + 0 * a.lo),
                np.minimum(a.hi + 0 * b.hi, b.hi + 0 * a.hi), deps=a.deps | b.deps)


def _maximum(a, b) -> IVal:
    a, b = IVal.coerce(a), IVal.coerce(b)
    return IVal(np.maximum(a.lo + 0 * b.lo, b.lo + 0 * a.lo),
                np.maximum(a.hi + 0 * b.hi, b.hi + 0 * a.hi), deps=a.deps | b.deps)


def _where(cond, a=None, b=None) -> IVal:
    if a is None or b is None:
        raise AnalysisUnsupported("torch.where(cond) (data-dependent shape)")
    cond, a, b = IVal.coerce(cond), IVal.coerce(a), IVal.coerce(b)
    t, f = _defi(cond)
    shape = np.broadcast_shapes(cond.lo.shape, a.lo.shape, b.lo.shape)
    t, f = np.broadcast_to(t, shape), np.broadcast_to(f, shape)
    alo, ahi = np.broadcast_to(a.lo, shape), np.broadcast_to(a.hi, shape)
    blo, bhi = np.broadcast_to(b.lo, shape), np.broadcast_to(b.hi, shape)
    lo = np.where(t, alo, np.where(f, blo, np.minimum(alo, blo))).astype(object)
    hi = np.where(t, ahi, np.where(f, bhi, np.maximum(ahi, bhi))).astype(object)
    org = cons = None
    if a.org is not None or b.org is not None or a.cons is not None or b.cons is not None:
        # a decided condition passes the chosen operand through exactly
        org, cons = _empty(shape), _empty(shape)
        aorg, borg = _bview(a.org, shape), _bview(b.org, shape)
        acons, bcons = _bview(a.cons, shape), _bview(b.cons, shape)
        for pos in np.ndindex(*shape):
            if t[pos]:
                org[pos] = None if aorg is None else aorg[pos]
                cons[pos] = () if acons is None else acons[pos]
            elif f[pos]:
                org[pos] = None if borg is None else borg[pos]
                cons[pos] = () if bcons is None else bcons[pos]
            else:
                cons[pos] = ()
    return IVal(lo, hi, org=org, cons=cons, deps=cond.deps | a.deps | b.deps,
                is_bool=a.is_bool and b.is_bool)


def _broadcast_to(x, shape) -> IVal:
    return IVal.coerce(x).expand(_shape_args((shape,)))


def _full_like(x, value, **_kw) -> IVal:
    x = IVal.coerce(x)
    v = IVal.coerce(value)
    return IVal(np.broadcast_to(v.lo, x.lo.shape).copy(), np.broadcast_to(v.hi, x.lo.shape).copy(),
                is_bool=v.is_bool)


_TORCH_FUNCS = {
    "where": _where,
    "minimum": _minimum,
    "maximum": _maximum,
    "clamp": lambda x, min=None, max=None: IVal.coerce(x).clamp(min, max),  # noqa: A002
    "broadcast_to": _broadcast_to,
    "full_like": _full_like,
    "zeros_like": lambda x, **kw: _full_like(x, 0),
    "ones_like": lambda x, **kw: _full_like(x, 1),
    "gather": lambda x, dim, index, **kw: IVal.coerce(x).gather(dim, index),
    "__getitem__": lambda x, idx: IVal.coerce(x)[idx],
}

# a real tensor on the left of an operator whose right operand is an IVal
_TENSOR_BINOPS = {
    "add": "__add__", "__add__": "__add__", "__radd__": "__radd__",
    "sub": "__sub__", "__sub__": "__sub__", "__rsub__": "__rsub__", "rsub": "__rsub__",
    "mul": "__mul__", "__mul__": "__mul__", "__rmul__": "__rmul__",
    "floor_divide": "__floordiv__", "__floordiv__": "__floordiv__",
    "remainder": "__mod__", "__mod__": "__mod__",
    "__and__": "__and__", "bitwise_and": "__and__", "__rand__": "__rand__",
    "__or__": "__or__", "bitwise_or": "__or__", "__ror__": "__ror__",
    "__xor__": "__xor__", "bitwise_xor": "__xor__", "__rxor__": "__rxor__",
    "__lshift__": "__lshift__", "bitwise_left_shift": "__lshift__",
    "__rlshift__": "__rlshift__",
    "__rshift__": "__rshift__", "bitwise_right_shift": "__rshift__",
    "__rrshift__": "__rrshift__",
    "eq": "__eq__", "__eq__": "__eq__", "ne": "__ne__", "__ne__": "__ne__",
    "lt": "__lt__", "__lt__": "__lt__", "le": "__le__", "__le__": "__le__",
    "gt": "__gt__", "__gt__": "__gt__", "ge": "__ge__", "__ge__": "__ge__",
}


# --------------------------------------------------------------------------
# abstract state + kernel execution
# --------------------------------------------------------------------------


def state_hull(fields, rows: int = 1) -> dict:
    """Abstract batch of `rows` states: every field at its declared-range
    hull, each element origin-tagged (field, (row, *index))."""
    out = {}
    for f in fields:
        shape = (rows, *(f.shape or ()))
        org = _empty(shape)
        for pos in np.ndindex(*shape):
            org[pos] = (f.name, pos)
        out[f.name] = IVal(np.full(shape, f.lo, dtype=object), np.full(shape, f.hi, dtype=object),
                           org=org, deps=frozenset([f.name]))
    return out


def refine_row(state: dict, row: int, facts) -> tuple[dict, bool]:
    """Apply row-0 guard facts (field, (0, *index), kind, bound) to row
    `row` of a copy of the abstract batch -> (state, empty); `empty`
    means the facts contradict the declared bounds (the guard cannot
    hold)."""
    out = {k: IVal(v.lo.copy(), v.hi.copy(), org=v.org, deps=v.deps, is_bool=v.is_bool)
           for k, v in state.items()}
    empty = False
    for field, key, kind, bound in facts:
        if field not in out:
            continue
        v = out[field]
        pos = (row, *key[1:])
        if kind == "le":
            v.hi[pos] = min(v.hi[pos], bound)
        else:
            v.lo[pos] = max(v.lo[pos], bound)
        if v.lo[pos] > v.hi[pos]:
            empty = True
    return out, empty


def run_kernel_abstract(kernel, state: dict):
    """One abstract execution of a batched action kernel -> (enabled IVal
    [B, n], next {field: IVal [B, n, *shape]})."""
    try:
        enabled, nxt = kernel(dict(state))
        enabled = IVal.coerce(enabled)
        nxt = {k: IVal.coerce(v) for k, v in nxt.items()}
    except AnalysisUnsupported:
        raise
    except Exception as e:  # noqa: BLE001 -- a kernel outside the domain
        raise AnalysisUnsupported(
            f"kernel not abstractly executable ({type(e).__name__}: {e})"
        ) from e
    return enabled, nxt


def definitely_disabled(enabled: IVal) -> bool:
    """A guard is statically false iff its interval is exactly {0}."""
    return enabled.lo.size == 1 and enabled.lo.reshape(-1)[0] == 0 \
        and enabled.hi.reshape(-1)[0] == 0


def passes_through(v: IVal, field: str, row: int) -> bool:
    """True when every element of `v` (one successor's field) is the same
    element of the state row it was computed from: the field is not
    written."""
    if v.org is None:
        return False
    for pos in np.ndindex(*v.lo.shape):
        if v.org[pos] != (field, (row, *pos)):
            return False
    return True


def analyze_action(kernel, fields, n_choices: int) -> list:
    """The two-pass (collect guard facts, re-run refined) abstract
    execution of one action over all its choices.

    -> one dict per choice c:
       enabled: IVal scalar (the refined run's guard value)
       next:    {field: IVal of the field's shape}
       written: {field: bool}, False where the field passes through
    Raises AnalysisUnsupported for a kernel outside the domain."""
    base = state_hull(fields, 1)
    en0, nxt0 = run_kernel_abstract(kernel, base)
    if tuple(en0.shape) != (1, n_choices):
        en0 = en0.expand(1, n_choices)
    results = [None] * n_choices
    refined_rows = {}
    for c in range(n_choices):
        e = en0[0, c]
        facts = () if e.cons is None else e.cons[()]
        if not facts or definitely_disabled(e):
            results[c] = (e, {k: v[0, c] for k, v in nxt0.items()}, 0)
            continue
        refined_rows[c] = facts
    if refined_rows:
        state = state_hull(fields, n_choices)
        live = {}
        for c, facts in refined_rows.items():
            state, empty = refine_row(state, c, facts)
            if empty:
                # the guard's own conjuncts contradict the declared
                # bounds: statically disabled (the successor is unreachable)
                results[c] = (IVal(0, 0, is_bool=True),
                              {k: v[0, c] for k, v in nxt0.items()}, 0)
            else:
                live[c] = True
        if live:
            en1, nxt1 = run_kernel_abstract(kernel, state)
            if tuple(en1.shape) != (n_choices, n_choices):
                en1 = en1.expand(n_choices, n_choices)
            for c in live:
                results[c] = (en1[c, c], {k: v[c, c] for k, v in nxt1.items()}, c)
    out = []
    for e, nxt, row in results:
        out.append({
            "enabled": e,
            "next": nxt,
            "written": {f.name: f.name in nxt and not passes_through(nxt[f.name], f.name, row)
                        for f in fields},
        })
    return out
