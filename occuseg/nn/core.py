"""A small module/parameter layer with the `flax.linen` compact API.

The model code is written as `flax.linen`-style modules (dataclass fields,
`@compact` `__call__`, `self.param` / `self.variable`, `init` / `apply`
with mutable collections). This module implements exactly that subset, so
the program needs only JAX. It keeps linen's conventions wherever they are
observable:

* parameter trees are nested dicts keyed by module names; a child takes its
  explicit `name`, else the dataclass field that holds it (`layers_0` for
  a tuple entry), else `<ClassName>_<n>` in construction order;
* `init(key, ...)` derives each parameter key by folding the SHA-1 of the
  scope path and a per-scope counter into the root key (linen's
  `LazyRng`), so a seed gives the same initial weights as linen does;
* `apply(variables, ..., mutable=[...])` returns `(out, updated)` where
  `updated` holds the mutable collections.

Not supported: `setup()`, lifted transforms, variable boxing/metadata.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Callable, Dict, Iterable, Optional

import jax
import jax.numpy as jnp
from jax.nn import (  # noqa: F401  (re-exported as nn.<activation>)
    elu,
    initializers,
    leaky_relu,
    log_softmax,
    one_hot,
    relu,
    selu,
    sigmoid,
    softmax,
    softplus,
)

_CTX = threading.local()


def _stack() -> list:
    if not hasattr(_CTX, "stack"):
        _CTX.stack = []
        _CTX.root = None
    return _CTX.stack


def _fold_in_path(key, data: Iterable) -> jax.Array:
    """linen's `_fold_in_static`: SHA-1 over the path names and counter."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    h = int.from_bytes(m.digest()[:4], "big")
    return jax.random.fold_in(key, jnp.uint32(h))


class _Root:
    """State of one `init` / `apply` call."""

    def __init__(self, top, variables, rngs, mutable, initializing):
        self.top = top
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counters: Dict[tuple, Dict[str, int]] = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def node(self, col: str, path: tuple, create: bool):
        d = self.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.variables[col] = {}
        for k in path:
            nxt = d.get(k)
            if nxt is None:
                if not create:
                    return None
                nxt = d[k] = {}
            d = nxt
        return d


class _Frame:
    """One running compact method: the module, its scope path and the
    construction-order cursor for auto-named children."""

    def __init__(self, module, path):
        self.module = module
        self.path = path
        self.cursor: Dict[str, int] = {}


class Variable:
    """A named slot in a collection; `.value` reads and writes it."""

    def __init__(self, root: _Root, col: str, path: tuple, name: str):
        self._root, self._col, self._path, self._name = root, col, path, name

    @property
    def value(self):
        return self._root.node(self._col, self._path, False)[self._name]

    @value.setter
    def value(self, v):
        if not self._root.is_mutable(self._col):
            raise ValueError(f"collection {self._col!r} is not mutable; "
                             "pass mutable=[...] to apply")
        self._root.node(self._col, self._path, True)[self._name] = v


def _attr_name(parent, child) -> Optional[str]:
    """Name of a child module held in one of the parent's fields."""
    for f in dataclasses.fields(parent):
        v = getattr(parent, f.name)
        if v is child:
            return f.name
        if isinstance(v, (tuple, list)):
            for i, e in enumerate(v):
                if e is child:
                    return f"{f.name}_{i}"
        if isinstance(v, dict):
            for k, e in v.items():
                if e is child:
                    return f"{f.name}_{k}"
    return None


def _autoname(frame: _Frame, module) -> str:
    cls = type(module).__name__
    n = frame.cursor.get(cls, 0)
    frame.cursor[cls] = n + 1
    return f"{cls}_{n}"


def compact(fn: Callable) -> Callable:
    """Mark a method that declares parameters and submodules inline."""

    def wrapped(self, *args, **kwargs):
        stack = _stack()
        root = _CTX.root
        if root is None:
            raise RuntimeError(
                f"{type(self).__name__} is unbound: call it through "
                "init() or apply(), or from another module's method")
        if not stack:
            path = ()
        else:
            parent = stack[-1]
            name = (self.name or _attr_name(parent.module, self)
                    or _autoname(parent, self))
            path = parent.path + (name,)
        stack.append(_Frame(self, path))
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    wrapped.__wrapped__ = fn
    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


def nowrap(fn: Callable) -> Callable:
    """linen marker for helper methods; nothing to do here."""
    return fn


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class: subclasses are frozen dataclasses whose fields are the
    hyper-parameters; `name` is keyword-only, as in linen."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)

    def __post_init__(self):
        stack = _stack()
        if self.name is None and stack:
            # constructed inside a compact method: linen names children in
            # construction order
            object.__setattr__(self, "name", _autoname(stack[-1], self))

    # -- inside a compact method ------------------------------------------
    def _frame(self) -> _Frame:
        stack = _stack()
        if not stack or stack[-1].module is not self:
            raise RuntimeError("param/variable outside the module's "
                               "compact method")
        return stack[-1]

    def is_initializing(self) -> bool:
        return _CTX.root.initializing

    def make_rng(self, name: str = "params") -> jax.Array:
        root = _CTX.root
        if name not in root.rngs:
            if "params" not in root.rngs:
                raise ValueError(f"{type(self).__name__} needs an rng "
                                 f"{name!r}: pass rngs={{{name!r}: key}}")
            name = "params"
        path = self._frame().path
        counters = root.rng_counters.setdefault(path, {})
        counters[name] = counters.get(name, 0) + 1
        return _fold_in_path(root.rngs[name], path + (counters[name],))

    def param(self, name: str, init_fn: Callable, *init_args) -> Any:
        root = _CTX.root
        path = self._frame().path
        node = root.node("params", path, False)
        if node is not None and name in node:
            return node[name]
        if not root.is_mutable("params"):
            raise KeyError(f"no parameter {'/'.join(path + (name,))}")
        value = init_fn(self.make_rng("params"), *init_args)
        root.node("params", path, True)[name] = value
        return value

    def variable(self, col: str, name: str, init_fn: Callable,
                 *init_args) -> Variable:
        root = _CTX.root
        path = self._frame().path
        node = root.node(col, path, False)
        if node is None or name not in node:
            if not root.is_mutable(col):
                raise KeyError(f"no variable {col}/"
                               f"{'/'.join(path + (name,))}")
            root.node(col, path, True)[name] = init_fn(*init_args)
        return Variable(root, col, path, name)

    # -- entry points -----------------------------------------------------
    def _run(self, variables, rngs, mutable, initializing, args, kwargs):
        if getattr(_CTX, "root", None) is not None:
            raise RuntimeError("nested init/apply is not supported")
        _stack()
        root = _Root(self, variables, rngs, mutable, initializing)
        _CTX.root = root
        try:
            out = self(*args, **kwargs)
        finally:
            _CTX.root = None
        return out, root.variables

    def init(self, rngs, *args, **kwargs) -> Dict[str, Any]:
        """Create every collection; `rngs` is a key or {name: key}."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        _, variables = self._run({}, rngs, True, True, args, kwargs)
        return variables

    def apply(self, variables, *args, rngs=None, mutable=False, **kwargs):
        """Run with the given variables. With `mutable` (a list of
        collection names), return `(out, {col: updated tree})`."""
        if rngs is not None and not isinstance(rngs, dict):
            rngs = {"params": rngs}
        if isinstance(mutable, str):
            mutable = [mutable]
        mut = set(mutable) if mutable not in (False, None, True) else mutable
        # copy the containers (not the leaves) so updates never alias the
        # caller's trees
        own = jax.tree.map(lambda x: x, dict(variables))
        out, new = self._run(own, rngs or {}, mut or set(), False, args,
                             kwargs)
        if not mutable:
            return out
        keep = new if mutable is True else {c: new.get(c, {}) for c in mut}
        return out, keep


class Dense(Module):
    """y = x @ kernel + bias (linen `Dense`: lecun-normal kernel
    [in, out], zero bias, operands promoted to a common dtype)."""

    features: int
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        k = self.param("kernel", self.kernel_init,
                       (x.shape[-1], self.features), jnp.float32)
        dt = jnp.result_type(x.dtype, k.dtype)
        y = jax.lax.dot_general(x.astype(dt), k.astype(dt),
                                (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            b = self.param("bias", self.bias_init, (self.features,),
                           jnp.float32)
            y = y + b.astype(dt)
        return y


class BatchNorm(Module):
    """Dense-tensor batch norm over all but the last axis (linen
    `BatchNorm`: `scale`/`bias` params, `mean`/`var` batch stats,
    momentum is the running-average decay)."""

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5

    @compact
    def __call__(self, x):
        c = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((c,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((c,), jnp.float32))
        scale = self.param("scale", initializers.ones, (c,), jnp.float32)
        bias = self.param("bias", initializers.zeros, (c,), jnp.float32)
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            axes = tuple(range(x.ndim - 1))
            xf = x.astype(jnp.float32)
            mean = jnp.mean(xf, axes)
            var = jnp.maximum(jnp.mean(xf * xf, axes) - mean * mean, 0.0)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        y = (x - mean) * jax.lax.rsqrt(var + self.epsilon)
        return (y * scale + bias).astype(x.dtype)
