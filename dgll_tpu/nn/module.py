"""A minimal neural-network module layer: parameters held in nested dicts.

A :class:`Module` is a frozen dataclass of hyper-parameters whose ``__call__``
builds its computation, creating sub-modules inline and asking for its own
parameters with :meth:`Module.param`. Two entry points run a top-level module:

* ``model.init(key, *args, **kw) -> {"params": tree}`` runs the call once and
  collects every parameter it asks for, initialised from ``key``;
* ``model.apply({"params": tree}, *args, rngs={"dropout": key}, **kw)`` runs it
  with those parameters; ``rngs`` feeds :meth:`Module.make_rng`.

The parameter tree nests one dict per sub-module that owns parameters. A
sub-module is named ``name=`` if given, else ``<ClassName>_<k>`` with ``k``
counting that class's sub-modules in the parent, in construction order
(``{"GCNConv_0": {"weight": {"kernel": ...}, "bias": ...}}``). A module built
once and called several times shares one set of parameters.

Every random key a module draws, for a parameter or for dropout, is the stream's
root key folded with a hash of (module path, draw count in that module), so keys
do not depend on the call order across modules. The hash is the one Flax's
``linen`` uses, so a model initialised from the same key gets the same
parameters under either library.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _fold_in_path(key: jax.Array, data) -> jax.Array:
    """Fold the names and counts in ``data`` into ``key`` by their SHA-1."""
    m = hashlib.sha1()
    for x in data:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class _Scope:
    """Where one module instance keeps its parameters during init/apply."""

    def __init__(self, params: Dict, rngs: Dict, initializing: bool, path=(),
                 parent: Optional["_Scope"] = None,
                 rng_counts: Optional[Dict[str, int]] = None):
        self._params = params
        self.rngs = rngs
        self.initializing = initializing
        self.path = path
        self._parent = parent
        self.name_counts: Dict[str, int] = {}
        # per-stream draw counts; a module called twice keeps counting
        self.rng_counts = {} if rng_counts is None else rng_counts
        self._child_rng_counts: Dict[str, Dict[str, int]] = {}

    def params(self, create: bool) -> Optional[Dict]:
        # a module's dict appears in the tree only once it owns a parameter
        if self._params is None and self._parent is not None:
            parent = self._parent.params(create)
            if parent is not None:
                name = self.path[-1]
                if create:
                    parent.setdefault(name, {})
                self._params = parent.get(name)
        return self._params

    def child(self, name: str) -> "_Scope":
        counts = self._child_rng_counts.setdefault(name, {})
        return _Scope(None, self.rngs, self.initializing, self.path + (name,),
                      self, counts)

    def make_rng(self, stream: str) -> jax.Array:
        if stream not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError(
                    f"module {'/'.join(self.path) or '<root>'} needs an rng for "
                    f"{stream!r}; pass rngs={{{stream!r}: key}}")
            stream = "params"
        k = self.rng_counts.get(stream, 0) + 1
        self.rng_counts[stream] = k
        return _fold_in_path(self.rngs[stream], self.path + (k,))


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class; see the module docstring."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        call = cls.__dict__.get("__call__")
        if call is not None:
            cls.__call__ = _scoped(call)
        dataclasses.dataclass(frozen=True)(cls)

    def __post_init__(self):
        # built inside a parent's call: take a name in the parent's scope now,
        # so repeated calls of this instance reuse the same parameters
        parent = _stack()[-1] if _stack() else None
        name = self.name
        if parent is not None and name is None:
            prefix = type(self).__name__
            k = parent.name_counts.get(prefix, 0)
            parent.name_counts[prefix] = k + 1
            name = f"{prefix}_{k}"
        object.__setattr__(self, "_parent_scope", parent)
        object.__setattr__(self, "_scope_name", name)

    # -------------------------------------------------------------- in a call
    def param(self, name: str, init_fn: Callable, *init_args) -> jax.Array:
        """This module's parameter ``name``, created by
        ``init_fn(key, *init_args)`` during ``init``."""
        scope = self._scope()
        params = scope.params(create=scope.initializing)
        if params is not None and name in params:
            return params[name]
        if not scope.initializing:
            raise KeyError(f"no parameter {'/'.join(scope.path + (name,))}")
        params[name] = init_fn(scope.make_rng("params"), *init_args)
        return params[name]

    def make_rng(self, stream: str) -> jax.Array:
        """A fresh key from the ``stream`` key passed to init/apply."""
        return self._scope().make_rng(stream)

    def _scope(self) -> _Scope:
        stack = _stack()
        if not stack:
            raise RuntimeError(f"{type(self).__name__} is not running; call it "
                               "through init/apply or from a parent module")
        return stack[-1]

    # ------------------------------------------------------------ entry points
    def init(self, key: jax.Array, *args, **kwargs) -> Dict[str, Any]:
        params: Dict = {}
        self._run(_Scope(params, {"params": key}, True), args, kwargs)
        return {"params": params}

    def apply(self, variables: Dict[str, Any], *args,
              rngs: Optional[Dict[str, jax.Array]] = None, **kwargs):
        scope = _Scope(variables["params"], dict(rngs or {}), False)
        return self._run(scope, args, kwargs)

    def _run(self, scope: _Scope, args, kwargs):
        stack = _stack()
        stack.append(scope)
        try:
            return type(self).__call__.__wrapped__(self, *args, **kwargs)
        finally:
            stack.pop()


def _scoped(call):
    @functools.wraps(call)
    def wrapper(self, *args, **kwargs):
        parent = self._parent_scope
        if parent is None:
            raise RuntimeError(f"call {type(self).__name__} through init/apply")
        stack = _stack()
        stack.append(parent.child(self._scope_name))
        try:
            return call(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapper


class Dense(Module):
    """``x @ kernel + bias``; parameters in float32, computed in ``dtype``
    (default: the promotion of the input's dtype with float32)."""

    features: int
    use_bias: bool = True
    dtype: Optional[Any] = None

    def __call__(self, x: jax.Array) -> jax.Array:
        kernel = self.param("kernel", jax.nn.initializers.lecun_normal(),
                            (x.shape[-1], self.features), jnp.float32)
        dtype = (self.dtype if self.dtype is not None
                 else jnp.result_type(x.dtype, jnp.float32))
        y = jax.lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                                (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros,
                              (self.features,), jnp.float32)
            y = y + bias.astype(dtype)
        return y


class Dropout(Module):
    """Inverted dropout; identity when ``deterministic`` or ``rate == 0``.
    Draws from the ``"dropout"`` rng stream."""

    rate: float
    deterministic: Optional[bool] = None

    def __call__(self, x: jax.Array, deterministic: Optional[bool] = None):
        det = self.deterministic if deterministic is None else deterministic
        if det or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return jnp.zeros_like(x)
        keep = jax.random.bernoulli(self.make_rng("dropout"), 1.0 - self.rate,
                                    x.shape)
        return jnp.where(keep, x / (1.0 - self.rate), jnp.zeros_like(x))
