"""
Caching decorators (counterpart of dedalus_tpu/tools/cache.py).

`CachedMethod`/`CachedFunction` — memoization on hashable arguments.
`CachedClass` — metaclass interning instances by constructor arguments, so
bases/domains are singletons per argument tuple (reference:
dedalus/tools/cache.py:111-163).
"""

import types
from collections import OrderedDict
from functools import partial

import numpy as np


class CachedFunction:
    """Memoize a function on hashable (serialized) arguments."""

    def __init__(self, function, max_size=None):
        self.function = function
        self.cache = OrderedDict()
        self.max_size = max_size
        self.__name__ = function.__name__
        self.__doc__ = function.__doc__

    def __call__(self, *args, **kw):
        key = serialize_call(args, kw)
        try:
            return self.cache[key]
        except KeyError:
            result = self.cache[key] = self.function(*args, **kw)
            if self.max_size and len(self.cache) > self.max_size:
                self.cache.popitem(last=False)
            return result


def cached_function(function=None, max_size=None):
    if function is None:
        return partial(cached_function, max_size=max_size)
    return CachedFunction(function, max_size=max_size)


class CachedMethod:
    """Memoize a method per-instance on hashable arguments."""

    def __init__(self, method):
        self.method = method
        self.__name__ = method.__name__
        self.__doc__ = method.__doc__

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = CachedFunction(types.MethodType(self.method, instance))
        instance.__dict__[self.__name__] = bound
        return bound


class CachedClass(type):
    """Metaclass interning instances by (serialized) constructor arguments."""

    def __init__(cls, *args, **kw):
        super().__init__(*args, **kw)
        cls._instance_cache = {}

    def __call__(cls, *args, **kw):
        key = serialize_call(args, kw)
        try:
            return cls._instance_cache[key]
        except KeyError:
            instance = cls._instance_cache[key] = super().__call__(*args, **kw)
            return instance
        except TypeError:
            # Unhashable argument: skip interning.
            return super().__call__(*args, **kw)


def serialize_call(args, kw):
    """Produce a hashable key from call arguments."""
    return (tuple(map(serialize, args)),
            tuple((k, serialize(v)) for k, v in sorted(kw.items())))


def serialize(arg):
    if isinstance(arg, np.ndarray):
        return (arg.shape, arg.dtype.str, arg.tobytes())
    if isinstance(arg, (list, tuple)):
        return tuple(map(serialize, arg))
    if isinstance(arg, dict):
        return tuple((k, serialize(v)) for k, v in sorted(arg.items()))
    # objects with state beyond their __eq__/__hash__ that must key caches
    # (e.g. coordinate systems: equal-by-name, but the distributor-assigned
    # AXES distinguish a disk at axes (0,1) from one inside a cylinder at
    # (1,2) — interning must not alias them)
    token = getattr(arg, "_cache_token", None)
    if token is not None:
        return token
    return arg
