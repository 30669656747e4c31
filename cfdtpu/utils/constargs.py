"""Closure-constant extraction for huge-mesh jit compiles.

jax.jit embeds closed-over device arrays as CONSTANTS in the serialized
HLO. For this framework the static index maps (supernode placement
positions, SELFP distance-2 triple maps, AMG hierarchy maps, dofmaps)
total hundreds of MB beyond ~400k DOF, all of it copied into the program
the compiler builds. Whether the H100 compile time or memory at 949,929
DOF still needs this is an open question (ROADMAP C7).

The fix: collect every large array reachable from the solver's operator
objects, pass them to the jitted step as ARGUMENTS (ordinary device
buffers, never serialized into the program), and — during tracing only —
swap the object attributes for the incoming tracers so the existing
closure-style code paths read tracers instead of constants. Attributes
are restored after tracing. Tuples in containers are converted to lists
once at collection time so their slots are writable.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import jax


def _is_big_array(x, min_bytes: int) -> bool:
    return (
        isinstance(x, jax.Array)
        and x.size * x.dtype.itemsize >= min_bytes
    )


def collect_const_slots(roots, min_bytes: int = 1 << 20):
    """Walk `roots` (objects / dicts / lists) and return a list of
    (container, key) slots holding device arrays >= min_bytes. Tuples
    encountered inside lists/dicts are converted to lists in place so
    the slots are assignable."""
    slots = []
    seen = set()

    def visit(container):
        if isinstance(container, type):
            return  # never rewrite class objects (e.g. __bases__)
        oid = id(container)
        if oid in seen:
            return
        seen.add(oid)
        if isinstance(container, dict):
            items = list(container.items())
            entries = [(container, k, v) for k, v in items]
        elif isinstance(container, list):
            for i, v in enumerate(container):
                if isinstance(v, tuple):
                    container[i] = list(v)
            entries = [(container, i, v)
                       for i, v in enumerate(container)]
        elif hasattr(container, "__dict__") or hasattr(
            type(container), "__slots__"
        ):
            # objects: instance dict attrs plus __slots__ attrs across
            # the MRO (AMGLevel / PLevel / SuperMaps are slotted — their
            # transfer maps are some of the LARGEST static arrays in a
            # hierarchy and must not ride along as HLO constants)
            names = list(vars(container)) if hasattr(
                container, "__dict__"
            ) else []
            for klass in type(container).__mro__:
                for s in getattr(klass, "__slots__", ()):
                    if s not in names and hasattr(container, s):
                        names.append(s)
            entries = []
            for k in names:
                v = getattr(container, k)
                if isinstance(v, tuple) and any(
                    isinstance(e, (jax.Array, list, dict)) or
                    hasattr(e, "__dict__") or
                    hasattr(type(e), "__slots__") for e in v
                ):
                    v = list(v)
                    setattr(container, k, v)
                entries.append((container, k, v))
        else:
            return
        for cont, key, val in entries:
            if _is_big_array(val, min_bytes):
                slots.append((cont, key))
            elif isinstance(val, (dict, list)):
                visit(val)
            elif (
                (hasattr(val, "__dict__")
                 or hasattr(type(val), "__slots__"))
                and not isinstance(
                    val, (jax.Array, np.ndarray, str, bytes)
                )
            ):
                visit(val)
    for r in roots:
        visit(r)
    return slots


def _get(cont, key):
    return cont[key] if isinstance(cont, (dict, list)) else getattr(
        cont, key
    )


def _set(cont, key, val):
    if isinstance(cont, (dict, list)):
        cont[key] = val
    else:
        setattr(cont, key, val)


def make_const_wrapped(fn, roots, min_bytes: int = 1 << 20):
    """Return (wrapped, consts) where wrapped(*args, consts) == fn(*args)
    but every large device array reachable from `roots` enters the jit
    as an argument instead of a closure constant."""
    slots = collect_const_slots(roots, min_bytes=min_bytes)
    consts = tuple(_get(c, k) for c, k in slots)

    def wrapped(*args_and_consts):
        *args, cvals = args_and_consts
        saved = [(_get(c, k)) for c, k in slots]
        try:
            for (c, k), v in zip(slots, cvals):
                _set(c, k, v)
            return fn(*args)
        finally:
            for (c, k), v in zip(slots, saved):
                _set(c, k, v)

    return wrapped, consts
