"""Comparison helper of the port's parity tests: results of the JAX package
and of the port as plain nested values, so that ``==`` compares them field
by field, every float exactly."""
import dataclasses

WALL = frozenset({"wall_s"})


def plain(x, skip=WALL):
    """Nested tuples of plain values: dataclasses by class name and fields
    (minus ``skip``, by default the wall-clock ``wall_s``), dicts in
    insertion order, sets sorted, callables as one token."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name), skip))
            for f in dataclasses.fields(x) if f.name not in skip)
    if isinstance(x, dict):
        return ("dict",) + tuple((plain(k, skip), plain(v, skip))
                                 for k, v in x.items())
    if isinstance(x, (list, tuple, set, frozenset)):
        items = sorted(x, key=repr) if isinstance(x, (set, frozenset)) else x
        return (type(x).__name__,) + tuple(plain(v, skip) for v in items)
    if callable(x):
        return "callable"
    return x
