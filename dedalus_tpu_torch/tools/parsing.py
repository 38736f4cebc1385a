"""
Equation-string parsing helpers (counterpart of dedalus_tpu/tools/parsing.py).
"""

from .exceptions import SymbolicParsingError


def split_equation(equation):
    """Split an equation string on the top-level '=' (respecting parentheses)."""
    parts = split_call(equation, "=")
    if len(parts) != 2:
        raise SymbolicParsingError(
            f"Equation must contain exactly one top-level '=': {equation!r}")
    return parts


def split_call(string, sep):
    """Split `string` on `sep` occurring at zero parenthesis depth."""
    depth = 0
    parts = []
    last = 0
    for i, ch in enumerate(string):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == sep and depth == 0:
            # Do not split on comparison operators (==, <=, >=, !=).
            if sep == "=" and (string[i - 1:i] in "<>=!" or string[i + 1:i + 2] == "="):
                continue
            parts.append(string[last:i].strip())
            last = i + 1
    parts.append(string[last:].strip())
    return parts
