"""Shape contracts (``hfrep_tpu/analysis/contracts.py``), a stand-in.

The JAX package checks ``@contract("(N,)->(N,)")`` specs at call time
and reads them in its static analysis.  Until that analysis engine is
ported (ROADMAP queue 1 item 10) the port only records the spec on the
function; a function that must refuse a bad shape checks it inline and
raises :class:`ContractError`.
"""

from __future__ import annotations


class ContractError(Exception):
    """A shape contract was violated at call time."""


def contract(spec: str):
    """Record ``spec`` on the decorated function as ``__contract__``."""

    def deco(fn):
        fn.__contract__ = spec
        return fn

    return deco
