"""Constraint-side expressions: variables, linear terms, linear
combinations.

The port's own copy of libiop_tpu/relations/variable.py (the counterpart of
libiop/relations/variable.{hpp,tcc}): ``Variable`` (x_i), ``LinearTerm``
(c*x_i) and ``LinearCombination`` (sum_i c_i*x_i) with the full operator
arithmetic, so a circuit reads ``cs.add_constraint(x + 3*y, z - 2, w)``
instead of raw ``[(index, coeff), ...]`` pairs (variable.hpp:48-66, 90-112,
148-188).  Int constants work on either side of ``+`` and ``-`` (so
``sum()`` starts from 0), like terms merge, and the three classes compare
and hash by value.

Host-side metadata only: indices and coefficients are Python ints (reduced
mod p when the R1CS bakes its matrices), so one circuit description works
over every field.  Variable 0 is the constant 1 (r1cs.hpp z-vector layout).
"""
from __future__ import annotations

from typing import Iterable, List, Tuple, Union

Coeff = int
Termlike = Union[int, "Variable", "LinearTerm", "LinearCombination"]


class Variable:
    """Formal expression x_{index}; index 0 is the constant 1
    (variable.hpp:48-66)."""

    __slots__ = ("index",)

    def __init__(self, index: int = 0):
        if index < 0:
            raise ValueError("variable index must be >= 0")
        self.index = int(index)

    def __mul__(self, coeff: Coeff) -> "LinearTerm":
        return LinearTerm(self.index, coeff)

    __rmul__ = __mul__

    def __add__(self, other: Termlike) -> "LinearCombination":
        return LinearCombination(self) + other

    def __radd__(self, other: Termlike) -> "LinearCombination":
        return as_linear_combination(other) + self

    def __sub__(self, other: Termlike) -> "LinearCombination":
        return LinearCombination(self) - other

    def __rsub__(self, other: Termlike) -> "LinearCombination":
        return as_linear_combination(other) - self

    def __neg__(self) -> "LinearTerm":
        return LinearTerm(self.index, -1)

    def __eq__(self, other) -> bool:
        return isinstance(other, Variable) and self.index == other.index

    def __hash__(self) -> int:
        return hash(("Variable", self.index))

    def __repr__(self) -> str:
        return "1" if self.index == 0 else f"x_{self.index}"


class LinearTerm:
    """Formal expression coeff * x_{index} (variable.hpp:90-112)."""

    __slots__ = ("index", "coeff")

    def __init__(self, index: int, coeff: Coeff = 1):
        self.index = int(index)
        self.coeff = int(coeff)

    def __mul__(self, coeff: Coeff) -> "LinearTerm":
        return LinearTerm(self.index, self.coeff * int(coeff))

    __rmul__ = __mul__

    def __add__(self, other: Termlike) -> "LinearCombination":
        return LinearCombination(self) + other

    def __radd__(self, other: Termlike) -> "LinearCombination":
        return as_linear_combination(other) + self

    def __sub__(self, other: Termlike) -> "LinearCombination":
        return LinearCombination(self) - other

    def __rsub__(self, other: Termlike) -> "LinearCombination":
        return as_linear_combination(other) - self

    def __neg__(self) -> "LinearTerm":
        return LinearTerm(self.index, -self.coeff)

    def __eq__(self, other) -> bool:
        return (isinstance(other, LinearTerm) and self.index == other.index
                and self.coeff == other.coeff)

    def __hash__(self) -> int:
        return hash(("LinearTerm", self.index, self.coeff))

    def __repr__(self) -> str:
        base = "1" if self.index == 0 else f"x_{self.index}"
        return base if self.coeff == 1 else f"{self.coeff}*{base}"


class LinearCombination:
    """Formal expression sum_i coeff_i * x_{index_i}
    (variable.hpp:148-188)."""

    __slots__ = ("terms",)

    def __init__(self, init: Termlike | Iterable[Termlike] = ()):
        self.terms: List[LinearTerm] = []
        if isinstance(init, (int, Variable, LinearTerm, LinearCombination)):
            self.terms = list(as_linear_combination(init).terms)
        else:
            for t in init:
                self.add_term(t)

    # -- mutation (reference add_term overloads) ---------------------------
    def add_term(self, term: Termlike, coeff: Coeff | None = None):
        if coeff is not None:
            if not isinstance(term, Variable):
                raise TypeError("add_term(var, coeff) takes a Variable")
            self.terms.append(LinearTerm(term.index, coeff))
            return
        if isinstance(term, Variable):
            self.terms.append(LinearTerm(term.index, 1))
        elif isinstance(term, LinearTerm):
            self.terms.append(LinearTerm(term.index, term.coeff))
        elif isinstance(term, int):
            self.terms.append(LinearTerm(0, term))
        else:
            raise TypeError(f"cannot add_term({term!r})")

    # -- arithmetic --------------------------------------------------------
    def __mul__(self, coeff: Coeff) -> "LinearCombination":
        out = LinearCombination()
        out.terms = [LinearTerm(t.index, t.coeff * int(coeff))
                     for t in self.terms]
        return out

    __rmul__ = __mul__

    def __add__(self, other: Termlike) -> "LinearCombination":
        other = as_linear_combination(other)
        out = LinearCombination()
        out.terms = list(self.terms) + list(other.terms)
        return out

    def __radd__(self, other: Termlike) -> "LinearCombination":
        return as_linear_combination(other) + self

    def __sub__(self, other: Termlike) -> "LinearCombination":
        return self + (-as_linear_combination(other))

    def __rsub__(self, other: Termlike) -> "LinearCombination":
        return as_linear_combination(other) - self

    def __neg__(self) -> "LinearCombination":
        return self * -1

    def __iter__(self):
        return iter(self.terms)

    def __eq__(self, other) -> bool:
        if not isinstance(other, LinearCombination):
            return NotImplemented
        return self.combined() == other.combined()

    def __hash__(self) -> int:
        return hash(("LinearCombination", tuple(self.combined())))

    # -- queries -----------------------------------------------------------
    def combined(self) -> List[Tuple[int, int]]:
        """Like-term-merged, index-sorted [(index, coeff)] pairs with zero
        coefficients dropped — the raw form the R1CS container consumes."""
        acc: dict = {}
        for t in self.terms:
            acc[t.index] = acc.get(t.index, 0) + t.coeff
        return sorted((i, c) for i, c in acc.items() if c != 0)

    def evaluate(self, full_assignment: List[int], p: int) -> int:
        """Evaluate over z = (1, assignment...) as integers mod p
        (variable.tcc evaluate role).  ``full_assignment`` excludes the
        leading constant-1 slot, matching the reference's convention."""
        total = 0
        for i, c in self.combined():
            v = 1 if i == 0 else full_assignment[i - 1]
            total += c * v
        return total % p

    def is_valid(self, num_variables: int) -> bool:
        """All variable indices within [0, num_variables]
        (variable.tcc is_valid role: index 0 is the constant)."""
        return all(t.index <= num_variables for t in self.terms)

    def __repr__(self) -> str:
        return " + ".join(map(repr, self.terms)) or "0"


def as_linear_combination(x: Termlike) -> LinearCombination:
    """Coerce int / Variable / LinearTerm / LinearCombination to a
    LinearCombination (the reference's implicit converting constructors,
    variable.hpp:181-186)."""
    if isinstance(x, LinearCombination):
        return x
    out = LinearCombination()
    if isinstance(x, (int, Variable, LinearTerm)):
        out.add_term(x)
        return out
    raise TypeError(f"cannot interpret {x!r} as a linear combination")


def as_term_pairs(lc) -> List[Tuple[int, int]]:
    """Normalize any constraint-side argument — raw [(index, coeff)] pairs,
    int constant, Variable, LinearTerm, or LinearCombination — to the raw
    pair list stored in R1CS constraints."""
    if isinstance(lc, (int, Variable, LinearTerm, LinearCombination)):
        return as_linear_combination(lc).combined()
    return list(lc)
