"""Distribution and operation tags.

The same enums, with the same names and values, as
``elementalx/core/types.py`` (reference: include/El/core/types.hpp:208-380),
so that tests can map a tag of one package onto the other by name. They are
copied rather than imported because importing ``elementalx`` imports JAX.

On the port's single-device grid every distribution holds the whole matrix
on one ``torch.device``; the tags are kept as metadata so that code written
against the reference's distributions keeps its shape.
"""

from __future__ import annotations

import enum


class Dist(enum.IntEnum):
    """Distribution of one matrix axis (reference: include/El/core/types.hpp:208)."""

    MC = 0
    MD = 1
    MR = 2
    VC = 3
    VR = 4
    STAR = 5
    CIRC = 6

    def __repr__(self) -> str:  # 'MC' etc., matches El's DistToString
        return self.name


MC = Dist.MC
MD = Dist.MD
MR = Dist.MR
VC = Dist.VC
VR = Dist.VR
STAR = Dist.STAR
CIRC = Dist.CIRC


class DistWrap(enum.IntEnum):
    """ELEMENT (element-cyclic) vs BLOCK (block-cyclic / ScaLAPACK) wrap
    (reference: include/El/core/types.hpp DistWrap)."""

    ELEMENT = 0
    BLOCK = 1


ELEMENT = DistWrap.ELEMENT
BLOCK = DistWrap.BLOCK


def Collect(d: Dist) -> Dist:
    """Distribution after gathering the axis onto every process
    (reference: types.hpp Collect): every non-CIRC dist collects to STAR."""
    return CIRC if d == CIRC else STAR


def Partial(d: Dist) -> Dist:
    """Distribution after a *partial* all-gather (over the orthogonal axis of
    the vectorized comm): VC->MC, VR->MR, else unchanged
    (reference: types.hpp Partial)."""
    if d == VC:
        return MC
    if d == VR:
        return MR
    return d


def ProductDist(U: Dist, V: Dist) -> Dist:
    """The union distribution of a [U,V] matrix's joint comm
    (reference: types.hpp ProductDist). Only defined for the pairs the
    reference uses: (MC,MR)->VC, (MR,MC)->VR, (U,STAR)->U, (STAR,V)->V,
    (CIRC,CIRC)->CIRC, (STAR,STAR)->STAR."""
    if (U, V) == (MC, MR):
        return VC
    if (U, V) == (MR, MC):
        return VR
    if V == STAR:
        return U
    if U == STAR:
        return V
    if (U, V) == (CIRC, CIRC):
        return CIRC
    raise ValueError(f"ProductDist undefined for ({U!r},{V!r})")


def DiagCol(U: Dist, V: Dist) -> Dist:
    """Column distribution of the diagonal of a [U,V] matrix
    (reference: types.hpp DiagCol): diag of [MC,MR]/[MR,MC] lives on MD."""
    if (U, V) in ((MC, MR), (MR, MC)):
        return MD
    if U == STAR and V == STAR:
        return STAR
    return ProductDist(U, V)


def DiagRow(U: Dist, V: Dist) -> Dist:
    """Row distribution of the diagonal of a [U,V] matrix (types.hpp DiagRow)."""
    if (U, V) in ((MC, MR), (MR, MC)):
        return STAR
    if U == STAR and V == STAR:
        return STAR
    return STAR


#: The 13 element-wrap DistMatrix distributions instantiated by the reference
#: (src/core/DistMatrix/ElementMatrix/*.cpp) plus [CIRC,CIRC].
ALL_DISTS = (
    (MC, MR),
    (MC, STAR),
    (STAR, MR),
    (MD, STAR),
    (STAR, MD),
    (MR, MC),
    (MR, STAR),
    (STAR, MC),
    (VC, STAR),
    (STAR, VC),
    (VR, STAR),
    (STAR, VR),
    (STAR, STAR),
    (CIRC, CIRC),
)


class UpperOrLower(enum.IntEnum):
    LOWER = 0
    UPPER = 1


LOWER = UpperOrLower.LOWER
UPPER = UpperOrLower.UPPER


class Orientation(enum.IntEnum):
    NORMAL = 0
    TRANSPOSE = 1
    ADJOINT = 2


NORMAL = Orientation.NORMAL
TRANSPOSE = Orientation.TRANSPOSE
ADJOINT = Orientation.ADJOINT


class LeftOrRight(enum.IntEnum):
    LEFT = 0
    RIGHT = 1


LEFT = LeftOrRight.LEFT
RIGHT = LeftOrRight.RIGHT


class UnitOrNonUnit(enum.IntEnum):
    NON_UNIT = 0
    UNIT = 1


NON_UNIT = UnitOrNonUnit.NON_UNIT
UNIT = UnitOrNonUnit.UNIT


class ForwardOrBackward(enum.IntEnum):
    FORWARD = 0
    BACKWARD = 1


FORWARD = ForwardOrBackward.FORWARD
BACKWARD = ForwardOrBackward.BACKWARD


class Conjugation(enum.IntEnum):
    UNCONJUGATED = 0
    CONJUGATED = 1


UNCONJUGATED = Conjugation.UNCONJUGATED
CONJUGATED = Conjugation.CONJUGATED


class VerticalOrHorizontal(enum.IntEnum):
    VERTICAL = 0
    HORIZONTAL = 1


VERTICAL = VerticalOrHorizontal.VERTICAL
HORIZONTAL = VerticalOrHorizontal.HORIZONTAL


class SortType(enum.IntEnum):
    UNSORTED = 0
    DESCENDING = 1
    ASCENDING = 2


UNSORTED = SortType.UNSORTED
DESCENDING = SortType.DESCENDING
ASCENDING = SortType.ASCENDING


class GemmAlgorithm(enum.IntEnum):
    """Distributed GEMM algorithm selection
    (reference: include/El/blas_like/level3.hpp:24-29)."""

    GEMM_DEFAULT = 0
    GEMM_SUMMA_A = 1
    GEMM_SUMMA_B = 2
    GEMM_SUMMA_C = 3
    GEMM_SUMMA_DOT = 4
    GEMM_CANNON = 5
    #: pure-GSPMD path: annotate shardings, let XLA plan the collectives.
    GEMM_XLA = 6


GEMM_DEFAULT = GemmAlgorithm.GEMM_DEFAULT
GEMM_SUMMA_A = GemmAlgorithm.GEMM_SUMMA_A
GEMM_SUMMA_B = GemmAlgorithm.GEMM_SUMMA_B
GEMM_SUMMA_C = GemmAlgorithm.GEMM_SUMMA_C
GEMM_SUMMA_DOT = GemmAlgorithm.GEMM_SUMMA_DOT
GEMM_CANNON = GemmAlgorithm.GEMM_CANNON
GEMM_XLA = GemmAlgorithm.GEMM_XLA
