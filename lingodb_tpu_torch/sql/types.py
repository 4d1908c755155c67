"""SQL logical type system.

Equivalent of the reference catalog type system
(reference: src/catalog/Types.cpp, include/lingodb/catalog/Types.h:17-118) and the
DB-dialect types (reference: include/lingodb/compiler/Dialect/DB/IR/DBOps.td:51-158).

Logical types map onto accelerator-friendly physical representations:

  BOOL          -> bool_
  INT           -> int32
  BIGINT        -> int64
  FLOAT         -> float32
  DOUBLE        -> float64
  DECIMAL(p,s)  -> int64 scaled by 10**s  (reference uses i128; we restrict p<=18
                   and accumulate wide sums in paired limbs where needed)
  DATE          -> int32 days since epoch
  TIMESTAMP     -> int64 microseconds since epoch
  INTERVAL      -> int32 months (unit=MONTH) or int64 microseconds (unit=DAYTIME)
  STRING/CHAR   -> int32 dictionary codes; the per-column dictionary is sorted so
                   code order == lexicographic order (enables ORDER BY / comparisons
                   on device without touching bytes)

Nullability is tracked in the type (like the reference's !db.nullable<T>) and
physically as a separate boolean validity tensor.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace


class K(enum.Enum):
    BOOL = "bool"
    INT = "int"  # 32-bit
    BIGINT = "bigint"  # 64-bit
    FLOAT = "float"
    DOUBLE = "double"
    DECIMAL = "decimal"
    STRING = "string"
    CHAR = "char"  # fixed width, padded semantics like the reference's db.char<N>
    DATE = "date"
    TIMESTAMP = "timestamp"
    INTERVAL = "interval"
    NULL = "null"  # type of a bare NULL literal


class IntervalUnit(enum.Enum):
    MONTH = "month"
    DAYTIME = "daytime"


@dataclass(frozen=True)
class Type:
    kind: K
    nullable: bool = False
    # decimal precision/scale; char length; interval unit
    p: int = 0
    s: int = 0
    unit: IntervalUnit | None = None

    # ---- constructors -------------------------------------------------
    @staticmethod
    def bool_(nullable=False):
        return Type(K.BOOL, nullable)

    @staticmethod
    def int_(nullable=False):
        return Type(K.INT, nullable)

    @staticmethod
    def bigint(nullable=False):
        return Type(K.BIGINT, nullable)

    @staticmethod
    def float_(nullable=False):
        return Type(K.FLOAT, nullable)

    @staticmethod
    def double(nullable=False):
        return Type(K.DOUBLE, nullable)

    @staticmethod
    def decimal(p, s, nullable=False):
        return Type(K.DECIMAL, nullable, p=p, s=s)

    @staticmethod
    def string(nullable=False):
        return Type(K.STRING, nullable)

    @staticmethod
    def char(n, nullable=False):
        return Type(K.CHAR, nullable, p=n)

    @staticmethod
    def date(nullable=False):
        return Type(K.DATE, nullable)

    @staticmethod
    def timestamp(nullable=False):
        return Type(K.TIMESTAMP, nullable)

    @staticmethod
    def interval(unit: IntervalUnit, nullable=False):
        return Type(K.INTERVAL, nullable, unit=unit)

    @staticmethod
    def null():
        return Type(K.NULL, True)

    # ---- helpers -------------------------------------------------------
    def as_nullable(self, nullable=True) -> "Type":
        if self.nullable == nullable:
            return self
        return replace(self, nullable=nullable)

    def base_eq(self, other: "Type") -> bool:
        """Equality ignoring nullability."""
        return (
            self.kind == other.kind
            and self.p == other.p
            and self.s == other.s
            and self.unit == other.unit
        )

    @property
    def is_string(self):
        return self.kind in (K.STRING, K.CHAR)

    @property
    def is_numeric(self):
        return self.kind in (K.INT, K.BIGINT, K.FLOAT, K.DOUBLE, K.DECIMAL)

    @property
    def is_integer(self):
        return self.kind in (K.INT, K.BIGINT)

    @property
    def is_float(self):
        return self.kind in (K.FLOAT, K.DOUBLE)

    def __str__(self):
        base = self.kind.value
        if self.kind == K.DECIMAL:
            base = f"decimal({self.p},{self.s})"
        elif self.kind == K.CHAR:
            base = f"char({self.p})"
        elif self.kind == K.INTERVAL:
            base = f"interval<{self.unit.value}>"
        if self.nullable:
            base += "?"
        return base


def common_numeric(a: Type, b: Type) -> Type:
    """Result type for arithmetic/comparison coercion of two numeric (or date-ish)
    operands, following the reference's type coercion (frontend_type.cpp)."""
    nullable = a.nullable or b.nullable
    ka, kb = a.kind, b.kind
    if K.DOUBLE in (ka, kb):
        return Type.double(nullable)
    if K.FLOAT in (ka, kb):
        # float + decimal/int64 -> double for safety
        if K.DECIMAL in (ka, kb) or K.BIGINT in (ka, kb):
            return Type.double(nullable)
        return Type.float_(nullable)
    if K.DECIMAL in (ka, kb):
        da = a if ka == K.DECIMAL else Type.decimal(10 if ka == K.INT else 19, 0)
        db_ = b if kb == K.DECIMAL else Type.decimal(10 if kb == K.INT else 19, 0)
        s = max(da.s, db_.s)
        int_digits = max(da.p - da.s, db_.p - db_.s)
        return Type.decimal(min(int_digits + s, 38), s, nullable)
    if K.BIGINT in (ka, kb):
        return Type.bigint(nullable)
    return Type.int_(nullable)
