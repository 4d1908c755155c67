"""Date/timestamp kernels (vectorized civil-calendar math).

Equivalent of the reference DateRuntime
(reference: src/runtime/DateRuntime.cpp — extract year/month/day, add/sub
month intervals, date_trunc). The reference calls scalar C++ helpers per
tuple; here everything is branch-free integer array math over whole columns
(Howard Hinnant's civil-calendar algorithms), so it runs as whole-column tensor ops with the rest
of the stage.
"""

from __future__ import annotations

import numpy as np

from . import backend as be
from .backend import xnp as jnp

US_PER_DAY = 86_400_000_000


def civil_from_days(z):
    """days since 1970-01-01 -> (year, month, day), vectorized."""
    z = be.astype(z, jnp.int64) + 719468
    era = jnp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
    m = jnp.where(mp < 10, mp + 3, mp - 9)  # [1, 12]
    y = jnp.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y, m, d):
    """(year, month, day) -> days since 1970-01-01, vectorized."""
    y = be.astype(y, jnp.int64) - be.astype(m <= 2, jnp.int64)
    era = jnp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400  # [0, 399]
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def last_day_of_month(y, m):
    is_leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    lengths = jnp.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], jnp.int64)
    base = jnp.take(lengths, m - 1)
    return jnp.where((m == 2) & is_leap, 29, base)


def add_months_days(days, months):
    """Shift a day-resolution date by N months, clamping the day-of-month
    (SQL semantics: Jan 31 + 1 month = Feb 28/29)."""
    y, m, d = civil_from_days(days)
    total = (y * 12 + (m - 1)) + months
    y2 = total // 12
    m2 = total - y2 * 12 + 1
    d2 = jnp.minimum(d, last_day_of_month(y2, m2))
    return days_from_civil(y2, m2, d2)


def extract(part: str, data, is_timestamp: bool):
    """EXTRACT(part FROM date/timestamp) -> int64 column."""
    if is_timestamp:
        days = jnp.floor_divide(data, US_PER_DAY)
        us = data - days * US_PER_DAY
    else:
        days = be.astype(data, jnp.int64)
        us = None
    if part in ("year", "month", "day", "quarter", "decade", "century"):
        y, m, d = civil_from_days(days)
        if part == "year":
            return y
        if part == "month":
            return m
        if part == "day":
            return d
        if part == "quarter":
            return (m - 1) // 3 + 1
        if part == "decade":
            return y // 10
        if part == "century":
            return (y + 99) // 100
    if part == "dow":  # 0=Sunday
        return (days + 4) % 7
    if part == "doy":
        y, m, d = civil_from_days(days)
        return (days - days_from_civil(y, jnp.ones_like(y), jnp.ones_like(y))) + 1
    if part == "epoch":
        if us is None:
            return days * 86400
        return data // 1_000_000
    if us is None:
        # hour/minute/second of a pure date are 0
        return jnp.zeros_like(days)
    if part == "hour":
        return us // 3_600_000_000
    if part == "minute":
        return (us // 60_000_000) % 60
    if part == "second":
        return (us // 1_000_000) % 60
    if part == "millisecond":
        return (us // 1000) % 60_000
    if part == "microsecond":
        return us % 60_000_000
    raise NotImplementedError(f"extract {part}")


def date_trunc(part: str, data, is_timestamp: bool):
    if is_timestamp:
        days = jnp.floor_divide(data, US_PER_DAY)
        us = data - days * US_PER_DAY
    else:
        days = be.astype(data, jnp.int64)
        us = None
    y, m, d = civil_from_days(days)
    one = jnp.ones_like(y)
    if part == "year":
        td = days_from_civil(y, one, one)
    elif part == "quarter":
        td = days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    elif part == "month":
        td = days_from_civil(y, m, one)
    elif part == "week":
        td = days - (days + 3) % 7  # ISO week starts Monday
    elif part == "day":
        td = days
    else:
        if us is None:
            td = days
        else:
            mult = {"hour": 3_600_000_000, "minute": 60_000_000, "second": 1_000_000}[part]
            return days * US_PER_DAY + (us // mult) * mult
    if is_timestamp:
        return td * US_PER_DAY
    return be.astype(td, be.dt(data))
