"""Cron next-match engine for ScheduledCapacity patterns.

The reference converts its strongly-typed Pattern into a 5-field crontab and
asks robfig/cron for the next activation (reference:
pkg/metrics/producers/scheduledcapacity/crontabs.go:33-73). This is a
self-contained equivalent: 5 fields (minute hour day-of-month month
day-of-week), comma-separated value lists, month/weekday names, and the
standard cron rule that when BOTH day fields are restricted a day matches if
EITHER matches. next_after() returns the first matching wall-clock minute
strictly after the given time, in the given timezone.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional, Set

_MONTH_ABBREVS = {
    "jan": 1, "feb": 2, "mar": 3, "apr": 4, "may": 5, "jun": 6,
    "jul": 7, "aug": 8, "sep": 9, "oct": 10, "nov": 11, "dec": 12,
}
_MONTH_NAMES = {
    "january": 1, "february": 2, "march": 3, "april": 4, "may": 5, "june": 6,
    "july": 7, "august": 8, "september": 9, "october": 10, "november": 11,
    "december": 12,
}
_MONTHS = {**_MONTH_ABBREVS, **_MONTH_NAMES}
_WEEKDAY_ABBREVS = {
    "sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5, "sat": 6,
}
_WEEKDAY_NAMES = {
    "sunday": 0, "monday": 1, "tuesday": 2, "wednesday": 3, "thursday": 4,
    "friday": 5, "saturday": 6,
}
_WEEKDAYS = {**_WEEKDAY_ABBREVS, **_WEEKDAY_NAMES}

_FIELD_RANGES = {
    "minute": (0, 59),
    "hour": (0, 23),
    "dom": (1, 31),
    "month": (1, 12),
    "dow": (0, 7),  # 7 is accepted as Sunday
}


class CronParseError(ValueError):
    pass


def _parse_element(elem: str, field: str) -> int:
    elem = elem.strip().lower()
    if elem.isdigit():
        value = int(elem)
    elif field == "month" and elem in _MONTHS:
        value = _MONTHS[elem]
    elif field == "dow" and elem in _WEEKDAYS:
        value = _WEEKDAYS[elem]
    else:
        raise CronParseError(f"unable to parse {field} element {elem!r}")
    lo, hi = _FIELD_RANGES[field]
    if not lo <= value <= hi:
        raise CronParseError(f"{field} element {elem!r} out of range [{lo},{hi}]")
    if field == "dow" and value == 7:
        value = 0
    return value


def _parse_field(spec: Optional[str], field: str) -> Optional[Set[int]]:
    """None return means the field is a wildcard (unrestricted)."""
    if spec is None or spec.strip() == "*":
        return None
    return {_parse_element(e, field) for e in spec.split(",")}


class Cron:
    """A parsed 5-field cron schedule."""

    def __init__(
        self,
        minutes: Optional[str] = None,
        hours: Optional[str] = None,
        days: Optional[str] = None,
        months: Optional[str] = None,
        weekdays: Optional[str] = None,
    ):
        # Pattern semantics (reference: crontabs.go:44-49 and
        # metricsproducer.go Pattern docs): omitted minutes/hours mean 0,
        # omitted days/months/weekdays mean wildcard.
        self.minutes = _parse_field(minutes if minutes is not None else "0", "minute")
        self.hours = _parse_field(hours if hours is not None else "0", "hour")
        self.dom = _parse_field(days, "dom")
        self.months = _parse_field(months, "month")
        self.dow = _parse_field(weekdays, "dow")
        if self.minutes is None:
            self.minutes = set(range(0, 60))
        if self.hours is None:
            self.hours = set(range(0, 24))

    def _day_matches(self, t: datetime) -> bool:
        dow = (t.weekday() + 1) % 7  # cron numbering: Sunday=0
        if self.dom is not None and self.dow is not None:
            return t.day in self.dom or dow in self.dow
        if self.dom is not None:
            return t.day in self.dom
        if self.dow is not None:
            return dow in self.dow
        return True

    def next_after(self, t: datetime) -> datetime:
        """First matching minute strictly after t (same tzinfo as t)."""
        cur = t.replace(second=0, microsecond=0) + timedelta(minutes=1)
        # Bound the search at ~5 years of days, beyond which the schedule is
        # unsatisfiable (e.g. Feb 30).
        for _ in range(366 * 5 + 2):
            if self.months is not None and cur.month not in self.months:
                # advance to the first minute of the next month
                if cur.month == 12:
                    cur = cur.replace(
                        year=cur.year + 1, month=1, day=1, hour=0, minute=0
                    )
                else:
                    cur = cur.replace(month=cur.month + 1, day=1, hour=0, minute=0)
                continue
            if not self._day_matches(cur):
                cur = (cur + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            # within a matching day, scan hour/minute sets directly
            found = self._next_in_day(cur)
            if found is not None:
                return found
            cur = (cur + timedelta(days=1)).replace(hour=0, minute=0)
        raise CronParseError("schedule has no matching time in the next 5 years")

    def _next_in_day(self, t: datetime) -> Optional[datetime]:
        for hour in sorted(self.hours):
            if hour < t.hour:
                continue
            for minute in sorted(self.minutes):
                if hour == t.hour and minute < t.minute:
                    continue
                return t.replace(hour=hour, minute=minute)
        return None
