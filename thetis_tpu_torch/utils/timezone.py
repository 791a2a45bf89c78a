"""Timezone helpers (re-implementation of ``thetis/timezone.py``).

Copied unchanged from ``thetis_tpu/utils/timezone.py`` (plain Python).
"""
import datetime

__all__ = ["FixedTimeZone", "epoch", "datetime_to_epoch", "epoch_to_datetime"]

epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


class FixedTimeZone(datetime.tzinfo):
    """Fixed UTC-offset timezone (ref L7-30)."""

    def __init__(self, offset, name):
        super().__init__()
        self._offset = datetime.timedelta(hours=offset)
        self._name = name

    def utcoffset(self, dt):
        return self._offset

    def tzname(self, dt):
        return self._name

    def dst(self, dt):
        return datetime.timedelta(0)


def datetime_to_epoch(t):
    """Seconds since 1970-01-01 UTC (ref L33-37)."""
    return (t - epoch).total_seconds()


def epoch_to_datetime(t):
    """Inverse of datetime_to_epoch (ref L40-42)."""
    return epoch + datetime.timedelta(seconds=t)
