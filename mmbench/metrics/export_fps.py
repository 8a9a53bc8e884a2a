"""Frames exported a second: frames completed over the window."""

from mmbench.common import readers


def read(records):
    done = readers.units(records.requests)
    return done / records.window_s if done and records.window_s > 0 else None
