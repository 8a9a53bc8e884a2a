"""Event registry.

Counterpart of the reference's event utility
(ref: python/mmSolver/utils/event.py:68-200 — add_function_to_event,
trigger_event, BlockedEvents).  No Maya deferred execution exists
here, so `deferred` callbacks are queued and flushed explicitly.

Port of mayamatchmovesolver_tpu/utils/event.py: a copy of the
reference's host code.
"""

import collections

__all__ = [
    "add_function_to_event",
    "trigger_event",
    "flush_deferred",
    "BlockedEvents",
    "clear_event_registry",
]

_REGISTRY = collections.defaultdict(list)  # name -> [(func, deferred)]
_BLOCKED = []  # stack of sets of blocked event names
_DEFERRED_QUEUE = []


def add_function_to_event(event_name, func, deferred=False):
    """(ref: utils/event.py:155.)"""
    assert callable(func)
    _REGISTRY[event_name].append((func, bool(deferred)))


def trigger_event(event_name, **kwargs):
    """Run every function registered for the event
    (ref: utils/event.py:97).  Blocked events are dropped; deferred
    callbacks go to the queue for flush_deferred()."""
    for blocked in _BLOCKED:
        if event_name in blocked:
            return 0
    count = 0
    for func, deferred in _REGISTRY.get(event_name, ()):
        if deferred:
            _DEFERRED_QUEUE.append((func, kwargs))
        else:
            func(**kwargs)
        count += 1
    return count


def flush_deferred():
    """Run queued deferred callbacks (the reference uses Maya's
    executeDeferred; here flushing is explicit)."""
    queue, _DEFERRED_QUEUE[:] = list(_DEFERRED_QUEUE), []
    for func, kwargs in queue:
        func(**kwargs)
    return len(queue)


class BlockedEvents:
    """Context manager suppressing a set of events
    (ref: utils/event.py:68)."""

    def __init__(self, event_names):
        self._names = set(event_names)

    def __enter__(self):
        _BLOCKED.append(self._names)
        return self

    def __exit__(self, exc_type, exc, tb):
        _BLOCKED.remove(self._names)
        return False


def clear_event_registry():
    """Test helper: drop all handlers and queued callbacks."""
    _REGISTRY.clear()
    del _DEFERRED_QUEUE[:]
