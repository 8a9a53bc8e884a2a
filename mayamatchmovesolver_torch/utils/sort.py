"""Natural ('human') sorting.

Counterpart of the reference's sort utility
(ref: python/mmSolver/utils/sort.py:33-58 sort_strings_with_digits).

Port of mayamatchmovesolver_tpu/utils/sort.py: a copy of the reference's
host code.
"""

import re

__all__ = ["sort_strings_with_digits"]

_NUM_RE = re.compile(r"(\d+)")


def _key(text):
    return [
        int(tok) if tok.isdigit() else tok.lower()
        for tok in _NUM_RE.split(str(text))
    ]


def sort_strings_with_digits(items):
    """Sort so 'name2' comes before 'name10'
    (ref: utils/sort.py:37)."""
    return sorted(items, key=_key)
