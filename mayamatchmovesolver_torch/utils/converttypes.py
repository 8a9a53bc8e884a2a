"""String <-> value conversions.

Counterpart of the reference's converttypes utility
(ref: python/mmSolver/utils/converttypes.py:37-210), most importantly
the frame-range string protocol ('1001-1101,1150') used by tools and
the CLI to pass frame lists around.

Port of mayamatchmovesolver_tpu/utils/converttypes.py: a copy of the
reference's host code.
"""

__all__ = [
    "string_to_boolean",
    "boolean_to_string",
    "string_to_int_list",
    "int_list_to_string",
    "string_to_integer",
]

TRUE_WORDS = ("1", "yes", "y", "t", "true", "on")
FALSE_WORDS = ("0", "no", "n", "f", "false", "off")


def string_to_boolean(value):
    """(ref: converttypes.py:37 stringToBoolean.)"""
    if isinstance(value, bool):
        return value
    if not isinstance(value, str):
        raise TypeError("not a string: %r" % (value,))
    v = value.strip().lower()
    if v in TRUE_WORDS:
        return True
    if v in FALSE_WORDS:
        return False
    raise ValueError("cannot convert to bool: %r" % (value,))


def boolean_to_string(value):
    """(ref: converttypes.py:57 booleanToString.)"""
    return str(bool(value))


def string_to_int_list(value):
    """Parse '1001,1003-1005,1010' into a sorted, unique int list
    (ref: converttypes.py:64 stringToIntList)."""
    if not isinstance(value, str):
        raise TypeError("not a string: %r" % (value,))
    out = set()
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        if part.isdigit():
            out.add(int(part))
            continue
        if "-" in part:
            nums = [x for x in part.split("-") if x.strip().isdigit()]
            if len(nums) > 1:
                s, e = int(nums[0]), int(nums[1])
                if s <= e:
                    out.update(range(s, e + 1))
    return sorted(out)


def int_list_to_string(value):
    """Compress [1,2,3,5] into '1-3,5'
    (ref: converttypes.py:107 intListToString)."""
    if not isinstance(value, (list, tuple)):
        raise TypeError("not a list: %r" % (value,))
    nums = sorted(set(int(v) for v in value))
    if not nums:
        return ""
    groups = []
    start = prev = nums[0]
    for n in nums[1:]:
        if n != prev + 1:
            groups.append((start, prev))
            start = n
        prev = n
    groups.append((start, prev))
    return ",".join(
        "%d" % s if s == e else "%d-%d" % (s, e) for s, e in groups
    )


def string_to_integer(value):
    """(ref: converttypes.py:152 stringToInteger.)"""
    if isinstance(value, int):
        return value
    return int(str(value).strip())
