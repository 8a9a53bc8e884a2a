"""Small helpers of the clients' comparisons."""

import math
import random

import torch


def worst(a, b):
    """The larger of two readings; NaN if either is NaN, so that a
    comparison never hides one."""
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return max(a, b)


def max_abs(a, b):
    """max |a - b| over all elements, in float64, NaN if any is NaN."""
    d = torch.abs(a.to(torch.float64) - b.to(torch.float64))
    if bool(torch.isnan(d).any()):
        return math.nan
    return float(d.max())


def order(population, seed):
    """The indices below `population` in an order drawn from the seed on
    the host (the same for any device)."""
    g = torch.Generator()
    g.manual_seed(seed % 2**63)
    return torch.randperm(population, generator=g).tolist()


def log_ratio(a, b):
    """|ln(a / b)| of two positive readings, NaN otherwise."""
    if not (a > 0.0 and b > 0.0) or math.isinf(a) or math.isinf(b):
        return math.nan
    return abs(math.log(a / b))


class Reservoir:
    """A sample of `count` items, each item of a stream of unknown length
    as likely as any other to be in it (Vitter's algorithm R), drawn
    from the seed on the host."""

    def __init__(self, count, seed):
        self.count = count
        self.seed = seed
        self.clear()

    def clear(self):
        self.items = []
        self.offered = 0
        self.rng = random.Random(self.seed)

    def offer(self, item):
        if len(self.items) < self.count:
            self.items.append(item)
        else:
            slot = self.rng.randrange(self.offered + 1)
            if slot < self.count:
                self.items[slot] = item
        self.offered += 1

    def __iter__(self):
        return iter(sorted(self.items, key=lambda item: item[0]))

    def __len__(self):
        return len(self.items)
