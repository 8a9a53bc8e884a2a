"""The plain references against the program at small sizes, float64, on
the CPU: the ST map and the warp; and the sampling and the interior
that the export's check takes."""

import collections

import torch

from mmbench.common import checks
from mmbench.reference import stmap as ref_stmap

F64 = torch.float64
CPU = torch.device("cpu")


def test_reservoir_draws_every_item_alike():
    """Over many seeds each of 20 items of a stream lands in a sample of
    4 about a fifth of the time, the last as often as the first."""
    hits = collections.Counter()
    for seed in range(4000):
        r = checks.Reservoir(4, 2**31 + seed)
        for i in range(20):
            r.offer((i, None))
        assert len(r) == 4
        hits.update(i for i, _ in r)
    assert all(abs(hits[i] / 4000 - 0.2) < 0.03 for i in range(20))
    r.clear()
    assert len(r) == 0 and r.offered == 0


def test_interior_keeps_the_taps_off_the_edges():
    st = ref_stmap.stmap(0.1, (3.6, 2.4), 64, 36, "undistort", dtype=F64,
                         device=CPU)
    inside = ref_stmap.interior(st, 64, 36, 1.0)
    x, y = ref_stmap.positions(st, 64, 36)
    assert bool(inside.any()) and not bool(inside.all())
    assert float(x[inside].min()) >= 1.0 and float(x[inside].max()) <= 62.0
    assert float(y[inside].min()) >= 1.0 and float(y[inside].max()) <= 34.0


def test_stmap_and_warp_are_the_programs():
    from mayamatchmovesolver_torch import models
    from mayamatchmovesolver_torch.ops import stmap, warp

    fb = models.FilmBack.create(width_cm=3.6, height_cm=2.4, device=CPU,
                                dtype=F64)
    g = torch.Generator().manual_seed(5)
    image = torch.rand((36, 64, 4), generator=g, dtype=F64)
    for d in (0.06, 0.1):
        lens = models.TdeClassic.create(distortion=d, device=CPU, dtype=F64)
        for direction in ("undistort", "distort"):
            got = stmap.stmap_torch(lens, fb, 64, 36, direction, device=CPU,
                                    dtype=F64)
            want = ref_stmap.stmap(d, (3.6, 2.4), 64, 36, direction,
                                   dtype=F64, device=CPU)
            # the program returns its map in float32
            assert float((got.double() - want).abs().max()) < 1e-7
            st = want.float()
            assert float((warp.warp_image(image, st)
                          - ref_stmap.warp(image, st, F64)).abs().max()) \
                < 1e-12
