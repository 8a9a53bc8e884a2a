"""The lens models the ST-map tests use: the parameter sets of
tests/test_ops/test_stmap.py::_all_models, as (class name, parameters)
for either package, and how those tests read the program's spans in a
profiler capture.  Imports nothing of jax, so the tests that run on the
card can share it."""

FILM_BACK = dict(width_cm=3.6, height_cm=2.4, offset_x_cm=0.05,
                 offset_y_cm=-0.02)

MODELS = {
    "classic": ("TdeClassic", dict(
        distortion=0.15, anamorphic_squeeze=1.05, curvature_x=0.02,
        curvature_y=-0.01, quartic_distortion=0.03)),
    "radial_deg4": ("TdeRadialStdDeg4", dict(
        degree2_distortion=0.12, degree2_u=0.01, degree2_v=-0.02,
        degree4_distortion=0.04, degree4_u=-0.005, degree4_v=0.008,
        cylindric_direction=25.0, cylindric_bending=0.1)),
    "anamorphic_deg4": ("TdeAnamorphicStdDeg4", dict(
        degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
        degree2_cy22=-0.01, degree4_cx04=0.01, degree4_cy04=-0.005,
        degree4_cx24=0.004, degree4_cy24=0.002, degree4_cx44=-0.003,
        degree4_cy44=0.001, lens_rotation=4.0, squeeze_x=1.1,
        squeeze_y=0.95)),
    "anamorphic_deg4_rescaled": ("TdeAnamorphicStdDeg4Rescaled", dict(
        degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
        degree2_cy22=-0.01, degree4_cx04=0.01, degree4_cy04=-0.005,
        lens_rotation=-3.0, squeeze_x=1.05, squeeze_y=1.0, rescale=1.1)),
}


# Parameters that are no distortion coefficients: scaling them toward 0
# makes no weaker lens.
NEUTRAL = ("anamorphic_squeeze", "squeeze_x", "squeeze_y", "rescale",
           "lens_rotation", "cylindric_direction", "cylindric_bending")


def weaker(model, factor):
    """`model` with every distortion coefficient scaled by `factor`."""
    return type(model)(**{k: (v if k in NEUTRAL else v * factor)
                          for k, v in vars(model).items()})


def torch_model(name, device="cpu"):
    """(model, film back) of MODELS[name] in the port, float32."""
    import torch

    import mayamatchmovesolver_torch.models as t_models

    cls_name, params = MODELS[name]
    kw = dict(device=device, dtype=torch.float32)
    return (getattr(t_models, cls_name).create(**params, **kw),
            t_models.FilmBack.create(**FILM_BACK, **kw))


def program_ranges(events):
    """(span, the span it is nested in or None) of each host range
    "mmsolver.<span>" among torch.profiler events, in the order they
    opened."""
    from torch.autograd import DeviceType

    def span(event):
        while event is not None and not event.name.startswith("mmsolver."):
            event = event.cpu_parent
        return None if event is None else event.name[len("mmsolver."):]

    ranges = sorted((e for e in events if e.device_type == DeviceType.CPU
                     and e.name.startswith("mmsolver.")),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    return [(span(e), span(e.cpu_parent)) for e in ranges]
