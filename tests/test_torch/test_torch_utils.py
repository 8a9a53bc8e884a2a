"""Agreement of the port's host utilities with the JAX package's.

The port copies nine jax-free modules of the reference's utils/ (sort,
converttypes, event, time, imageseq, smooth, animcurve, config, logger).
Here:

  * every case of the reference's own tests of those modules
    (tests/test_utils: the config and logger cases, the animcurve, time,
    event, sort, converttypes and imageseq cases, the smooth cases) runs
    twice: as written, and pointed at the port (_torch_reference_cases);
  * seeded inputs through both packages' functions give equal results
    (the modules are copies: exact equality, at 1e-10 for floats);
  * every public name of the reference's modules exists in the port;
  * `import mayamatchmovesolver_torch` loads the port's config, as the
    reference's package loads its own.
"""

import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_reference_cases import REPO, port_cases, public_names

TOL = 1e-10

UTILS = ("sort", "converttypes", "event", "time", "imageseq", "smooth",
         "animcurve", "config", "logger")

# The reference's cases of the nine modules, by file.
CASES = {
    "tests/test_utils/test_config_logging.py": (
        "test_config_defaults",
        "test_config_json_layer_overrides_defaults",
        "test_config_env_wins_over_json",
        "test_config_layer_order_first_path_wins",
        "test_config_bad_json_is_skipped",
        "test_log_levels_mirror_reference_enum",
        "test_set_log_level_filters_output",
    ),
    "tests/test_utils/test_misc_utils.py": (
        "test_animcurve_sample_and_euler_filter",
        "test_time_frame_ranges",
        "test_time_keyframe_times",
        "test_event_registry",
        "test_sort_strings_with_digits",
        "test_converttypes",
        "test_imageseq",
    ),
    "tests/test_utils/test_smooth_kalman.py": (
        "test_smooth_noop_below_width_one",
        "test_average_smooth_reduces_variance",
        "test_gaussian_smooth_constant_preserved",
        "test_fourier_smooth_filters",
    ),
}


def _jax_cases():
    out = []
    for path, names in CASES.items():
        module = importlib.import_module(
            path[:-3].replace("/", "."))
        stem = path.rsplit("/", 1)[1][:-3]
        out += [pytest.param(getattr(module, n), id="%s::%s" % (stem, n))
                for n in names]
    return out


def _port_cases():
    out = []
    for path, names in CASES.items():
        out += port_cases(path, names)
    return out


@pytest.fixture
def _clean_env(monkeypatch):
    """The reference's fixture of the same name
    (tests/test_utils/test_config_logging.py)."""
    monkeypatch.delenv("MMSOLVER_TPU_CONFIG_PATH", raising=False)
    monkeypatch.delenv("MMSOLVER_TPU_SOLVER_DEFAULT_SOLVER",
                       raising=False)
    return monkeypatch


def _run(case, request):
    kwargs = {name: request.getfixturevalue(name)
              for name in inspect.signature(case).parameters}
    case(**kwargs)


@pytest.mark.parametrize("case", _jax_cases())
def test_reference_utils_case_as_written(case, request):
    _run(case, request)


@pytest.mark.parametrize("case", _port_cases())
def test_reference_utils_case_on_the_port(case, request):
    _run(case, request)


def _modules(name):
    return (importlib.import_module("mayamatchmovesolver_tpu.utils." + name),
            importlib.import_module("mayamatchmovesolver_torch.utils." + name))


@pytest.mark.parametrize("smooth_type", ["average", "gaussian", "fourier"])
@pytest.mark.parametrize("width", [1.0, 2.0, 3.5, 6.0])
def test_smooth_matches(smooth_type, width):
    j_smooth, t_smooth = _modules("smooth")
    values = np.random.RandomState(int(width * 10)).normal(0.0, 1.0, 40)
    for filtr in ((None, "triangle", "box") if smooth_type == "fourier"
                  else (None,)):
        want = j_smooth.smooth(smooth_type, values, width, filtr=filtr)
        got = t_smooth.smooth(smooth_type, values, width, filtr=filtr)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_animcurve_matches():
    j_curve, t_curve = _modules("animcurve")
    rng = np.random.RandomState(3)
    times = rng.permutation(np.arange(1, 30, 3)).astype(float)
    values = rng.uniform(-2.0, 2.0, times.size)
    frames = np.linspace(-2.0, 35.0, 75)
    np.testing.assert_allclose(
        t_curve.create_anim_curve(times, values).sample(frames),
        j_curve.create_anim_curve(times, values).sample(frames),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        t_curve.AnimCurve(times, values).to_dense((1, 30)),
        j_curve.AnimCurve(times, values).to_dense((1, 30)),
        rtol=0, atol=TOL)
    angles = np.cumsum(rng.uniform(-170.0, 170.0, (3, 50)), axis=-1)
    wrapped = (angles + 180.0) % 360.0 - 180.0
    np.testing.assert_allclose(t_curve.euler_filter_array(wrapped),
                               j_curve.euler_filter_array(wrapped),
                               rtol=0, atol=TOL)
    for prev, value in rng.uniform(-720.0, 720.0, (20, 2)):
        assert t_curve.euler_filter_value(prev, value) == (
            j_curve.euler_filter_value(prev, value))


def test_converttypes_and_sort_match():
    j_ct, t_ct = _modules("converttypes")
    j_sort, t_sort = _modules("sort")
    rng = np.random.RandomState(5)
    for _ in range(20):
        frames = sorted(set(rng.randint(990, 1030, rng.randint(0, 15))))
        text = j_ct.int_list_to_string(frames)
        assert t_ct.int_list_to_string(frames) == text
        assert t_ct.string_to_int_list(text) == j_ct.string_to_int_list(
            text)
    for word in j_ct.TRUE_WORDS + j_ct.FALSE_WORDS:
        assert t_ct.string_to_boolean(word.upper()) == (
            j_ct.string_to_boolean(word.upper()))
    names = ["shot%d_v%d" % tuple(rng.randint(0, 120, 2)) for _ in range(30)]
    assert t_sort.sort_strings_with_digits(names) == (
        j_sort.sort_strings_with_digits(names))


def test_imageseq_matches(tmp_path):
    j_seq, t_seq = _modules("imageseq")
    for f in (7, 8, 9, 12):
        (tmp_path / ("plate_v2.%05d.exr" % f)).write_bytes(b"")
    path = str(tmp_path / "plate_v2.00008.exr")
    assert t_seq.split_image_sequence_path(path) == (
        j_seq.split_image_sequence_path(path))
    for style in (t_seq.IMAGE_SEQ_FORMAT_STYLE_MAYA,
                  t_seq.IMAGE_SEQ_FORMAT_STYLE_HASH_PADDED,
                  t_seq.IMAGE_SEQ_FORMAT_STYLE_PRINTF,
                  t_seq.IMAGE_SEQ_FORMAT_STYLE_FIRST_FRAME):
        got = t_seq.expand_image_sequence_path(path, style)
        assert got == j_seq.expand_image_sequence_path(path, style)
        assert t_seq.frame_path(got[0], 11) == j_seq.frame_path(got[0], 11)


def test_config_and_logger_read_one_file(monkeypatch, tmp_path):
    """One mmsolver_tpu.json under MMSOLVER_TPU_CONFIG_PATH drives both
    packages: same keys, same values, same log level."""
    j_config, t_config = _modules("config")
    j_logger, t_logger = _modules("logger")
    assert t_config.CONFIG_PATH_VAR == j_config.CONFIG_PATH_VAR
    (tmp_path / "mmsolver_tpu.json").write_text(
        '{"solver": {"default_dtype": "float64"}, '
        '"logging": {"level": "warning"}}')
    monkeypatch.setenv(j_config.CONFIG_PATH_VAR, str(tmp_path))
    for key in ("solver/default_dtype", "solver/default_solver",
                "logging/level", "no/such"):
        assert t_config.get(key, "x") == j_config.get(key, "x")
    want = j_logger.get_logger("mmtpu_agreement_jax").level
    got = t_logger.get_logger("mmtpu_agreement_torch").level
    assert got == want == 30
    assert dict(t_logger.LOG_LEVEL_NAME_TO_VALUE_MAP) == {
        k: int(v) for k, v in j_logger.LOG_LEVEL_NAME_TO_VALUE_MAP.items()}


def test_time_and_event_match():
    j_time, t_time = _modules("time")
    for mode, args in ((j_time.FRAME_RANGE_MODE_CUSTOM_VALUE, (3, 9)),):
        assert t_time.get_frame_range(mode, *args) == (
            j_time.get_frame_range(mode, *args))
    assert t_time.convert_frame_range_to_frame_list((4, 11)) == (
        j_time.convert_frame_range_to_frame_list((4, 11)))
    j_event, t_event = _modules("event")
    got, want = [], []
    t_event.clear_event_registry()
    t_event.add_function_to_event("e", lambda **kw: got.append(kw))
    j_event.add_function_to_event("e", lambda **kw: want.append(kw))
    try:
        assert t_event.trigger_event("e", v=1) == 1
        assert j_event.trigger_event("e", v=1) == 1
        assert got == want
    finally:
        t_event.clear_event_registry()
        j_event.clear_event_registry()


@pytest.mark.parametrize("name", UTILS + ("raytrace",))
def test_utils_module_keeps_every_public_name(name):
    j_mod, t_mod = _modules(name)
    assert public_names(j_mod) <= set(vars(t_mod)), (
        public_names(j_mod) - set(vars(t_mod)))


def test_port_package_loads_its_config():
    """The top-level package imports utils.config, as the reference's
    __init__ does, and nothing of the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import mayamatchmovesolver_torch as m\n"
        "assert m._config is sys.modules["
        "'mayamatchmovesolver_torch.utils.config']\n"
        "assert m._config.get('logging/level') == 'info'\n"
        "assert not [n for n in sys.modules "
        "if n.startswith('mayamatchmovesolver_tpu')]\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MMSOLVER_TPU_")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
