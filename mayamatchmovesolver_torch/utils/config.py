"""Layered configuration: defaults < JSON config files < environment.

Mirrors the capability of the reference's utils/config.py (502 LoC layered
JSON config search over MMSOLVER_CONFIG_PATH directories) with a simpler,
explicit API (ref: python/mmSolver/utils/config.py).

Port of mayamatchmovesolver_tpu/utils/config.py: a copy of the
reference's host code (same environment variable, file name, keys and
defaults, so one configuration file drives both packages).
"""

import json
import os

# Environment variable listing directories to search for config JSON
# files, like the reference's MMSOLVER_CONFIG_PATH
# (ref: python/mmSolver/utils/config.py).
CONFIG_PATH_VAR = "MMSOLVER_TPU_CONFIG_PATH"

_DEFAULTS = {
    # Default compute dtype for solver math on the device.  Agreement
    # tests run float64 on the CPU.
    "solver/default_dtype": "float32",
    # Default solver backend name, the reference's value kept so one
    # file serves both packages (the reference picks via
    # MMSOLVER_DEFAULT_SOLVER; ref: src/mmSolver/adjust/adjust_base.cpp:102).
    "solver/default_solver": "lm_jax",
    "logging/level": "info",
}


def config_search_paths():
    paths = os.environ.get(CONFIG_PATH_VAR, "")
    return [p for p in paths.split(os.pathsep) if p]


def _load_file_layers():
    layers = []
    for directory in config_search_paths():
        path = os.path.join(directory, "mmsolver_tpu.json")
        if os.path.isfile(path):
            try:
                with open(path, "r") as f:
                    layers.append(json.load(f))
            except (OSError, ValueError):
                continue
    return layers


def get(key, default=None):
    """Look up a config key ('section/name'), env var wins.

    Env var form: MMSOLVER_TPU_<SECTION>_<NAME> upper-cased.
    """
    env_key = "MMSOLVER_TPU_" + key.replace("/", "_").upper()
    if env_key in os.environ:
        return os.environ[env_key]
    for layer in _load_file_layers():
        value = layer
        found = True
        for part in key.split("/"):
            if isinstance(value, dict) and part in value:
                value = value[part]
            else:
                found = False
                break
        if found:
            return value
    if key in _DEFAULTS:
        return _DEFAULTS[key]
    return default
