"""Read/write user-script config files so priors can live in config templates.

Port of ``metaopt_tpu/io/converters.py``: YAML/JSON converters, so that
``~prior`` expressions can be written inside the user's own config file;
the executor rewrites that file with concrete values for each trial.

``yaml`` is imported inside the YAML converter's methods, never at module
import: a machine without PyYAML still reads and writes ``.json`` configs,
and a ``.yaml`` one raises an error that names the missing module.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def import_yaml():
    """The ``yaml`` module, or an ImportError that says what needs it."""
    try:
        import yaml
    except ImportError as err:
        raise ImportError(
            "PyYAML (module 'yaml') is not installed: YAML config files "
            "cannot be read here; write the config as .json instead"
        ) from err
    return yaml


class Converter:
    """File-format adapter: parse to a (possibly nested) dict and dump back."""

    extensions: tuple[str, ...] = ()

    def parse(self, path: str) -> Dict[str, Any]:
        raise NotImplementedError

    def generate(self, path: str, data: Dict[str, Any]) -> None:
        raise NotImplementedError


class JSONConverter(Converter):
    extensions = (".json",)

    def parse(self, path: str) -> Dict[str, Any]:
        with open(path) as f:
            return json.load(f)

    def generate(self, path: str, data: Dict[str, Any]) -> None:
        with open(path, "w") as f:
            json.dump(data, f, indent=2)


class YAMLConverter(Converter):
    extensions = (".yml", ".yaml")

    def parse(self, path: str) -> Dict[str, Any]:
        yaml = import_yaml()
        with open(path) as f:
            return yaml.safe_load(f) or {}

    def generate(self, path: str, data: Dict[str, Any]) -> None:
        yaml = import_yaml()
        with open(path, "w") as f:
            yaml.safe_dump(data, f, default_flow_style=False)


def infer_converter(path: str) -> Converter:
    ext = os.path.splitext(path)[1].lower()
    for cls in (JSONConverter, YAMLConverter):
        if ext in cls.extensions:
            return cls()
    # default to YAML, the lineage's lingua franca
    return YAMLConverter()
