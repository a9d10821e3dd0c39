"""YAML config system.

The port's copy of kd_pointcloud_tpu/utils/config.py (reference cmd_args.py
+ utils/easydict.py): a YAML file maps to an attribute-access config with
the reference's postprocessing rules (cmd_args.py:15-54): dataset-name
validation against the port's own data.DATASETS, custom-lr schedule
parsing, evaluate => resume assertion.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import yaml


class Config(dict):
    """dict with attribute access (utils/easydict.py semantics)."""

    def __init__(self, d: Dict[str, Any] = None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)


def postprocess(args: Config) -> Config:
    """Validation + defaults (cmd_args.py:15-54). The reference's
    init='xavier' defaults (cmd_args.py:25-28) are accepted but not
    injected: its entry scripts never consume them, so the actual reference
    behaviour is torch's default initialisation, which the port's modules
    reproduce."""
    from ..data.datasets import DATASETS

    args.allow_less_points = bool(args.get("allow_less_points", False))
    if args.get("dataset") not in DATASETS:
        raise ValueError(f"unknown dataset {args.get('dataset')}")
    if "data_root" not in args:
        raise ValueError("config must set data_root")

    if not args.get("evaluate", False):
        if args.get("custom_lr"):
            args.lrs = [float(x) for x in args.lrs.split(",")][::-1]
            args.lr_switch_epochs = [int(x) for x in
                                     args.lr_switch_epochs.split(",")][::-1]
            if len(args.lrs) != len(args.lr_switch_epochs):
                raise ValueError("lrs and lr_switch_epochs differ in length")
            if not np.all(np.diff(args.lr_switch_epochs) < 0):
                raise ValueError("lr_switch_epochs must increase")
            args.lr = args.lrs[-1]
    elif not args.get("resume"):
        raise ValueError("evaluate=True requires resume")
    return args


def parse_args_from_yaml(yaml_path: str) -> Config:
    with open(yaml_path) as fd:
        return postprocess(Config(yaml.safe_load(fd)))
