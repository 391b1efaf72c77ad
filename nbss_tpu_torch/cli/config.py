"""YAML configs with the JAX package's surface, resolved onto the port.

Counterpart of ``nbss_tpu/cli/config.py``: objects are selected by
``class_path`` + ``init_args``, several ``--config`` files merge left to
right, and any field is overridable from argv as ``--a.b.c=value``. A class
path of the JAX package (``nbss_tpu.models.SpatialNet``) resolves to the
port's class of the same name (``nbss_tpu_torch.models.SpatialNet``), as a
string and without importing the JAX package; the reference's paths
(``models.arch.SpatialNet.SpatialNet``, ...) resolve through the same
aliases the JAX package keeps. YAML is read and written by ``cli/yamlio.py``.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, List, Optional

from nbss_tpu_torch.cli import yamlio

_JAX_PACKAGE, _PORT = "nbss_tpu.", "nbss_tpu_torch."

# reference class_path -> the JAX package's class_path (mapped onto the port below)
_ALIASES = {
    "models.arch.SpatialNet.SpatialNet": "nbss_tpu.models.SpatialNet",
    "models.arch.OnlineSpatialNet.OnlineSpatialNet": "nbss_tpu.models.OnlineSpatialNet",
    "models.arch.NBC.NBC": "nbss_tpu.models.NBC",
    "models.arch.NBC2.NBC2": "nbss_tpu.models.NBC2",
    "models.arch.blstm2_fc1.BLSTM2_FC1": "nbss_tpu.models.BLSTM2_FC1",
    "models.arch.NBSS.NBSS": "nbss_tpu.models.NBSS",
    "models.io.stft.STFT": "nbss_tpu.io.STFT",
    "models.io.norm.Norm": "nbss_tpu.io.Norm",
    "models.io.loss.Loss": "nbss_tpu.io.Loss",
    "data_loaders.sms_wsj_plus.SmsWsjPlusDataModule": "nbss_tpu.data.sms_wsj_plus.SmsWsjPlusDataModule",
    "data_loaders.whamr.WHAMRDataModule": "nbss_tpu.data.whamr.WHAMRDataModule",
    "data_loaders.spatialized_wsj0_mix.SpatializedWSJ0MixDataModule":
        "nbss_tpu.data.spatialized_wsj0_mix.SpatializedWSJ0MixDataModule",
    "data_loaders.sms_wsj.SmsWsjDataModule": "nbss_tpu.data.sms_wsj.SmsWsjDataModule",
    "data_loaders.chime3_moving.CHiME3MovingDataModule":
        "nbss_tpu.data.chime3_moving.CHiME3MovingDataModule",
    "data_loaders.libricss.LibriCSSDataModule": "nbss_tpu.data.libricss.LibriCSSDataModule",
    "data_loaders.reverb.ReverbDataModule": "nbss_tpu.data.reverb.ReverbDataModule",
    "data_loaders.spk4_wsj0_mix_sp.Spk4Wsj0mixSp":
        "nbss_tpu.data.spk4_wsj0_mix_sp.Spk4Wsj0MixSpDataModule",
}


def port_class_path(class_path: str) -> str:
    """A reference or JAX-package class path -> the port's class path."""
    class_path = _ALIASES.get(class_path, class_path)
    if class_path.startswith(_JAX_PACKAGE):
        class_path = _PORT + class_path[len(_JAX_PACKAGE):]
    return class_path


def resolve_class(class_path: str):
    path = port_class_path(class_path)
    module, name = path.rsplit(".", 1)
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if path.startswith(_PORT) and e.name and e.name.startswith(_PORT.rstrip(".")):
            raise NotImplementedError(
                f"{class_path}: {module} is not ported to nbss_tpu_torch yet") from e
        raise
    return getattr(mod, name)


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Right-biased recursive dict merge (later configs win)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def set_dotted(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"cannot override {dotted!r} through the non-dict at {k!r}")
    node[keys[-1]] = value


def parse_value(text: str) -> Any:
    """A CLI override value read as YAML ('true', '[1,2]', '0.5', 'abc'...)."""
    try:
        return yamlio.loads(text)
    except yamlio.YAMLError:
        return text


def load_configs(paths: List[str], overrides: Optional[Dict[str, Any]] = None) -> Dict:
    cfg: Dict = {}
    for p in paths:
        cfg = deep_merge(cfg, yamlio.load(p) or {})
    for dotted, value in (overrides or {}).items():
        set_dotted(cfg, dotted, value)
    return cfg


def parse_argv(argv: List[str]):
    """['fit', '--config=a.yaml', '--model.x=1', ...] ->
    (subcommand, config_paths, overrides)."""
    if not argv or argv[0].startswith("-"):
        raise ValueError("the first argument must be a subcommand (fit/validate/test/predict)")
    sub = argv[0]
    paths, overrides = [], {}
    i = 1
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected --key=value, got {arg!r}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
        else:
            key = arg[2:]
            i += 1
            if i >= len(argv):
                raise ValueError(f"missing value for --{key}")
            value = argv[i]
        if key == "config":
            paths.append(value)
        else:
            overrides[key] = parse_value(value)
        i += 1
    return sub, paths, overrides


def instantiate(node: Any, **extra_kwargs):
    """Recursively instantiate {'class_path': ..., 'init_args': {...}} nodes.

    Plain dicts and lists are recursed into. ``extra_kwargs`` go to the
    top-level constructor where its signature takes them and ``init_args``
    does not set them (dims known at run time, the device)."""
    if isinstance(node, dict) and "class_path" in node:
        cls = resolve_class(node["class_path"])
        kwargs = {k: instantiate(v) for k, v in (node.get("init_args") or {}).items()}
        if extra_kwargs:
            sig = inspect.signature(cls.__init__ if inspect.isclass(cls) else cls)
            for k, v in extra_kwargs.items():
                if k in sig.parameters and k not in kwargs:
                    kwargs[k] = v
        return cls(**_coerce_kwargs(cls, kwargs))
    if isinstance(node, dict):
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def _coerce_kwargs(cls, kwargs: Dict) -> Dict:
    """Lists from YAML -> tuples (the io dataclasses are frozen and hashed),
    plus the reference's spellings of the loss."""
    out = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
    if getattr(cls, "__name__", "") == "Loss":
        # reference spelling: loss_func is an import path
        if "loss_func" in out:
            out["name"] = str(out.pop("loss_func"))
        if isinstance(out.get("loss_func_kwargs"), dict):
            out["loss_func_kwargs"] = tuple(sorted(out["loss_func_kwargs"].items()))
    return out


def save_config(cfg: Dict, path: str) -> None:
    with open(path, "w") as f:
        f.write(yamlio.dumps(cfg))
