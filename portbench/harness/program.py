"""The system under test: the port's trainer, built and driven as the
port's train task drives it (``svdfeature_tpu_torch/train/loop.py``,
``SVDTrainTask``: configure, load the model, the round loop of
``set_round``, ``update_all``, ``finish_round`` and ``synchronize``).

Only this module, the feed modules and the metric readers import the
port.  The checkpoint it hands back is the program's own output, read with
the benchmark's reader (harness/leaves.py).
"""

from __future__ import annotations

import importlib
import io
import pkgutil
from types import ModuleType
from typing import Dict


def kernels() -> Dict[str, ModuleType]:
    """Each hand-written kernel of the port by its id (``K1`` for
    ``portbench/kernels/k1.py``): the module and wrapper of its entry point
    (``MODULE``, ``WRAPPER``), the names its launches carry on the device
    (``NAMES``) and, for the persistent kernels, the slots of their own
    clock (``CLOCK``)."""
    pkg = importlib.import_module("portbench.kernels")
    return {m.name.upper(): importlib.import_module(f"portbench.kernels.{m.name}")
            for m in pkgutil.iter_modules(pkg.__path__)}


def wrapper(kernel: ModuleType):
    return getattr(importlib.import_module(kernel.MODULE), kernel.WRAPPER)


def launch_counts() -> Dict[str, int]:
    """The port's own launch counters of its kernel wrappers."""
    return {kid: int(getattr(wrapper(k), "launches", 0)) for kid, k in kernels().items()}


def conf_keys(cfg: dict, traffic: dict, device: str) -> Dict[str, str]:
    return {**cfg["conf"], **traffic.get("conf", {}), "device": device, "silent": "1"}


def build_trainer(conf: Dict[str, str], checkpoint: io.BytesIO):
    """The trainer of ``conf`` with its model loaded from ``checkpoint``,
    ready to train (SVDTrainTask.configure and init with ``task=1``)."""
    from svdfeature_tpu_torch.params import SVDTypeParam, svd_type
    from svdfeature_tpu_torch.solvers.registry import create_svd_trainer

    mtype = SVDTypeParam()
    for name, val in conf.items():
        mtype.set_param(name, val)
    mtype.decide_format(svd_type.AUTO_DETECT)
    trainer = create_svd_trainer(mtype)
    for name, val in conf.items():
        trainer.set_param(name, val)
    trainer.load_model(checkpoint)
    return trainer


def dataset(cfg: dict, rows: dict):
    """The program's dataset of a split in the configuration's format."""
    return importlib.import_module(f"portbench.feed.{cfg['format']}").dataset(rows)


def checkpoint(trainer) -> bytes:
    """The program's model section as it saves it after a round."""
    f = io.BytesIO()
    trainer.save_model(f)
    return f.getvalue()
