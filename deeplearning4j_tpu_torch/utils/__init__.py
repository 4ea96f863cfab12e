"""Misc utilities (counterpart of the JAX package's ``utils``).

Reference analogs: ``org.deeplearning4j.util.CrashReportingUtil`` (crash
dump reports with a memory breakdown), ``NetworkUtils``.
"""

from __future__ import annotations

import platform
import sys
import traceback
from typing import Any, Dict, Optional


def _tree_bytes(tree) -> int:
    from ..common.debug import named_tensors

    return sum(t.numel() * t.element_size() for _, t in named_tensors(tree))


def model_memory_report(model) -> Dict[str, Any]:
    """Parameter/state memory breakdown (CrashReportingUtil's report body)."""
    report = {"class": type(model).__name__}
    for attr in ("params_", "updater_state", "bn_state"):
        if hasattr(model, attr):
            report[f"{attr}_bytes"] = _tree_bytes(getattr(model, attr))
    report["total_bytes"] = sum(v for k, v in report.items() if k.endswith("_bytes"))
    return report


def write_crash_dump(model, error: BaseException, path: str = "tdl-crash.txt") -> str:
    """CrashReportingUtil.writeMemoryCrashDump parity: environment + model
    memory breakdown + traceback to a file for post-mortem. The environment
    lines name torch, its CUDA and the model's device (the JAX package
    names jax, its backend and its devices)."""
    import torch

    device = getattr(model, "device", None)
    cards = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
             if torch.cuda.is_available() else [])
    lines = [
        "deeplearning4j_tpu_torch crash report",
        f"python: {sys.version.split()[0]}  platform: {platform.platform()}",
        f"torch: {torch.__version__}  cuda: {torch.version.cuda}  device: {device}",
        f"cards: {cards}",
        "",
        f"error: {type(error).__name__}: {error}",
        "".join(traceback.format_exception(type(error), error, error.__traceback__)),
        "",
        "model memory:",
    ]
    try:
        for k, v in model_memory_report(model).items():
            lines.append(f"  {k}: {v}")
    except Exception as e:  # report must never fail the crash path
        lines.append(f"  (memory report failed: {e})")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def set_learning_rate(model, lr: float) -> None:
    """NetworkUtils.setLearningRate: adjust the updater lr mid-training. The
    port's step reads the updater at every call, so the next step uses it
    (there is no compiled step to drop, as the JAX package must)."""
    if hasattr(model.conf.updater, "learning_rate"):
        model.conf.updater.learning_rate = lr


def get_learning_rate(model) -> Optional[float]:
    return getattr(model.conf.updater, "learning_rate", None)
