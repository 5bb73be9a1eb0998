"""Experiment directory management (port of
``stac_st_tpu/config/experiment.py``; reference
``sb.create_experiment_directory``).

Creates the output folder, saves the hparams file and the overrides, and
an environment snapshot, so a saved experiment reloads from its own config
(``serving.STEngine.from_saved_experiment``). ``env.json`` records the
torch and CUDA versions and the card's name where there is one.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from typing import Any, Dict, Optional

import torch
import yaml

__all__ = ["create_experiment_directory"]


def create_experiment_directory(
    experiment_directory: str,
    hyperparams_to_save: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> str:
    os.makedirs(experiment_directory, exist_ok=True)

    if hyperparams_to_save is not None and os.path.isfile(hyperparams_to_save):
        shutil.copyfile(
            hyperparams_to_save,
            os.path.join(experiment_directory, "hyperparams.yaml"),
        )
    if overrides:
        with open(os.path.join(experiment_directory, "overrides.yaml"), "w") as f:
            yaml.safe_dump(
                {k: v for k, v in overrides.items()}, f, sort_keys=False
            )

    env = {
        "argv": sys.argv,
        "python": sys.version,
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if torch.cuda.is_available() else []),
    }
    with open(os.path.join(experiment_directory, "env.json"), "w") as f:
        json.dump(env, f, indent=2)
    return experiment_directory
