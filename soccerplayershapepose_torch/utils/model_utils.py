"""Small model and dataset utilities.

Counterpart of ``soccerplayershapepose_tpu/utils/model_utils.py``:

* :func:`count_parameters`: the number of trainable scalars of a module
  (or of a mapping of arrays);
* :func:`random_select_train_set`: a random train split of the game
  folders, the same ``np.random.RandomState`` draw as the JAX package's,
  written as ``train_set.xml`` (a JSON list).
"""

from __future__ import annotations

import os
from typing import List, Mapping, Union

import numpy as np
from torch import nn

from soccerplayershapepose_torch.io.formats import write_json_xml


def count_parameters(params: Union[nn.Module, Mapping]) -> int:
    """Scalars in a module's trainable parameters, or in every array of a
    (nested) mapping."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters() if p.requires_grad)
    return sum(count_parameters(v) if isinstance(v, Mapping)
               else int(np.prod(np.shape(v))) for v in params.values())


def random_select_train_set(dataset_root: str, out_path: str,
                            train_fraction: float = 0.8,
                            seed: int = 0) -> List[str]:
    """Pick a random train subset of the game folders under
    ``dataset_root`` and write it to ``out_path``."""
    games = sorted(g for g in os.listdir(dataset_root)
                   if os.path.isdir(os.path.join(dataset_root, g)))
    rng = np.random.RandomState(seed)
    n_train = max(1, int(round(len(games) * train_fraction)))
    picked = sorted(rng.permutation(games)[:n_train].tolist())
    write_json_xml(out_path, picked)
    return picked
