"""The benchmark's plain reference of the spectrum path, in float64.

Frozen copies of the port's plain modules (each file names its source and
commit), the opacity gather on the raw table (:mod:`.opacity`), the whole
spectrum from the benchmark's raw inputs (:mod:`.spectrum`), and the
operation and byte counts the rooflines divide (:mod:`.counts`).  It
imports torch and numpy only: never jax, picaso_tpu or picaso_tpu_torch.
"""

import torch

_EXP_CLIP = 35.0    # toon.py: overflow guard on lamda*dtau (f64)
_EXP_CLIP32 = 10.0  # the f32 analog


def _exp_clip(dtype):
    return _EXP_CLIP32 if dtype == torch.float32 else _EXP_CLIP
