"""picaso_tpu_torch: the PyTorch + CUDA port of picaso_tpu.

The JAX package ``picaso_tpu`` is the reference; this package mirrors it
path for path (``opacities/db.py`` <-> ``opacities/db.py``, ``rt/toon.py``
<-> ``rt/toon.py``) so each module is held against its namesake.  It
imports torch and numpy only: never jax, picaso_tpu or pandas.

Device and dtype policy: float64 on the CPU (used by the tests, against the
JAX package in x64 mode) and float32 on CUDA (the production path, where
the hand-written kernels in ``csrc/`` run).  Every function takes its
device from its tensor arguments or an explicit ``device=``; the functions
that build data from nothing (``pipeline.build_problem``, the grid
factories, the loader, ``convert``) default to ``'cuda'`` and raise where
there is no card.
"""

import torch

__version__ = '0.1.0'

# TF32 keeps ~3 decimal digits; the port's f32 contract (kernels against
# their plain twins, the forward against the f64 oracle) assumes full
# float32 products, so both switches are set off explicitly here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_EXP_CLIP = 35.0    # rt/toon.py: overflow guard on lamda*dtau (f64)
_EXP_CLIP32 = 10.0  # f32 analog (see picaso_tpu/rt/toon.py:43-52)


def default_dtype(device):
    """float64 on the CPU, float32 on CUDA."""
    return (torch.float64 if torch.device(device).type == 'cpu'
            else torch.float32)


def checked_device(device):
    """``torch.device(device)``; raises for a CUDA device on a machine
    without one.  The data-building entry points default to ``'cuda'`` and
    never fall back to the CPU: the caller asks for ``device='cpu'``."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{device} requested but no CUDA device is '
                           f'available; pass device="cpu" to run on the CPU')
    return device


def _exp_clip(dtype):
    return _EXP_CLIP32 if dtype == torch.float32 else _EXP_CLIP


__all__ = ['default_dtype', 'checked_device', '__version__']
