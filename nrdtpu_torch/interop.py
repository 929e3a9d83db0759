"""Carry state and frame constants across from the JAX package, with no JAX import.

The JAX Engine's state and constants arrive as numpy arrays (`np.asarray` of each leaf). A
JAX bfloat16 array arrives as a numpy array whose dtype name is "bfloat16"; it is moved bit
for bit through uint16 -> torch.int16 -> torch.bfloat16.

Frame constants stay on the host in the port: 0-d values become Python numbers and vectors
or matrices stay float32 numpy arrays. They enter the torch glue as scalars and the hand
kernels as launch arguments, so no frame constant is copied to the device.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(state: dict, device="cpu") -> dict:
    """The JAX Engine's state (numpy leaves) as the port's state on `device`."""
    return {k: tensor_from_numpy(v, device).clone() for k, v in state.items()}


def state_rows(state: dict, rank: int, n: int, device="cpu") -> dict:
    """One rank's port state of an n-rank row mesh from a JAX Engine's whole state (numpy
    leaves): the rank's band of rows of every plane, so that a sharded port run can start from
    the JAX state."""
    out = {}
    for k, v in state.items():
        t = tensor_from_numpy(v, device)
        if t.dim() >= 2:
            if t.shape[0] % n:
                raise ValueError(f"{k}: {t.shape[0]} rows do not split into {n} bands")
            band = t.shape[0] // n
            t = t[rank * band:(rank + 1) * band]
        out[k] = t.clone()
    return out


def consts_from_numpy(consts: dict) -> dict:
    """Shared (`sc`) or denoiser (`dc`) frame constants in the port's host form."""
    out = {}
    for k, v in consts.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = int(a) if np.issubdtype(a.dtype, np.integer) else float(a)
        else:
            out[k] = a.astype(np.float32)
    return out


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """float32 numpy copy of a port tensor (bf16 widened exactly)."""
    return t.detach().to("cpu", torch.float32).numpy()
