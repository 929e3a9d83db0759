"""State storage types - counterpart of `nrdtpu/config.py`.

The port has no implementation switch: the device of the tensors decides. A CPU tensor takes
each kernel's plain PyTorch version, a CUDA tensor takes the hand-written kernel.
"""

from __future__ import annotations


def requantize_state(old_state: dict, new_state: dict) -> dict:
    """Cast each carried plane back to its declared storage dtype (bf16 histories are the
    RGBA16f-history analogue of Reblur.cpp:37-64; compute runs in float32)."""
    return {k: (v.to(old_state[k].dtype) if k in old_state else v)
            for k, v in new_state.items()}
