"""Per-structure maxima as order keys, shared by K9, K1's blur epilogues and
the simulation's scale-and-clamp pass.

A max key is a uint32 (held in an int32 tensor, one per structure) that
orders as the floats do: -0.0 below +0.0, every NaN above all, so that
``torch.amax``'s NaN wins. The kernels merge a max with an integer
``atomicMax`` on keys, which gives the same key in any order; key 0 is
below every float ("no value yet"). These are the plain PyTorch forms of
``csrc/common.cuh``'s ``mad_max_key``, ``mad_key_value`` and
``mad_norm_divisor``.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_SIGN = 0x80000000
_NAN_KEY = 0xFFFFFFFF
_QUIET_NAN = 0x7FC00000


def new_keys(m: int, device) -> torch.Tensor:
    """m empty keys (0: below every float)."""
    return torch.zeros(m, dtype=torch.int32, device=device)


def _unsigned(keys: torch.Tensor) -> torch.Tensor:
    return keys.to(torch.int64) & _MASK


def _signed(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u >= _SIGN, u - (1 << 32), u).to(torch.int32)


def keys_of(vol: torch.Tensor) -> torch.Tensor:
    """The max key of each leading slice of a float32 tensor, as int64
    values in [0, 2^32)."""
    flat = vol.reshape(vol.shape[0], -1)
    bits = flat.contiguous().view(torch.int32).to(torch.int64) & _MASK
    key = torch.where(bits >= _SIGN, _MASK - bits, bits | _SIGN)
    key = torch.where(torch.isnan(flat), torch.full_like(key, _NAN_KEY), key)
    return key.amax(dim=1)


def merge_(keys: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """keys[s] = max(keys[s], max key of vol[s]), in place."""
    keys.copy_(_signed(torch.maximum(_unsigned(keys), keys_of(vol))))
    return keys


def values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 max of each key (a NaN key: the quiet NaN)."""
    u = _unsigned(keys)
    bits = torch.where(u >= _SIGN, u & 0x7FFFFFFF, _MASK - u)
    bits = torch.where(u == _NAN_KEY, torch.full_like(bits, _QUIET_NAN),
                       bits)
    return _signed(bits).view(torch.float32)


def divisors(keys: torch.Tensor) -> torch.Tensor:
    """max(m, 1e-30) of each key's max, as torch.clamp(min=1e-30) gives it
    (NaN kept)."""
    return torch.clamp(values(keys), min=1e-30)
