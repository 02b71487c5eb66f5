"""CUDA launch of the signed exponent histogram (``csrc/exp_histogram.cu``);
counterpart of the JAX package's ``exp_histogram_kernel``."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "exp_histogram"
MAX_BINS = 512                  # 8 per-warp copies in 16 KB of shared memory
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load(NAME)
    lib.exp_histogram_launch.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    lib.exp_histogram_launch.restype = _I
    return lib


def launch(vals, signs, num_bins: int) -> torch.Tensor:
    """vals int32 [G, M]; signs float32 [G, M]; ``num_bins`` <= 512.
    Returns float32 [G, num_bins]."""
    g, m = vals.shape
    for t, name in ((vals, "vals"), (signs, "signs")):
        if t.device.type != "cuda" or t.device != vals.device:
            raise ValueError(f"{name} must be on {vals.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vals.dtype != torch.int32 or signs.dtype != torch.float32:
        raise TypeError(f"vals must be int32 and signs float32, got "
                        f"{vals.dtype}/{signs.dtype}")
    if signs.shape != vals.shape:
        raise ValueError(f"signs {tuple(signs.shape)} != vals {tuple(vals.shape)}")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins {num_bins} outside [1, {MAX_BINS}]")
    out = torch.empty((g, num_bins), dtype=torch.float32, device=vals.device)
    if g == 0:
        return out
    vec = m % 4 == 0 and vals.data_ptr() % 16 == 0 and signs.data_ptr() % 16 == 0
    err = _lib().exp_histogram_launch(
        vals.data_ptr(), signs.data_ptr(), out.data_ptr(), g, m, num_bins,
        int(vec), _build.stream_ptr(vals))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out
