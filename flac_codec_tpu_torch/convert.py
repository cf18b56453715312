"""Plan trees between the JAX package and the port.

A codec has no weights: the state the planner hands to the packer is its
plan tree (``assignment`` plus a ``channels`` list of per-slot dicts, or
the five slim frame-packed leaves).  :func:`plan_from_numpy` turns a plan
whose leaves are numpy arrays — a JAX plan after ``np.asarray`` — into
the port's tensor plan on ``device``; :func:`plan_to_numpy` goes back.
Tests use them to feed the same plan to both packers.

dtypes: torch has no usable uint16/uint32, so u32 words travel as int32
with the same bits (reinterpreted with ``.view``) and u16 values as
int32; every other leaf keeps its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

# leaves whose numpy dtype the port cannot hold as is
_TO_NUMPY = {"frame_words": np.uint32, "packed_words": np.uint32,
             "inner_crc": np.uint16}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def plan_from_numpy(plan: dict, device) -> dict:
    """numpy plan tree -> tensor plan tree on ``device``."""
    out = {}
    for k, v in plan.items():
        if k == "channels":
            out[k] = [{ck: _leaf_from_numpy(cv, device)
                       for ck, cv in ch.items()} for ch in v]
        else:
            out[k] = _leaf_from_numpy(v, device)
    return out


def _leaf_to_numpy(key: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    want = _TO_NUMPY.get(key)
    if want is np.uint32:
        return a.view(np.uint32)
    if want is np.uint16:
        return a.astype(np.uint16)
    return a


def plan_to_numpy(plan: dict) -> dict:
    """Tensor plan tree -> numpy plan tree with the JAX package's dtypes
    (``frame_words`` and ``packed_words`` uint32, ``inner_crc`` uint16)."""
    out = {}
    for k, v in plan.items():
        if k == "channels":
            out[k] = [{ck: _leaf_to_numpy(ck, cv) for ck, cv in ch.items()}
                      for ch in v]
        else:
            out[k] = _leaf_to_numpy(k, v)
    return out
