"""Carry operators across from the JAX package.

The solvers' "weights" are their operators.  Given the leaves of a
meshdqn_tpu operator pytree as numpy arrays (the caller converts them; this
package never imports JAX), build the port's counterpart, so both steppers
can run from identical operators.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.banded import BandedMatrix
from .ops.cg import BlockJacobi
from .ops.convection import ConvectionKernel
from .ops.sparse import EllMatrix
from .solver.fused import FusedOperators, SplitLow
from .solver.ipcs import BandedCGOperators, CGOperators, DeviceOperators

CONV_FIELDS = ("cell_dofs", "phi", "gphys", "wdet", "ndofs")


def fused_operators_from_numpy(arrays: dict, conv_arrays: dict, device,
                               dtype=torch.float32) -> FusedOperators:
    """arrays: every FusedOperators field but `conv`, by name; conv_arrays:
    the JAX ConvectionKernel's fields (CONV_FIELDS), gphys in its (C, Q, 6,
    2) layout."""
    conv = ConvectionKernel.from_arrays(
        *(conv_arrays[f] for f in CONV_FIELDS), device=device, dtype=dtype
    )
    leaves = {
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in FusedOperators._fields
        if name != "conv"
    }
    return FusedOperators(conv=conv, **leaves)


def _blocks(a: np.ndarray, device, dtype) -> torch.Tensor:
    """Banded blocks keep bf16 storage (ml_dtypes' bfloat16 from JAX, widened
    to f32 exactly on the way); other blocks take `dtype`."""
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, dtype=dtype, device=device)


def _leaf(name: str, value, device, dtype):
    if name == "conv":
        return ConvectionKernel.from_arrays(
            *(value[f] for f in CONV_FIELDS), device=device, dtype=dtype
        )
    if name == "vert_pos":
        return torch.tensor(np.asarray(value, dtype=np.int64), device=device)
    if isinstance(value, dict) and "cols" in value:
        return EllMatrix.from_arrays(value["cols"], value["vals"], value["shape"],
                                     device=device, dtype=dtype)
    if isinstance(value, dict) and "blocks" in value:
        return BandedMatrix(
            blocks=_blocks(np.asarray(value["blocks"]), device, dtype),
            pad=int(value["pad"]), g=int(value["g"]),
            shape=tuple(int(s) for s in value["shape"]),
            aligned128=bool(value["aligned128"]),
        )
    if isinstance(value, dict) and "inv_blocks" in value:
        return BlockJacobi(
            torch.tensor(np.asarray(value["inv_blocks"]), dtype=dtype, device=device),
            int(value["n"]),
        )
    return torch.tensor(np.asarray(value), dtype=dtype, device=device)


def cg_operators_from_numpy(arrays: dict, device, dtype=torch.float64):
    """The port's CGOperators, or BandedCGOperators when `arrays` has
    `vert_pos`, from the leaves of the JAX package's operators, by field:

    * an EllMatrix as {"cols", "vals", "shape"};
    * a BandedMatrix as {"blocks", "pad", "g", "shape", "aligned128"};
    * a BlockJacobi as {"inv_blocks", "n"};
    * `conv` as the ConvectionKernel's fields (CONV_FIELDS);
    * every other field (vectors, 0-d rho and dt, vert_pos) as an array."""
    cls = BandedCGOperators if "vert_pos" in arrays else CGOperators
    return cls(**{name: _leaf(name, arrays[name], device, dtype)
                  for name in cls._fields})


def split_low_from_numpy(arrays: dict, device) -> SplitLow:
    """The 'df32' low limbs from the JAX package's SplitLow leaves by field:
    matrix limbs stay bf16 (ml_dtypes' bfloat16 from JAX, widened to f32 in
    numpy and narrowed again, which is exact), vector limbs f32."""
    return SplitLow(**{name: _blocks(np.asarray(arrays[name]), device, torch.float32)
                       for name in SplitLow._fields})


def device_operators_from_numpy(arrays: dict, device) -> DeviceOperators:
    """The port's DeviceOperators (the unfused step) from the JAX package's
    leaves by field, each in its own dtype (f32 and f64 mix in 'mixed'):

    * an EllMatrix as {"cols", "vals", "shape"}, vals in their dtype;
    * None where the JAX operators hold None (A1bc, A3bc; A2bc unless
      'mixed');
    * `conv` as the ConvectionKernel's fields (CONV_FIELDS), in the velocity
      path's dtype (that of t1);
    * every other field (inverses, vectors, 0-d rho and dt) as an array."""
    np_to_torch = {np.dtype(np.float32): torch.float32,
                   np.dtype(np.float64): torch.float64}
    wdt = np_to_torch[np.asarray(arrays["t1"]).dtype]

    def leaf(name, value):
        if value is None:
            return None
        if name == "conv":
            return _leaf(name, value, device, wdt)
        if isinstance(value, dict):
            return _leaf(name, value, device,
                         np_to_torch[np.asarray(value["vals"]).dtype])
        value = np.asarray(value)
        return torch.tensor(value, dtype=np_to_torch[value.dtype], device=device)

    return DeviceOperators(**{name: leaf(name, arrays[name])
                              for name in DeviceOperators._fields})
