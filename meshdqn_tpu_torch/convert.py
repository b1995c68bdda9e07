"""Carry composed operators across from the JAX package.

The fused solver's "weights" are its composed operators.  Given the leaves
of a meshdqn_tpu FusedOperators as numpy arrays (the caller converts them;
this package never imports JAX), build the port's FusedOperators so both
steppers can run from identical operators.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.convection import ConvectionKernel
from .solver.fused import FusedOperators

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
