"""Carry operators, weights and the learner across from the JAX package.

The solvers' "weights" are their operators.  Given the leaves of a
meshdqn_tpu operator pytree as numpy arrays (the caller converts them; this
package never imports JAX), build the port's counterpart, so both steppers
can run from identical operators.  The same holds for the Q-network's
parameters and for the whole DQN learner (both nets, both Adam states and
the counters), which scripts/torch_convert_checkpoint.py writes from orbax
checkpoints.
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


def noderemoval_params_from_numpy(leaves: dict, device) -> dict:
    """The Q-network's parameters from the JAX package's `params1` leaves,
    keyed by their path in its tree ('conv1/lin_l_w', ..., 'pool5/w'), as
    f32 tensors on `device`."""
    params: dict = {}
    for path, value in leaves.items():
        layer, name = path.split("/")
        params.setdefault(layer, {})[name] = torch.tensor(
            np.asarray(value, dtype=np.float32), device=device)
    return params


def load_deploy_weights(path, device):
    """(params, step, extras) from a file written by
    scripts/torch_convert_checkpoint.py."""
    import json

    with np.load(path, allow_pickle=False) as z:
        leaves = {k: z[k] for k in z.files if "/" in k}
        step = int(z["step"])
        extras = json.loads(str(z["extras_json"]))
    return noderemoval_params_from_numpy(leaves, device), step, extras


def dqn_state_from_numpy(arrays: dict, cfg, device, dtype=torch.float32):
    """The port's DQNState (rl/dqn.py) from a JAX DQNState's leaves as numpy
    arrays, keyed as scripts/torch_convert_checkpoint.py writes them
    (`rl.dqn.state_arrays`' keys: params1/<layer>/<name>, params2/...,
    opt{1,2}/mu/..., opt{1,2}/nu/..., opt{1,2}/count and schedule_count
    (optax's Adam and schedule counts), num_grads, select), its float
    leaves as `dtype` on `device`."""
    from .rl.dqn import init_dqn, load_state_arrays

    def tree(net):
        out: dict = {}
        for key, value in arrays.items():
            if key.startswith(f"params{net}/"):
                _, layer, name = key.split("/")
                out.setdefault(layer, {})[name] = torch.tensor(
                    np.asarray(value), dtype=dtype, device=device)
        return out

    return load_state_arrays(init_dqn(tree(1), tree(2), cfg), arrays, cfg)


def dqn_state_to_numpy(state) -> dict:
    """The inverse of dqn_state_from_numpy: the learner's arrays as numpy,
    keyed as `rl.dqn.state_arrays`."""
    from .rl.dqn import state_arrays

    return {k: v.detach().cpu().numpy() for k, v in state_arrays(state).items()}


def load_dqn_state(path, cfg, device, dtype=torch.float32):
    """(DQNState, step, extras) from a file written by
    scripts/torch_convert_checkpoint.py --state."""
    import json

    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k not in ("step", "extras_json")}
        step = int(z["step"])
        extras = json.loads(str(z["extras_json"]))
    return dqn_state_from_numpy(arrays, cfg, device, dtype), step, extras
