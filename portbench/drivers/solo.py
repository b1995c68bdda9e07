"""One flow: the program's `IPCSSolver.solve`, one whole solve at a time.

A driver builds the program's solver for a configuration's mesh set (that
is set-up), then runs whole solves from the initial velocities the harness
hands it.  Velocity vectors of the program keep the layout [x | 0 | y | 0]
in blocks of half their length; the harness embeds its inputs and reads the
outputs in that layout.
"""
from __future__ import annotations

import numpy as np
import torch


class Driver:
    def __init__(self, config: dict, mesh_set: dict, meshes, device):
        from meshdqn_tpu_torch.mesh import TriMesh
        from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver

        if len(meshes) != 1:
            raise ValueError(f"the solo driver runs one mesh, got {len(meshes)}")
        flow = config["flow"]
        cfg = IPCSConfig(mu=flow["mu"], rho=flow["rho"], dt=flow["dt"],
                         **mesh_set["solver"])
        self.solver = IPCSSolver(TriMesh(*meshes[0]), cfg, device=device)
        if not self.solver.fused:
            raise ValueError("the solo driver times the fused solve")
        self.steps, self.save_steps = flow["solver_steps"], flow["save_steps"]
        self.flows = 1
        self.n_u, self.n_p = self.solver.ndofs_u, self.solver.ndofs_p
        self.device = self.solver.device
        self._state = None

    def _state_from(self, u0: np.ndarray):
        u = torch.as_tensor(u0[0], dtype=torch.float32, device=self.device)
        return self.solver.initial_state()._replace(u=u)

    def solve(self, u0: np.ndarray, steps: int | None = None,
              save_steps: int | None = None):
        """One whole solve from velocities u0 (1, n_u) and zero pressure;
        returns drags and lifts (1, steps) on the host, then the final u
        (1, n_u) and p (1, n_p) on the device."""
        res = self.solver.solve(steps or self.steps, save_steps or self.save_steps,
                                state=self._state_from(u0))
        st = res["state"]
        return (res["drags"].cpu().numpy()[None], res["lifts"].cpu().numpy()[None],
                st.u[None], st.p[None])

    def start(self, u0: np.ndarray):
        """Set the state that `advance` carries on."""
        self._state = self._state_from(u0)

    def advance(self, n: int):
        """n steps on from the carried state, with no wait on the device."""
        self._state, _, _ = self.solver.evolve(self._state, n)

    def release(self):
        self.solver = self._state = None
