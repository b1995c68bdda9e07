"""One flow on the program's CG path: `IPCSSolver.solve` with method='cg',
one whole solve at a time.

The driver interface of drivers/solo.py.  The CG path keeps its velocities
in its own order (the banded layout's interleaved RCM order), so the
harness's inputs, velocities [x | y] of 2 Ns, go in through the solver's
`import_u` and the final velocity comes out through `export_u`; the
pressure is in vertex order already.  Each solve starts from a zero PCG
warm start, as a fresh solver's does.
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
        if not hasattr(IPCSSolver, "import_u"):
            # Before the solver is built, so that a program without it
            # fails at once.
            raise RuntimeError("the program's IPCSSolver has no import_u: it cannot "
                               "take a velocity in [x | y] into the CG layout")
        flow = config["flow"]
        cfg = IPCSConfig(mu=flow["mu"], rho=flow["rho"], dt=flow["dt"],
                         **mesh_set["solver"])
        if cfg.method != "cg":
            raise ValueError("the CG driver times the CG solve")
        self.solver = IPCSSolver(TriMesh(*meshes[0]), cfg, device=device)
        self.steps, self.save_steps = flow["solver_steps"], flow["save_steps"]
        self.flows = 1
        self.n_u, self.n_p = self.solver.ndofs_u, self.solver.ndofs_p
        self.device = self.solver.device
        self._state = None

    def _state_from(self, u0: np.ndarray):
        """The state at rest but for velocity u0[0] ([x | y]); also zeroes
        the PCG warm start (`initial_state` resets it)."""
        s = self.solver
        u = torch.as_tensor(u0[0], dtype=s.work_dtype, device=self.device)
        return s.initial_state()._replace(u=s.import_u(u))

    def solve(self, u0: np.ndarray, steps: int | None = None,
              save_steps: int | None = None):
        """One whole solve from velocities u0 (1, n_u) and zero pressure;
        returns drags and lifts (1, steps) on the host, then the final u
        (1, n_u) in [x | y] and p (1, n_p) on the device."""
        res = self.solver.solve(steps or self.steps, save_steps or self.save_steps,
                                state=self._state_from(u0))
        st = res["state"]
        return (res["drags"].cpu().numpy()[None], res["lifts"].cpu().numpy()[None],
                self.solver.export_u(st.u)[None], st.p[None])

    def start(self, u0: np.ndarray):
        """Set the state that `advance` carries on."""
        self._state = self._state_from(u0)

    def advance(self, n: int):
        """n steps on from the carried state, with no wait on the device."""
        self._state, _, _ = self.solver.evolve(self._state, n)

    def release(self):
        self.solver = self._state = None
