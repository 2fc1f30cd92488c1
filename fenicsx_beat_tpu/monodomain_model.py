r"""Monodomain diffusion model.

JAX counterpart of reference ``src/beat/monodomain_model.py``: solves

.. math::

    C_m \frac{\partial v}{\partial t} - \nabla \cdot (M \nabla v) - I_{stim} = 0

with the theta rule.  The reference builds the variational form symbolically
(``monodomain_model.py:68-98``); here the form is realized directly as the
linear system ``(C_m*Mass + theta*dt*K) v = C_m*Mass v_ - (1-theta)*dt*K v_
+ dt*b_stim(t)`` over precompiled ELL operators (see ``base_model.py``).
"""

from __future__ import annotations

from . import fem
from .base_model import BaseModel
from .conductivities import as_cell_tensors
from .mesh import Mesh

__all__ = ["MonodomainModel"]


class MonodomainModel(BaseModel):
    def __init__(
        self,
        time: fem.Constant,
        mesh: Mesh,
        M,
        I_s=None,
        params=None,
        C_m: float = 1.0,
        dx=None,
        **kwargs,
    ) -> None:
        self._M = M
        self.C_m = float(C_m)
        super().__init__(mesh=mesh, time=time, params=params, I_s=I_s, dx=dx, **kwargs)

    def _setup_state_space(self) -> None:
        k = self.parameters["degree"]
        family = self.parameters["family"]
        self.V = fem.functionspace(self._mesh, (family, k))
        self.v_ = fem.Function(self.V, name="v_")
        self._state = fem.Function(self.V, name="v")

    @property
    def state(self) -> fem.Function:
        return self._state

    def assign_previous(self) -> None:
        self.v_.x.array[:] = self.state.x.array[:]

    @staticmethod
    def default_parameters():
        params = super(MonodomainModel, MonodomainModel).default_parameters()
        params["use_custom_preconditioner"] = True
        return params

    def _operators(self):
        M_cells = as_cell_tensors(self._M, self._mesh)
        mass, stiff = fem.assemble_mass_stiffness(self.V, M_cells, dtype=self._dtype)
        return mass, stiff, self.C_m

    def variational_forms(self, dt):
        """Kept for API parity with reference ``monodomain_model.py:68-98``;
        the discrete operators are returned instead of UFL forms."""
        return (self._mass, self._stiff)
