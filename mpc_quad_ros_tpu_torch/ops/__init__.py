from .qp import qp_kkt_residual
from .sqp import MPCConfig, MPCSolution, SQPSolver, SolverCarry, init_carry

__all__ = ["qp_kkt_residual", "MPCConfig", "MPCSolution", "SQPSolver", "SolverCarry", "init_carry"]
