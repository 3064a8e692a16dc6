from .qp import qp_kkt_residual, solve_box_qp_pdip, solve_box_qp_projected_newton
from .sqp import MPCConfig, MPCSolution, SQPSolver, SolverCarry, init_carry

__all__ = ["qp_kkt_residual", "solve_box_qp_pdip", "solve_box_qp_projected_newton", "MPCConfig",
           "MPCSolution", "SQPSolver", "SolverCarry", "init_carry"]
