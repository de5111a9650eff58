"""Batched solvers for the hot problem families, with the fused GPU step of
the distinct-A lasso (every solver also runs on the plain XLA step; the
kernel has a Pallas interpret mode for CPU tests)."""

from .box_qp import reference_pg_box_step, solve_box_qp_batch
from .lasso import (
    fused_fb_prox_grad,
    fused_fista_step,
    lasso_step_route,
    reference_fb_prox_grad,
    solve_lasso_batch,
    solve_lasso_batch_compacting,
    solve_lasso_batch_mixed,
    solve_lasso_batch_tail,
    solve_lasso_multirhs,
    xla_fista_step,
)
from .tv import reference_cp_step, solve_tv_batch

__all__ = [
    "fused_fista_step", "fused_fb_prox_grad", "xla_fista_step",
    "reference_fb_prox_grad", "lasso_step_route", "solve_lasso_batch",
    "solve_lasso_batch_compacting", "solve_lasso_batch_mixed",
    "solve_lasso_batch_tail", "solve_lasso_multirhs",
    "reference_pg_box_step", "solve_box_qp_batch",
    "reference_cp_step", "solve_tv_batch",
]
