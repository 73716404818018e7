from .ops import (RMSNormFn, RowPlan, plan_rows, rmsnorm, rmsnorm_lanes_plain,
                  rmsnorm_plain, rmsnorm_vjp)

__all__ = ["RMSNormFn", "RowPlan", "plan_rows", "rmsnorm",
           "rmsnorm_lanes_plain", "rmsnorm_plain", "rmsnorm_vjp"]
