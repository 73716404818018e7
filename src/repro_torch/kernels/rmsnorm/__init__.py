from .ops import (RowPlan, plan_rows, rmsnorm, rmsnorm_lanes_plain,
                  rmsnorm_plain)

__all__ = ["RowPlan", "plan_rows", "rmsnorm", "rmsnorm_lanes_plain",
           "rmsnorm_plain"]
