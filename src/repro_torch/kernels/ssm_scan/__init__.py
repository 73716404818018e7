from .ops import (SSMScanFn, plan_groups, round_hi_lo, ssd_chunked, ssm_scan,
                  ssm_scan_phases_plain, ssm_scan_plain, ssm_scan_vjp)

__all__ = ["SSMScanFn", "plan_groups", "round_hi_lo", "ssd_chunked",
           "ssm_scan", "ssm_scan_phases_plain", "ssm_scan_plain",
           "ssm_scan_vjp"]
