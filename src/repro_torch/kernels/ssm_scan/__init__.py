from .ops import (plan_groups, round_hi_lo, ssd_chunked, ssm_scan,
                  ssm_scan_phases_plain, ssm_scan_plain)

__all__ = ["plan_groups", "round_hi_lo", "ssd_chunked", "ssm_scan",
           "ssm_scan_phases_plain", "ssm_scan_plain"]
