from .ops import ssd_chunked, ssm_scan, ssm_scan_plain

__all__ = ["ssd_chunked", "ssm_scan", "ssm_scan_plain"]
