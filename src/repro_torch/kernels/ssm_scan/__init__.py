from .ops import ssm_scan, ssm_scan_bwd
from .ref import ssm_decode_step, ssm_scan_bwd_ref, ssm_scan_ref

__all__ = ["ssm_decode_step", "ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_ref", "ssm_scan_ref"]
