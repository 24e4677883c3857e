from .ops import ssm_scan
from .ref import ssm_decode_step, ssm_scan_ref

__all__ = ["ssm_decode_step", "ssm_scan", "ssm_scan_ref"]
