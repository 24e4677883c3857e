from .ops import rwkv6_scan, rwkv6_scan_bwd
from .ref import LOG_W_MIN, rwkv6_chunked_ref, rwkv6_decode_step, rwkv6_ref, rwkv6_scan_bwd_ref

__all__ = ["LOG_W_MIN", "rwkv6_chunked_ref", "rwkv6_decode_step", "rwkv6_ref", "rwkv6_scan",
           "rwkv6_scan_bwd", "rwkv6_scan_bwd_ref"]
