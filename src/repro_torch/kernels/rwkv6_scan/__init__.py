from .ops import rwkv6_scan
from .ref import LOG_W_MIN, rwkv6_chunked_ref, rwkv6_decode_step, rwkv6_ref

__all__ = ["LOG_W_MIN", "rwkv6_scan", "rwkv6_chunked_ref", "rwkv6_decode_step", "rwkv6_ref"]
