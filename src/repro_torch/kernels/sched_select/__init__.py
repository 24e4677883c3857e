from .ops import masked_lex_argmin, select_next_pipe, select_sjf, select_victim
from .ref import masked_lex_argmin_ref, select_next_pipe_ref, select_sjf_ref, select_victim_ref

__all__ = [
    "masked_lex_argmin",
    "select_next_pipe",
    "select_sjf",
    "select_victim",
    "masked_lex_argmin_ref",
    "select_next_pipe_ref",
    "select_sjf_ref",
    "select_victim_ref",
]
