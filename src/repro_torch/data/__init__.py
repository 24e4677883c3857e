from .pipeline import EOS, SyntheticLM, make_batch_iterator

__all__ = ["EOS", "SyntheticLM", "make_batch_iterator"]
