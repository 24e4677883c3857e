"""Paper-verbatim facade of the PyTorch / CUDA port: ``import
eudoxia_torch as eudoxia`` (Listings 3-6).

Everything re-exports from :mod:`repro_torch.core`, where the
implementation lives; this package exists so the paper's code snippets
run unchanged on the port::

    import eudoxia_torch as eudoxia

    def main():
        paramfile = "project.toml"
        eudoxia.run_simulator(paramfile)   # on CUDA; device="cpu" here

It exports the names ``eudoxia`` does.
"""
from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import run_simulator, SimResult  # noqa: F401

from . import algorithm, core  # noqa: F401
