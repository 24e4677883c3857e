"""Deterministic synthetic data pipeline with document packing, a port of
``repro.data.pipeline``.

Documents of random length are drawn from a seeded Zipf-ish unigram
model and packed into fixed-length rows with EOS separators, by the JAX
package's own numpy generator (copied here: ``SeedSequence([seed,
step])``), so the same ``(seed, step)`` gives the same arrays bit for bit
in both packages, on every restart: what makes checkpoint / resume
reproducible. ``make_batch_iterator`` puts each batch on the caller's
device (CUDA unless the caller asks for the CPU); over a device mesh each
rank keeps its rows of the same global batch, a DTensor sharded on its
batch dim over the mesh's batch axes (``"pod"``, ``"data"``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..core.engine import resolve_device

EOS = 1


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    family: str = "lm"           # lm | vlm | audio
    n_img_tokens: int = 0
    vit_dim: int = 1024

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The full global batch for ``step`` as numpy arrays."""
        rng = self._rng(step)
        B, S = self.global_batch, self.seq_len
        tokens = np.empty((B, S), np.int32)
        for b in range(B):
            row: list[int] = []
            while len(row) < S:
                n = int(rng.geometric(1.0 / self.mean_doc_len))
                n = max(8, min(n, S - len(row)))
                doc = (rng.zipf(1.3, size=n).astype(np.int64) % (self.vocab - 2)) + 2
                row.extend(doc.tolist()[: n - 1])
                row.append(EOS)
            tokens[b] = np.asarray(row[:S], np.int32)
        out = {"tokens": tokens}
        if self.family == "vlm":
            out["frontend_embeds"] = rng.standard_normal(
                (B, self.n_img_tokens, self.vit_dim), np.float32).astype(np.float32)
        if self.family == "audio":
            out["frontend_embeds"] = rng.standard_normal(
                (B, S, self.vit_dim), np.float32).astype(np.float32)
        return out


def make_batch_iterator(ds: SyntheticLM, start_step: int = 0, *, device="cuda", mesh=None,
                        batch_axes: tuple[str, ...] = ("pod", "data"),
                        ) -> Iterator[dict[str, torch.Tensor]]:
    """Yields the batches of ``start_step``, ``start_step + 1``, ... as
    tensors on ``device``; with a ``mesh``, as DTensors sharded on dim 0
    over the ``batch_axes`` it has (each rank keeps its own rows)."""
    device = resolve_device(device)
    step = start_step
    put = lambda t: t  # noqa: E731
    if mesh is not None:
        from ..parallel.sharding import distribute, mesh_axes, placements

        axes = tuple(a for a in batch_axes if a in mesh_axes(mesh))
        place = placements((axes,) if axes else (), mesh)
        put = lambda t: distribute(t, mesh, place)  # noqa: E731
    while True:
        yield {k: put(torch.from_numpy(v).to(device)) for k, v in ds.batch_at(step).items()}
        step += 1


__all__ = ["EOS", "SyntheticLM", "make_batch_iterator"]
