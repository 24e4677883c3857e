"""The port's distribution over several ranks, on the CPU: three jobs of
``gloo`` processes, each rendezvousing through a ``FileStore`` under
``tmp_path`` (so that pytest workers never share a port). The ranks are
in ``tests/torch_dist_workers.py``.

* (i) Four ranks: ``compressed_psum_mean`` with different gradients on
  every rank against numpy, bit for bit; ``gpipe`` with S = 4 stages,
  forward and gradient, against the port's sequential stack within
  1e-5; the MoE on a (2, 2) mesh bit-equal to the plain MoE;
  ``shard_params``' placements equal to ``spec_for``'s.
* (ii) Two ranks: ``run_training`` over a (2, 1) mesh for 3 smoke steps
  within 1e-5 of one process, and again with an async checkpoint every
  step and an injected failure, restarted onto the mesh and bit-equal
  to the uninterrupted run; ``make_batch_iterator(mesh=)`` gives each
  rank its rows; ``launch/train.py --mesh-data 2`` on the group.
* (iii) A checkpoint saved on 2 ranks restores on 4 and, saved there,
  back on 2; both restore in one process (here, no process group), all
  exactly.
"""
import pathlib

import torch
import torch.multiprocessing as mp

import torch_dist_workers as workers
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)


def _spawn(fn, world, *args):
    mp.spawn(fn, args=args, nprocs=world, join=True)


def test_four_ranks_collectives_pipeline_moe_and_placements(tmp_path):
    _spawn(workers.four_ranks, 4, str(tmp_path / "store"))


def test_two_ranks_train_over_a_data_mesh(tmp_path):
    _spawn(workers.two_ranks, 2, str(tmp_path / "store"))


def test_checkpoint_restores_across_one_two_and_four_ranks(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.ckpt import _leaves

    _spawn(workers.checkpoint_ranks, 4, str(tmp_path / "store"), str(tmp_path))
    _, want = workers._train_state()
    for name, step in (("two", 1), ("four", 2)):
        files = sorted(p.name for p in (tmp_path / name / f"step_{step:08d}").iterdir())
        shards = [f for f in files if f.startswith("shard_") and f.endswith(".json")]
        assert len(shards) == (2 if name == "two" else 4), files
        _, template = workers._train_state()
        got, manifest = restore_checkpoint(tmp_path / name, workers._zeroed(template))
        assert manifest["step"] == step
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            assert torch.equal(torch.as_tensor(a).detach(), torch.as_tensor(b).detach()), path
    assert pathlib.Path(tmp_path / "shards.json").exists()
