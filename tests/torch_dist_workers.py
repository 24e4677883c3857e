"""The ranks of ``tests/test_torch_distributed.py``: each job runs in
processes of its own (``torch.multiprocessing.spawn``) over a ``gloo``
process group on the CPU. This module imports no JAX, so the ranks start
quickly; a failed check raises in its rank and fails the job."""
import datetime
import json
import pathlib

import numpy as np
import torch
import torch.distributed as dist


def _init(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))


# ---------------------------------------------------------------------------
# job (i): four ranks
# ---------------------------------------------------------------------------
def four_ranks(rank: int, store: str) -> None:
    _init(rank, 4, store)
    try:
        _compressed_psum_mean(rank)
        _gpipe(rank)
        _moe_on_a_2x2_mesh(rank)
        _shard_params_placements(rank)
    finally:
        dist.destroy_process_group()


def _rank_grads(r: int):
    rng = np.random.default_rng(100 + r)
    scale = [1e-3, 1.0, 30.0][r % 3]
    g = {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
         "b": (rng.standard_normal((7,)) * scale).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32) for k, v in g.items()}
    return g, e


def _compressed_psum_mean(rank: int) -> None:
    """Different gradients on every rank, against the same arithmetic in
    numpy (f32 throughout, round half to even)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import compressed_psum_mean

    mesh = make_host_mesh(data=4, model=1)
    g, e = _rank_grads(rank)
    means, errs = compressed_psum_mean({k: torch.from_numpy(v) for k, v in g.items()},
                                       {k: torch.from_numpy(v) for k, v in e.items()}, mesh)
    per_rank = [_rank_grads(r) for r in range(4)]
    for k in g:
        corrected = [pg[k] + pe[k] for pg, pe in per_rank]
        scale = np.float32(max(np.maximum(np.max(np.abs(c)), np.float32(1e-12)) / np.float32(127.0)
                               for c in corrected))
        qs = [np.clip(np.round(c / scale), -127, 127).astype(np.int8) for c in corrected]
        mean = np.sum([q.astype(np.int32) for q in qs], axis=0).astype(np.float32) * scale
        mean = mean / np.float32(4.0)
        assert means[k].numpy().tobytes() == mean.tobytes(), k
        want_err = corrected[rank] - qs[rank].astype(np.float32) * scale
        assert errs[k].numpy().tobytes() == want_err.tobytes(), k


def _stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _gpipe(rank: int) -> None:
    """S = 4 stages, M = 3 microbatches: the outputs on every rank and the
    gradients (rank 0 takes the loss) against the sequential stack."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import gpipe

    mesh = make_host_mesh(data=1, model=1, pod=4)
    gen = torch.Generator().manual_seed(7)
    d, M = 8, 3
    w = (torch.randn((4, d, d), generator=gen) * 0.5).requires_grad_(True)
    b = (torch.randn((4, d), generator=gen) * 0.1).requires_grad_(True)
    x = torch.randn((M, 2, d), generator=gen).requires_grad_(True)
    probe = torch.randn((M, 2, d), generator=gen)

    y = gpipe(_stage, mesh, stage_axis="pod", num_microbatches=M)({"w": w, "b": b}, x)
    loss = torch.sum(y * probe) * (1.0 if rank == 0 else 0.0)
    gw, gb, gx = torch.autograd.grad(loss, (w, b, x), allow_unused=True)
    gx = torch.zeros_like(x) if gx is None else gx     # x enters on stage 0 alone

    w2, b2, x2 = (t.detach().clone().requires_grad_(True) for t in (w, b, x))
    h = x2
    for s in range(4):
        h = _stage({"w": w2[s], "b": b2[s]}, h)
    sw, sb, sx = torch.autograd.grad(torch.sum(h * probe), (w2, b2, x2))
    torch.testing.assert_close(y.detach(), h.detach(), rtol=0, atol=1e-5)
    # stage s's parameters get their gradient on rank s alone
    torch.testing.assert_close(gw[rank], sw[rank], rtol=0, atol=1e-5)
    torch.testing.assert_close(gb[rank], sb[rank], rtol=0, atol=1e-5)
    others = [s for s in range(4) if s != rank]
    assert not gw[others].any() and not gb[others].any()
    if rank == 0:
        torch.testing.assert_close(gx, sx, rtol=0, atol=1e-5)
    else:
        assert not gx.any()


def _moe_on_a_2x2_mesh(rank: int) -> None:
    """The MoE over a (data 2, model 2) mesh: batch rows on "data",
    experts on "model"; the output bit-equal to the plain MoE's, per-row
    (prefill) and global (decode) dispatch, f32 and bf16."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ModelConfig, MoEConfig
    from repro_torch.models.common import generator
    from repro_torch.models.mlp import moe_apply, moe_init
    from repro_torch.parallel import ShardingRules, logical_constraint, sharding_ctx
    from repro_torch.parallel.sharding import distribute, placements_for

    mesh = make_host_mesh(data=2, model=2)
    rules = ShardingRules()
    axes = {"router": "embed expert", "we_gate": "expert embed_moe ff",
            "we_up": "expert embed_moe ff", "we_down": "expert ff embed_moe"}
    for dt in (torch.float32, torch.bfloat16):
        for S in (16, 1):
            cfg = ModelConfig(d_model=32, d_ff=64, param_dtype=dt, compute_dtype=dt,
                              moe=MoEConfig(n_experts=4, top_k=2, expert_ff=48))
            p = moe_init(cfg, generator("cpu", 0))
            x = torch.randn((4, S, 32), generator=torch.Generator().manual_seed(1)).to(dt)
            want, want_aux = moe_apply(cfg, p, x)
            dp = {k: distribute(v, mesh, placements_for(v.shape, axes[k], mesh, rules.param))
                  for k, v in p.items()}
            with sharding_ctx(mesh, rules.act):
                got, aux = moe_apply(cfg, dp, logical_constraint(x, "batch seq embed", mesh, rules))
            got, aux = got.full_tensor(), aux.full_tensor()
            assert torch.equal(got, want), (dt, S)
            torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=0)


def _shard_params_placements(rank: int) -> None:
    """Every parameter of jamba's smoke config on a (2, 2) mesh takes the
    placements of its ``spec_for``, and its local shard is its slice of
    the whole value."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.configs import get_arch
    from repro_torch.launch.lowering import arch_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.axes import model_axes
    from repro_torch.parallel import placements, shard_params, spec_for

    mesh = make_host_mesh(data=2, model=2)
    arch = get_arch("jamba_1p5_large_398b")
    cfg, rules = arch.smoke, arch_rules(arch)
    whole = dict(lm.lm_init(cfg, 0, device="cpu").named_parameters())
    model = shard_params(lm.lm_init(cfg, 0, device="cpu"), model_axes(cfg), mesh, rules)
    sharded = 0
    for name, p in model.named_parameters():
        spec = spec_for(p.shape, model_axes(cfg)[name], mesh, rules.param)
        assert list(p.placements) == placements(spec, mesh), name
        shape, start = compute_local_shape_and_global_offset(p.shape, mesh, p.placements)
        index = tuple(slice(s, s + n) for s, n in zip(start, shape))
        assert torch.equal(p.to_local(), whole[name].detach()[index]), name
        sharded += any(isinstance(pl, Shard) for pl in p.placements)
    assert sharded > len(whole) // 2


# ---------------------------------------------------------------------------
# job (ii): two ranks
# ---------------------------------------------------------------------------
def two_ranks(rank: int, store: str) -> None:
    _init(rank, 2, store)
    try:
        _training_over_data(rank, pathlib.Path(store).parent / "ckpt")
        _batches_over_data(rank)
        _launcher_over_data(rank)
    finally:
        dist.destroy_process_group()


def _training_over_data(rank: int, ckpt_dir: pathlib.Path) -> None:
    """phi3's smoke config over a (2, 1) mesh: each rank half of every
    batch, the parameters FSDP-sharded; the losses within 1e-5 of one
    process's. Then the same run over the mesh with an async checkpoint
    every step and a failure injected at step 2: both ranks restart from
    the step written across them, and the losses equal the uninterrupted
    run's bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import FailureInjector, run_training

    arch = get_arch("phi3_mini_3p8b")
    mesh = make_host_mesh(data=2, model=1)
    kw = dict(steps=3, device="cpu", global_batch=4, seq_len=32)
    got = run_training(arch, mesh=mesh, **kw)
    want = run_training(arch, **kw)
    assert len(got.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-5)

    injector = FailureInjector(seed=0, mtbf_steps=1.0, max_failures=1)
    assert injector.schedule == [2]
    again = run_training(arch, mesh=mesh, ckpt_dir=str(ckpt_dir), ckpt_every=1,
                         injector=injector, **kw)
    assert again.restarts == 1 and again.steps_done == 3
    assert again.losses == got.losses, (again.losses, got.losses)
    assert sorted(p.name for p in ckpt_dir.iterdir()) == [
        "step_00000000", "step_00000001", "step_00000002"]


def _batches_over_data(rank: int) -> None:
    from repro_torch.data.pipeline import SyntheticLM, make_batch_iterator
    from repro_torch.launch.mesh import make_host_mesh

    ds = SyntheticLM(vocab=512, seq_len=16, global_batch=4, seed=3, family="vlm", n_img_tokens=2)
    mesh = make_host_mesh(data=2, model=1)
    batch = next(make_batch_iterator(ds, 5, device="cpu", mesh=mesh))
    for k, v in ds.batch_at(5).items():
        assert tuple(batch[k].shape) == v.shape
        np.testing.assert_array_equal(batch[k].to_local().numpy(), v[2 * rank:2 * rank + 2])


def _launcher_over_data(rank: int) -> None:
    """``launch/train.py --mesh-data 2`` on the started group (torchrun
    starts one from its environment)."""
    from repro_torch.launch import train

    train.main(["--arch", "rwkv6_7b", "--device", "cpu", "--mesh-data", "2", "--steps", "2",
                "--global-batch", "2", "--seq-len", "32"])


# ---------------------------------------------------------------------------
# job (iii): checkpoints across meshes
# ---------------------------------------------------------------------------
def _train_state():
    from repro_torch.configs import get_arch
    from repro_torch.runtime.steps import make_train_step, opt_config

    arch = get_arch("jamba_1p5_large_398b")
    init_fn, _ = make_train_step(arch.smoke, opt_config(arch), device="cpu")
    return arch, init_fn(11)


def _flat(state):
    from repro_torch.checkpoint.ckpt import _leaves

    return {path: t for path, t in _leaves(state)}


def checkpoint_ranks(rank: int, store: str, directory: str) -> None:
    """Four ranks: a state sharded over ranks 0-1 (a (2, 1) mesh) is saved,
    restored onto a (2, 2) mesh of all four and saved again, which is
    restored back onto the two ranks; every local shard equals its slice
    of the state drawn whole."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.train_loop import shard_state

    _init(rank, 4, store)
    try:
        out = pathlib.Path(directory)
        arch, whole = _train_state()
        want = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in _flat(whole).items()}
        two = DeviceMesh("cpu", torch.tensor([[0], [1]]), mesh_dim_names=("data", "model"))
        four = make_host_mesh(data=2, model=2)

        def check(state):
            from repro_torch.checkpoint.ckpt import _region

            for path, t in _flat(state).items():
                if not isinstance(t, torch.Tensor) or t.ndim == 0:
                    assert torch.equal(torch.as_tensor(t), torch.as_tensor(want[path])), path
                    continue
                start, shape = _region(t)
                index = tuple(slice(s, s + n) for s, n in zip(start, shape))
                local = t.to_local() if hasattr(t, "to_local") else t
                assert torch.equal(local.detach(), want[path][index]), path

        on_two = shard_state(arch, arch.smoke, _train_state()[1], two)
        save_checkpoint(on_two, out / "two", 1)
        template = shard_state(arch, arch.smoke, _zeroed(_train_state()[1]), four)
        on_four, manifest = restore_checkpoint(out / "two", template)
        assert manifest["ranks"] == 4 and manifest["step"] == 1
        check(on_four)
        save_checkpoint(on_four, out / "four", 2)
        back, _ = restore_checkpoint(out / "four", shard_state(
            arch, arch.smoke, _zeroed(_train_state()[1]), two))
        if rank < 2:
            check(back)
        if rank == 0:
            (out / "shards.json").write_text(json.dumps(
                {d: sorted(p.name for p in (out / d / f"step_{s:08d}").iterdir())
                 for d, s in (("two", 1), ("four", 2))}))
    finally:
        dist.destroy_process_group()


@torch.no_grad()
def _zeroed(state):
    for t in _flat(state).values():
        if isinstance(t, torch.Tensor):
            t.zero_()
    return state
