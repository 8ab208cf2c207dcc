"""Training and eval across ranks in the port (``parallel/mesh.py``), two
gloo ranks on the CPU against one process.

One spawn of two ranks (``torch.multiprocessing``, a file under
``tmp_path`` as the rendezvous, torch on one thread in each) runs every
case and saves what it saw; the tests read it:

- ``replicate`` makes a rank whose weights and Adam moments were perturbed
  equal to rank 0;
- one LDP update at small widths over the 2-rank ``dp`` mesh (the global
  batch and the losses' draws sliced per rank, the gradients averaged
  before the clip) equals the one-process update on the global batch: the
  averaged gradient within 1e-6, each weight within 1e-6 where its
  gradient is above 1e-6 (below it Adam's first step turns on rounding, so
  there its bound holds: a move of at most the learning rate each way);
- with a ``grad_clip`` the global norm exceeds, the same holds, and
  clipping each rank's gradient before the average would give another
  gradient;
- an env-sharded eval of 4 episodes equals its two halves run alone (each
  rank draws from ``seed``), and with a policy that draws nothing it equals
  the one-process run, so the resets are the same; videos under a mesh are
  refused;
- a 3-step ``Workspace`` run over both ranks (one run directory, as under
  ``torchrun``): the mean of the ranks' losses equals the one-process
  run's at every step, its weights end within Adam's bound of the
  one-process run's, only rank 0 writes logs and checkpoints, and the
  eval's closed loop is split over the ranks without videos.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from latent_diffusion_planning_tpu_torch import configs
from latent_diffusion_planning_tpu_torch.envs import lift
from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
from latent_diffusion_planning_tpu_torch.parallel import mesh as meshlib
from latent_diffusion_planning_tpu_torch.rollout import engine
from torch_thread import one_torch_thread  # noqa: F401

WORLD = 2
B, H = 8, 9
SEED = 11
CLIP = 1e-3


def _config(**over):
    cfg = configs.bench_agent_config()
    cfg.update(planner={"down_dims": [16, 32], "kernel_size": 5, "n_groups": 4,
                        "diffusion_step_embed_dim": 32},
               idm_net={"n_blocks": 2, "hidden_dim": 64, "time_dim": 16,
                        "cond_hidden_dims": [32, 32]},
               vae={"block_out_channels": [8, 16, 16, 16], "norm_groups": 4,
                    "patch_size": 4, "latent_channels": 4},
               planner_n_diffusion_steps=12, idm_n_diffusion_steps=12,
               planner_inference_steps=4, idm_inference_steps=4,
               lr=1e-3, end_lr=1e-4, idm_lr=1e-3, idm_end_lr=1e-4,
               warmup_steps=2, decay_steps=10)
    cfg.update(over)
    return cfg


def _batch():
    """A global latent-form batch (the VAE passes latents through)."""
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return {"obs": {
        "robot0_eef_pos": t(rng.normal(size=(B, H, 3)) * 0.1 + [0, 0, 1.0]),
        "robot0_eef_quat": t(rng.uniform(-1, 1, (B, H, 4))),
        "robot0_gripper_qpos": t(rng.uniform(size=(B, H, 2)) * [0.05, -0.05]),
        "latent_agentview_image": t(rng.normal(0, 3, (B, H, 16)))},
        "actions": t(rng.uniform(-1.2, 1.2, (B, H, 7)))}


def _nets(agent):
    return [p for net in (agent.planner, agent.idm) for p in net.parameters()]


def _update(agent, batch, mesh=None) -> dict:
    """One update at step 0; returns the gradients it applied (Adam's
    first moment over 1 - b1), its own gradients before any average, and
    the weights after it."""
    gen = torch.Generator().manual_seed(SEED)
    with meshlib.sharded_draws(mesh):
        agent.backward(batch, True, True, gen)
    local = [p.grad.clone() for p in _nets(agent)]
    agent.apply_gradients(True, True)
    mu = agent.planner_state.mu + agent.idm_state.mu
    return {"applied": [m / 0.1 for m in mu], "local": local,
            "weights": [p.detach().clone() for p in _nets(agent)]}


def _noisy_policy(agent, window, gen):
    """The servo policy plus draws from ``gen``."""
    acts = _servo_policy(agent, window, gen)
    return acts + 0.1 * torch.randn(acts.shape, generator=gen)


def _servo_policy(agent, window, gen):
    rel = window["object"][:, -1, 7:10]
    step = torch.clamp(rel / 0.05, -1.0, 1.0)
    close = torch.where(torch.linalg.norm(rel, dim=-1) < 0.02, 1.0, -1.0)
    act = torch.cat([step, torch.zeros_like(step), close[:, None]], -1)
    return act[:, None].expand(-1, 4, -1).clone()


def _eval(policy, n=4, **kw):
    env = lift.LiftEnv(render_images=False, episode_len=16)
    return engine.run_batched_eval(env, None, n, 3, action_horizon=4,
                                   policy=policy, device="cpu",
                                   **kw)["per_episode"]


def _workspace_run(work) -> dict:
    """3 steps of the ``Workspace`` at small widths on a scripted kinematic
    collection (each rank builds the same), its eval closing the loop on 2
    episodes."""
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import encode_latents
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace

    env = lift.LiftEnv(episode_len=12)
    meta = {"env_name": "LiftEnv", "env_kwargs": {"episode_len": 12}}
    welded = {s: weld_collection(engine.run_scripted_collection(
        env, 2, seed, device="cpu"), env_meta=meta)
        for s, seed in (("train", 0), ("eval", 1))}
    cfg = configs.bench_train_config()
    cfg["agent"].update({k: v for k, v in _config().items()
                         if k in ("planner", "idm_net", "vae", "lr", "end_lr",
                                  "idm_lr", "idm_end_lr", "warmup_steps",
                                  "decay_steps", "planner_n_diffusion_steps",
                                  "idm_n_diffusion_steps",
                                  "planner_inference_steps",
                                  "idm_inference_steps")})
    cfg.update(n_grad_steps=3, batch_size=8, log_every=1, save_every=0,
               eval_every=0, n_eval_episodes=2)
    cfg["data"].update(batch_size=8, eval_n_episode_overfit=None)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device="cpu")
    ws = Workspace(cfg, work, data=data, device="cpu")
    ws.init_agent()
    for w in welded.values():
        encode_latents(w, ws.agent.vae, ["agentview_image"])
    ws.run()
    return {"losses": ws.loss_curve()["loss"],
            "weights": [p.detach().clone() for p in _nets(ws.agent)],
            "mesh": ws.mesh.shape, "eval": ws.last_eval}


def _rank(rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=WORLD)
    res = {"threads": torch.get_num_threads()}
    mesh = meshlib.make_mesh()
    res["mesh"] = (mesh.dp, mesh.env, mesh.rank, mesh.dp_rank)
    grid = meshlib.make_mesh(dp=1, env=2)      # the batch repeats along env
    res["grid"] = (grid.dp_rank, grid.env_rank, meshlib.shard_batch(
        _batch(), grid)["actions"].shape[0])

    agent = LDPAgent.create(_config(), configs.SHAPE_META, device="cpu")
    if rank == 1:           # a rank that drifted: weights and moments
        with torch.no_grad():
            for t in _nets(agent) + agent.planner_state.mu:
                t.add_(0.5)
    meshlib.replicate(agent, mesh)
    res["replicated"] = [t.clone() for t in meshlib._tensors(
        agent.state_dict())]
    res["dp_group_set"] = agent.planner_state.dp_group is mesh.dp_group
    local = meshlib.shard_batch(_batch(), mesh)
    res["local_rows"] = local["actions"].shape[0]
    res["plain"] = _update(agent, local, mesh)
    clipped = LDPAgent.create(_config(grad_clip=CLIP), configs.SHAPE_META,
                              device="cpu")
    meshlib.replicate(clipped, mesh)
    res["clipped"] = _update(clipped, local, mesh)

    env_mesh = meshlib.make_env_mesh()
    res["sharded"] = _eval(_noisy_policy, env_mesh=env_mesh)
    res["sharded_servo"] = _eval(_servo_policy, env_mesh=env_mesh)
    try:
        _eval(_servo_policy, env_mesh=env_mesh, video_envs=1)
    except ValueError as e:
        res["video_refusal"] = str(e)
    res["workspace"] = _workspace_run(out / "ws")
    torch.save(res, out / f"{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    mp.spawn(_rank, args=(out / "init", out), nprocs=WORLD, join=True)
    return out, [torch.load(out / f"{r}.pt", weights_only=False)
                 for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[1]


@pytest.fixture(scope="module")
def one_process():
    """The same updates on the global batch in one process."""
    out = {}
    for name, cfg in (("plain", _config()), ("clipped",
                                             _config(grad_clip=CLIP))):
        agent = LDPAgent.create(cfg, configs.SHAPE_META, device="cpu")
        out[name] = _update(agent, _batch())
    return out


def test_spawned_ranks_run_one_thread_on_a_2x1_mesh(ranks):
    assert [r["threads"] for r in ranks] == [1, 1]
    assert [r["mesh"] for r in ranks] == [(2, 1, 0, 0), (2, 1, 1, 1)]
    assert [r["grid"] for r in ranks] == [(0, 0, B), (0, 1, B)]
    assert [r["local_rows"] for r in ranks] == [B // 2, B // 2]
    assert all(r["dp_group_set"] for r in ranks)


def test_replicate_equalises_a_perturbed_rank(ranks):
    for a, b in zip(ranks[0]["replicated"], ranks[1]["replicated"]):
        assert torch.equal(a, b)


def _assert_update_matches(got: dict, want: dict, lr: float) -> None:
    for g, w in zip(got["applied"], want["applied"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)
    for p, q, g in zip(got["weights"], want["weights"], want["applied"]):
        big = g.abs() > 1e-6
        diff = (p - q).abs()
        assert diff[big].max() <= 1e-6 if big.any() else True
        assert diff.max() <= 2 * lr + 1e-7


@pytest.mark.parametrize("case", ["plain", "clipped"])
def test_dp_update_equals_the_global_update(ranks, one_process, case):
    lr = _config()["end_lr"]        # the schedule's first step
    for r in ranks:
        _assert_update_matches(r[case], one_process[case], lr)


def test_clipping_each_rank_would_differ(ranks, one_process):
    """The clip applies to the averaged gradient (its global norm exceeds
    the bound); clipping each rank's own gradient before the average gives
    a gradient that differs from it."""
    local = [r["clipped"]["local"] for r in ranks]
    avg = [(a + b) / 2 for a, b in zip(*local)]
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in avg]))
    assert norm > CLIP
    per_rank = []
    for grads in local:
        n = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        per_rank.append([g * CLIP / n for g in grads])
    clip_each = [(a + b) / 2 for a, b in zip(*per_rank)]
    want = one_process["clipped"]["applied"]
    gap = max((c - w).abs().max().item() for c, w in zip(clip_each, want))
    scale = max(w.abs().max().item() for w in want)
    assert gap > 1e-3 * scale
    for got, w in zip(ranks[0]["clipped"]["applied"], want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-6, rtol=0)


def test_env_sharded_eval_equals_its_halves(ranks):
    for r in ranks:
        for k, v in r["sharded"].items():
            np.testing.assert_array_equal(v, ranks[0]["sharded"][k])
    halves = [_eval(_noisy_policy, n=2, episode_seeds=[2 * r, 2 * r + 1])
              for r in range(WORLD)]
    for k in halves[0]:
        np.testing.assert_array_equal(
            ranks[0]["sharded"][k], np.concatenate([h[k] for h in halves]))


def test_env_sharded_resets_equal_the_one_process_run(ranks):
    want = _eval(_servo_policy)
    for k, v in want.items():
        np.testing.assert_array_equal(ranks[1]["sharded_servo"][k], v)


def test_videos_under_env_mesh_are_refused(ranks):
    for r in ranks:
        assert "env_mesh" in r["video_refusal"]
    with pytest.raises(ValueError, match="divisible"):
        engine._run_sharded(None, None, 3, 0, 1, 4, 8, None, False, None,
                            meshlib.Mesh(1, 2, 0), 0.0, None, None, "cpu")


def test_workspace_over_two_ranks_equals_one_process(spawned, tmp_path):
    out, ranks = spawned
    want = _workspace_run(tmp_path / "one")
    assert [r["workspace"]["mesh"] for r in ranks] == [{"dp": 2, "env": 1}] * 2
    mean = (ranks[0]["workspace"]["losses"]
            + ranks[1]["workspace"]["losses"]) / 2
    np.testing.assert_allclose(mean.numpy(), want["losses"].numpy(),
                               atol=1e-5, rtol=0)
    lr = _config()["lr"]
    for r in ranks:
        for p, q in zip(r["workspace"]["weights"], want["weights"]):
            diff = (p - q).abs()
            assert (diff <= 1e-5).float().mean() >= 0.999
            assert diff.max() <= 3 * 2 * lr
    ws = out / "ws"
    lines = (ws / "train.jsonl").read_text().splitlines()
    assert len(lines) == len((tmp_path / "one" / "train.jsonl")
                             .read_text().splitlines())
    assert sorted(p.name for p in (ws / "ckpt").iterdir()) == [
        "3.ckpt", "3.config.json", "3.state"]
    assert not (ws / "video").exists()
    assert (tmp_path / "one" / "video").exists()
    for r in ranks:
        assert r["workspace"]["eval"]["n_episodes"] == 2
        assert r["workspace"]["eval"]["success"] == \
            ranks[0]["workspace"]["eval"]["success"]
