"""The port's command-line drivers and what they stand on: the ``.npz``
dataset files against the JAX package's HDF5 ones, the fused checkpoint
sweep (``run_batched_eval_multi``) against sequential evals, the seven
drivers chained end to end on the CPU, their refusals, and the logger's
CSV.

Sizes are tiny (kinematic Lift env, narrow nets, a few steps); equality is
exact throughout: the same data through two containers, and the same
episodes through one loop at two batch shapes on the CPU.
"""

import csv
import json
import sys

import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu_torch import configs
from latent_diffusion_planning_tpu_torch.data import ingest, writer
from latent_diffusion_planning_tpu_torch.utils.config import ConfigError
from torch_thread import one_torch_thread  # noqa: F401

OBS_KEYS = ("robot0_eef_pos", "agentview_image")


def _collection(N=5, T=6, seed=0):
    """A collection as the engines return it: images out of [0, 255] and
    fractional (the writer clips and truncates), episodes 1 and 3 succeed
    at steps 2 and 4."""
    rng = np.random.default_rng(seed)
    success = np.zeros((N, T), bool)
    success[1, 2:] = True
    success[3, 4:] = True
    return {
        "first_obs": {"robot0_eef_pos": rng.normal(size=(N, 3)).astype(
                          np.float32),
                      "agentview_image": rng.uniform(-20, 280, (N, 8, 8, 3))
                      .astype(np.float32)},
        "obs": {"robot0_eef_pos": rng.normal(size=(N, T, 3)).astype(
                    np.float32),
                "agentview_image": rng.uniform(-20, 280, (N, T, 8, 8, 3))
                .astype(np.float32)},
        "actions": rng.uniform(-1, 1, (N, T, 7)).astype(np.float32),
        "rewards": success.astype(np.float32),
        "success": success}


def _assert_same_welded(got, want):
    assert got.arrays.keys() == want.arrays.keys()
    for k, v in want.arrays.items():
        w = np.asarray(v)
        g = got.arrays[k].numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert np.array_equal(got.demo_starts.numpy(), want.demo_starts)
    assert np.array_equal(got.demo_lengths.numpy(), want.demo_lengths)
    assert got.env_meta == want.env_meta


KEEP = [{}, {"successful_only": True}, {"unsuccessful_only": True,
                                        "max_demos": 2},
        {"successful_only": True, "trim_success_margin": 1}]


@pytest.mark.parametrize("keep", KEEP, ids=lambda k: ",".join(k) or "all")
def test_npz_round_trip_equals_the_hdf5_one(keep, tmp_path):
    """``write_trajectories`` → ``.npz`` → ``load_npz`` gives the welded
    demos that the JAX ``write_trajectories`` → HDF5 → ``load_robomimic``
    gives, under each keep rule, with a latent companion and the
    ``optimal`` flag; the port's own HDF5 reader agrees."""
    from latent_diffusion_planning_tpu.data import ingest as jingest
    from latent_diffusion_planning_tpu.data import writer as jwriter
    import h5py
    col = _collection()
    meta = {"env_name": "LiftPhysicsEnv", "env_kwargs": {"episode_len": 6}}
    n_jax = jwriter.write_trajectories(tmp_path / "d.hdf5", col,
                                       env_meta=meta, **keep)
    n = writer.write_trajectories(tmp_path / "d.npz", col, env_meta=meta,
                                  **keep)
    assert n == n_jax > 0
    want = jingest.load_robomimic(str(tmp_path / "d.hdf5"), OBS_KEYS)
    got = ingest.load_demos(str(tmp_path / "d.npz"), OBS_KEYS)
    _assert_same_welded(got, want)
    _assert_same_welded(ingest.load_robomimic(str(tmp_path / "d.hdf5"),
                                              OBS_KEYS), want)

    # a latent companion, written as tools/process_latents.py writes it
    rng = np.random.default_rng(1)
    z = rng.normal(size=(got.total_steps, 16)).astype(np.float32)
    with h5py.File(tmp_path / "z.hdf5", "w") as f:
        for d, (s, length) in enumerate(zip(got.demo_starts.tolist(),
                                            got.demo_lengths.tolist())):
            f.create_dataset(f"data/demo_{d}/latent/agentview_image",
                             data=z[s:s + length])
        f["data"].attrs["min_z"] = float(z.min())
        f["data"].attrs["max_z"] = float(z.max())
    got.arrays["latent_agentview_image"] = torch.from_numpy(z)
    writer.write_latents(tmp_path / "z.npz", got, ["agentview_image"],
                         float(z.min()), float(z.max()))
    keys = ("robot0_eef_pos", "latent_agentview_image", "optimal")
    want = jingest.load_robomimic(str(tmp_path / "d.hdf5"), keys,
                                  latent_path=str(tmp_path / "z.hdf5"),
                                  optimal=0.0)
    lat = ingest.load_demos(str(tmp_path / "d.npz"), keys,
                            latent_path=str(tmp_path / "z.npz"), optimal=0.0)
    _assert_same_welded(lat, want)
    with np.load(tmp_path / "z.npz") as f:
        assert json.loads(str(f["data/min_z"])) == float(z.min())
    if got.n_demos > 1:
        first = ingest.load_demos(str(tmp_path / "d.npz"), OBS_KEYS,
                                  n_demos=1)
        assert first.n_demos == 1


def test_readers_and_writer_refuse_what_they_cannot_take(tmp_path,
                                                         monkeypatch):
    col = _collection()
    with pytest.raises(ValueError, match="npz"):
        writer.write_trajectories(tmp_path / "d.hdf5", col)
    with pytest.raises(ValueError, match="exclude"):
        writer.write_trajectories(tmp_path / "d.npz", col,
                                  successful_only=True,
                                  unsuccessful_only=True)
    with pytest.raises(ValueError, match=".npz or .hdf5"):
        ingest.load_demos(str(tmp_path / "d.txt"), OBS_KEYS)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        ingest.load_demos(str(tmp_path / "d.hdf5"), OBS_KEYS)


# ---------------------------------------------------------------------------
# the fused checkpoint sweep
# ---------------------------------------------------------------------------

SMALL_VAE = {"block_out_channels": [8, 8, 8, 8], "norm_groups": 4,
             "patch_size": 4, "latent_channels": 4}


def _agent(seed, **over):
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    cfg = configs.bench_agent_config()
    cfg.update(vae=SMALL_VAE, planner_inference_steps=3,
               idm_inference_steps=3, planner_n_diffusion_steps=10,
               idm_n_diffusion_steps=10)
    cfg["planner"] = dict(cfg["planner"], down_dims=[16, 32],
                          diffusion_step_embed_dim=16)
    cfg["idm_net"] = dict(cfg["idm_net"], hidden_dim=32, n_blocks=1)
    cfg.update(over)
    return LDPAgent.create(cfg, configs.SHAPE_META, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def sweep():
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    env = LiftEnv(image_size=64, episode_len=12)
    return env, [_agent(1), _agent(2), _agent(3)]


def _same(a, b):
    assert a["metrics"] == b["metrics"]
    for k, v in b["per_episode"].items():
        assert np.array_equal(a["per_episode"][k], v), k


@pytest.mark.parametrize("plan_blend", [0.0, 0.5])
def test_run_batched_eval_multi_equals_sequential_evals(sweep, plan_blend):
    """K agents × N episodes as one env batch: agent k's result equals
    ``run_batched_eval`` with ``seeds[k]`` bit for bit, and does not depend
    on which agents share its batch."""
    from latent_diffusion_planning_tpu_torch.rollout import engine
    env, agents = sweep
    kw = dict(obs_horizon=1, action_horizon=4, plan_blend=plan_blend,
              policy_obs_keys=configs.BENCH_POLICY_KEYS,
              episode_seeds=[4, 9, 2], device="cpu")
    fused = engine.run_batched_eval_multi(env, agents[:2], 3, [5, 6], **kw)
    for agent, seed, got in zip(agents, (5, 6), fused):
        _same(got, engine.run_batched_eval(env, agent, 3, seed, **kw))
    alone = engine.run_batched_eval_multi(env, agents[1:2], 3, [6], **kw)
    _same(fused[1], alone[0])
    other = engine.run_batched_eval_multi(env, agents[1:], 3, [6, 7], **kw)
    _same(fused[1], other[0])


def test_run_batched_eval_multi_refuses_mixed_agents(sweep):
    from latent_diffusion_planning_tpu_torch.rollout import engine
    env, agents = sweep
    with pytest.raises(ValueError, match="share one class and config"):
        engine.run_batched_eval_multi(
            env, [agents[0], _agent(1, planner_inference_steps=5)], 2,
            [0, 1], device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        engine.run_batched_eval_multi(env, agents[:2], 2, [0], device="cpu")


# ---------------------------------------------------------------------------
# the seven drivers, chained
# ---------------------------------------------------------------------------

KIN = "latent_diffusion_planning_tpu.envs.lift.LiftEnv"
CPU = "device=cpu"
VAE = ["block_out_channels=[8,8,8,8]", "patch_size=4", "norm_groups=4"]


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_drivers_chained_end_to_end(tmp_path, monkeypatch):
    """Demos → VAE → latents → LDP (3 checkpoints) → the sweep (fused and
    one at a time, the same rows) → suboptimal collection → its latents →
    the mixed arm, every driver from its command line with ``device=cpu``
    on the kinematic env; every file is there and reads back."""
    from latent_diffusion_planning_tpu_torch.drivers import (
        collect_data, collect_demos, eval_bc, process_latents, train_bc,
        train_mixed_bc, train_vae)
    from latent_diffusion_planning_tpu_torch.utils.config import load_config
    monkeypatch.chdir(tmp_path)
    for name, n, seed in (("demos", 6, 0), ("demos_eval", 10, 77)):
        collect_demos.main([f"env._target_={KIN}", f"n_episodes={n}",
                            "episode_len=40", f"out_path=ds/{name}.npz",
                            f"seed={seed}", CPU])
    demos = ingest.load_demos("ds/demos.npz", OBS_KEYS)
    assert demos.n_demos == 6 and demos.env_meta == {
        "env_name": "LiftEnv", "env_kwargs": {
            "image_size": 64, "render_images": True, "episode_len": 40}}
    run = ["experiment_root=exp", "experiment_folder=p"]
    train_vae.main(["data=lift/img", "data.train_path=ds/demos.npz",
                    "data.eval_path=ds/demos_eval.npz",
                    *[f"model.vae.{a}" for a in VAE], "batch_size=8",
                    "n_grad_steps=4", "warmup_steps=1", "eval_every=4",
                    "save_every=4", "n_eval_batches=1", *run,
                    "experiment_name=vae", CPU])
    assert (tmp_path / "exp/p/vae/html/recon_4.html").exists()
    vae = "exp/p/vae/ckpt/4.ckpt"
    latents = ["vae_snapshot_path=" + vae, *[f"vae.{a}" for a in VAE], CPU]
    process_latents.main([*latents,
                          "src_paths=[ds/demos.npz,ds/demos_eval.npz]",
                          "dst_paths=[ds/demos_latent.npz,"
                          "ds/demos_eval_latent.npz]"])
    files = ["data.train_path=ds/demos.npz",
             "data.eval_path=ds/demos_eval.npz",
             "data.train_latent_path=ds/demos_latent.npz",
             "data.eval_latent_path=ds/demos_eval_latent.npz"]
    common = [*[f"model_vae.{a}" for a in VAE],
              f"agent.vae_pretrain_path={vae}",
              "agent.planner.down_dims=[16,32]",
              "agent.planner.diffusion_step_embed_dim=16",
              "agent.idm_net.hidden_dim=32", "agent.idm_net.n_blocks=1",
              "agent.planner_n_diffusion_steps=10",
              "agent.idm_n_diffusion_steps=10",
              "agent.planner_inference_steps=3",
              "agent.idm_inference_steps=3",
              "data.env_params.env.episode_len=8", "horizon=9",
              "obs_horizon=1", "action_horizon=4", "pred_horizon=8",
              "batch_size=8", "warmup_steps=1", "lr=3e-4",
              "n_eval_episodes=3", *run, CPU]
    train_bc.main(["agent=ldp_agent", "data=lift/latent_img", *files,
                   *common, "n_grad_steps=6", "eval_every=6", "save_every=2",
                   "experiment_name=ldp"])
    ldp = tmp_path / "exp/p/ldp"
    assert [p.name for p in sorted((ldp / "ckpt").glob("*.ckpt"))] == [
        "2.ckpt", "4.ckpt", "6.ckpt"]
    assert load_config(str(ldp / "config.json")).agent.planner.down_dims == [
        16, 32]
    assert _read_csv(ldp / "eval.csv")[-1]["step"] == "6"

    eval_bc.main([f"run_dir={ldp}", "n_eval_episodes=3", "sweep_batch=3",
                  CPU])
    fused = _read_csv(ldp / "eval_sweep" / "eval.csv")
    eval_bc.main([f"run_dir={ldp}", "n_eval_episodes=3", CPU])
    alone = _read_csv(ldp / "eval_sweep" / "eval.csv")
    assert [r["step"] for r in fused] == ["2", "4", "6"]
    assert [r["sweep_batch"] for r in fused] == ["3.0"] * 3
    assert [r["sweep_batch"] for r in alone] == ["1.0"] * 3
    for f, a in zip(fused, alone):
        for k in ("success", "reward", "horizon", "avg_reward",
                  "train_action_mse", "eval_action_l1"):
            assert f[k] == a[k], k
    eval_bc.main([f"run_dir={ldp}", "n_eval_episodes=3", "ckpt_steps=[4]",
                  f"idm_snapshot_path={ldp}/ckpt/2.ckpt", CPU])
    assert [r["step"] for r in _read_csv(ldp / "eval_sweep" / "eval.csv")
            ] == ["2", "4"]

    collect_data.main([f"run_dir={ldp}", "ckpt_name=2.ckpt", "n_episodes=3",
                       "episode_len=8", "noise=0.1", "unsuccessful_only=true",
                       "out_path=ds/subopt.npz", "seed=123", CPU])
    sub = ingest.load_demos("ds/subopt.npz", OBS_KEYS)
    assert sub.n_demos >= 1 and bool((sub.demo_lengths == 9).all())
    process_latents.main([*latents, "src_paths=[ds/subopt.npz]",
                          "dst_paths=[ds/subopt_latent.npz]"])
    train_mixed_bc.main([
        "data=lift/latent_img", "data.train_n_episode_overfit=2", *files,
        "mixed_data=lift/mixed_latent_img",
        "mixed_data.train_n_episode_overfit=[2,null]",
        "mixed_data.train_paths=[ds/demos.npz,ds/subopt.npz]",
        "mixed_data.eval_paths=ds/demos_eval.npz",
        "mixed_data.train_latent_paths=[ds/demos_latent.npz,"
        "ds/subopt_latent.npz]",
        "mixed_data.eval_latent_paths=ds/demos_eval_latent.npz",
        *common, "n_grad_steps=2", "eval_every=2", "save_every=2",
        "experiment_name=mixed"])
    mixed = tmp_path / "exp/p/mixed"
    assert (mixed / "ckpt" / "2.ckpt").exists()
    cfg = load_config(str(mixed / "config.json"))
    assert cfg.mixed_data._target_.endswith("MixedOfflineData")
    assert float(_read_csv(mixed / "eval.csv")[-1]["n_episodes"]) == 3


def test_drivers_refuse_what_they_cannot_take(tmp_path, monkeypatch):
    from latent_diffusion_planning_tpu_torch.drivers import (
        collect_demos, eval_bc, train_mixed_bc)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ConfigError, match="mixed_data"):
        train_mixed_bc.main(["--config", "train_bc", CPU])
    with pytest.raises(ValueError, match="npz"):     # the yaml's .hdf5 path
        collect_demos.main([f"env._target_={KIN}", "n_episodes=1",
                            "episode_len=2", CPU])
    with pytest.raises(ConfigError, match="not ported"):
        collect_demos.main(["env._target_=latent_diffusion_planning_tpu."
                            "envs.aloha_cube.AlohaCubeEnv", CPU])
    (tmp_path / "run" / "ckpt").mkdir(parents=True)
    (tmp_path / "run" / "config.json").write_text(json.dumps(
        {"data": {}, "agent": {}}))
    with pytest.raises(FileNotFoundError):
        eval_bc.main(["run_dir=run", CPU])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            collect_demos.main([f"env._target_={KIN}", "n_episodes=1",
                                "episode_len=2", "out_path=x.npz"])


def test_logger_writes_csv_rows(tmp_path):
    """A dump is a CSV row; new keys widen the header; a later run drops
    the rows at and after its first step."""
    from latent_diffusion_planning_tpu_torch.utils.logger import Logger
    log = Logger(tmp_path)
    for step, metrics in ((1, {"a": 1.0}), (2, {"a": 2.0, "b": 3.0}),
                          (3, {"a": 4.0})):
        log.log_metrics(metrics, step, "eval")
        log.dump(step, "eval")
    rows = _read_csv(tmp_path / "eval.csv")
    assert [(r["step"], r["a"], r["b"]) for r in rows] == [
        ("1", "1.0", "0.0"), ("2", "2.0", "3.0"), ("3", "4.0", "0.0")]
    log.log_metrics({"a": 9.0}, 2, "eval")
    log.dump(2, "eval")
    assert [r["step"] for r in _read_csv(tmp_path / "eval.csv")] == ["1", "2"]
