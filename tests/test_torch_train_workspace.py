"""The port's training half, its own bookkeeping: ``create`` leaves the
global RNG alone, an update drops the kernels' packs, the EMA is the
inference net, the checkpoint round trip is exact, a short CPU
``Workspace`` run on a scripted kinematic collection (losses fall, resume
continues), and the bench checkpoint's export. Split from
``tests/test_torch_train.py`` so that ``--dist loadfile`` runs the two on
different workers; the helpers are that file's.
"""

import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
from latent_diffusion_planning_tpu_torch.train.checkpoint import (
    Checkpointer, apply_params_snapshot)
from test_torch_train import CKPT, _batch, _np, _small_config, _torch_batch
from torch_thread import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the agent's own bookkeeping
# ---------------------------------------------------------------------------

def test_create_leaves_the_global_rng_alone():
    before = torch.random.get_rng_state()
    a = LDPAgent.create(_small_config(), configs.SHAPE_META, seed=3,
                        device="cpu")
    assert torch.equal(before, torch.random.get_rng_state())
    b = LDPAgent.create(_small_config(), configs.SHAPE_META, seed=3,
                        device="cpu")
    for p, q in zip(a.planner.parameters(), b.planner.parameters()):
        assert torch.equal(p, q)


def test_update_marks_the_kernel_packs_stale():
    """The kernels read packed copies of the weights; an update, a restore
    and a params snapshot must drop them so the next sample on the card
    repacks (here a sentinel stands for a pack)."""
    agent = LDPAgent.create(_small_config(), configs.SHAPE_META, device="cpu")
    agent._packs.update(planner="stale", idm="stale")
    agent.update(_torch_batch(_batch()), 0, torch.Generator().manual_seed(0))
    assert agent._packs == {}
    agent._packs["idm"] = "stale"
    apply_params_snapshot(agent, agent.get_params())
    assert agent._packs == {}
    agent._packs["planner"] = "stale"
    agent.load_state_dict(agent.state_dict())
    assert agent._packs == {}


def test_ema_is_the_inference_net():
    cfg = _small_config(ema_decay=0.5)
    agent = LDPAgent.create(cfg, configs.SHAPE_META, device="cpu")
    ema = agent.planner_state.ema
    assert agent._inference_net("planner") is ema is not None
    before = [p.clone() for p in ema.parameters()]
    agent.update(_torch_batch(_batch()), 0, torch.Generator().manual_seed(0))
    for b, p, e in zip(before, agent.planner.parameters(), ema.parameters()):
        torch.testing.assert_close(e, 0.5 * b + 0.5 * p)


def test_checkpoint_round_trip_is_exact(tmp_path):
    cfg = _small_config(ema_decay=0.9, grad_clip=1.0)
    agent = LDPAgent.create(cfg, configs.SHAPE_META, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    for step in range(3):
        agent.update(_torch_batch(_batch(seed=step)), step, g)
    ck = Checkpointer(tmp_path)
    path = ck.save_state(3, agent, config={"a": 1})
    other = LDPAgent.create(cfg, configs.SHAPE_META, seed=1, device="cpu")
    ck.restore_state(path, other)
    a, b = agent.state_dict(), other.state_dict()
    assert a["planner"]["step"] == b["planner"]["step"] == 3
    for part in ("planner", "idm"):
        for key in ("params", "ema"):
            for k, v in a[part][key].items():
                assert torch.equal(v, b[part][key][k]), (part, key, k)
        for key in ("mu", "nu"):
            for x, y in zip(a[part][key], b[part][key]):
                assert torch.equal(x, y)
    for k, v in a["vae"].items():
        assert torch.equal(v, b["vae"][k])
    # the same next step from both
    batch = _torch_batch(_batch(seed=9))
    m1 = agent.update(batch, 3, torch.Generator().manual_seed(1))
    m2 = other.update(batch, 3, torch.Generator().manual_seed(1))
    assert float(m1["loss"]) == float(m2["loss"])
    for p, q in zip(agent.idm.parameters(), other.idm.parameters()):
        assert torch.equal(p, q)
    # params snapshot: save, restore_raw, apply
    ck.save_params(3, agent.get_params())
    fresh = LDPAgent.create(cfg, configs.SHAPE_META, seed=2, device="cpu")
    apply_params_snapshot(fresh, ck.restore_raw(ck.list_checkpoints()[-1]),
                          restore_keys=["idm_params"])
    for p, q in zip(fresh.idm.parameters(), agent.idm.parameters()):
        assert torch.equal(p, q)
    assert not torch.equal(next(fresh.planner.parameters()),
                           next(agent.planner.parameters()))
    assert [p.name for p in ck.list_states()] == ["3.state"]


def test_workspace_trains_on_a_scripted_kinematic_collection(tmp_path):
    """The whole training path at a small size on the CPU: scripted demos
    on the kinematic ``LiftEnv`` (rendered), welded in memory, latents from
    the agent's VAE, 30 steps of ``Workspace.run`` (ending with its snapshot and
    eval, a closed loop included): both losses fall, every value finite,
    and ``resume`` picks up the saved state."""
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import encode_latents
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace

    env = LiftEnv(episode_len=40)
    meta = {"env_name": "LiftEnv", "env_kwargs": {"episode_len": 40}}
    welded = {s: weld_collection(
        engine.run_scripted_collection(env, n, seed, device="cpu"),
        env_meta=meta, successful_only=True) for s, n, seed in
        (("train", 8, 0), ("eval", 4, 1))}
    cfg = configs.bench_train_config()
    cfg["agent"].update({k: v for k, v in _small_config(
        lr=3e-3, idm_lr=3e-3, warmup_steps=5, decay_steps=200).items()
        if k in ("planner", "idm_net", "vae", "lr", "idm_lr", "warmup_steps",
                 "decay_steps", "planner_n_diffusion_steps",
                 "idm_n_diffusion_steps", "planner_inference_steps",
                 "idm_inference_steps")})
    cfg.update(n_grad_steps=30, batch_size=32, log_every=10, save_every=20,
               eval_every=0, n_eval_episodes=2)
    cfg["data"].update(batch_size=32, eval_n_episode_overfit=None)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device="cpu")
    ws = Workspace(cfg, tmp_path, data=data, device="cpu")
    ws.init_agent()
    for w in welded.values():
        encode_latents(w, ws.agent.vae, ["agentview_image"])
    ws.run()
    curve = ws.loss_curve()
    for k in ("plan_loss", "idm_loss"):
        assert torch.isfinite(curve[k]).all()
        assert curve[k][-10:].mean() < curve[k][:10].mean(), k
    ev = ws.last_eval
    assert 0.0 <= ev["success"] <= 1.0 and ev["n_episodes"] == 2
    assert np.isfinite(ev["eval_action_mse"]) and np.isfinite(ev["eval_plan_mse"])
    assert (tmp_path / "train.jsonl").exists() and (tmp_path / "eval.jsonl").exists()
    assert [p.name for p in ws.ckpt.list_states()] == ["20.state", "30.state"]
    # resume: a new workspace continues from step 30 with the same state
    again = Workspace({**cfg, "resume": True}, tmp_path, data=data,
                      device="cpu")
    again.init_agent()
    assert again.step == 30
    for p, q in zip(again.agent.idm.parameters(), ws.agent.idm.parameters()):
        assert torch.equal(p, q)


def test_export_bench_torch_restores_the_bridged_weights(tmp_path):
    """``tools/export_bench_torch.py`` writes the committed checkpoint in the
    port's format, the whole VAE included, at the size its docstring
    states; restoring it onto a seeded agent gives the weights the bridge
    gives."""
    import importlib.util
    import re
    import sys
    from latent_diffusion_planning_tpu.train.checkpoint import (
        Checkpointer as JaxCheckpointer)
    spec = importlib.util.spec_from_file_location(
        "export_bench_torch", CKPT.parent.parent / "tools" /
        "export_bench_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv, sys.argv = sys.argv, ["export", "--out", str(tmp_path)]
    try:
        assert tool.main() == 0
    finally:
        sys.argv = argv
    agent = LDPAgent.create(configs.bench_agent_config(), configs.SHAPE_META,
                            device="cpu")
    ck = Checkpointer(tmp_path)
    path = ck.list_checkpoints()[-1]
    stated = float(re.search(r"([\d.]+) MB", tool.__doc__).group(1))
    assert path.stat().st_size / 1e6 == pytest.approx(stated, abs=0.05)
    snap = ck.restore_raw(path)
    assert set(snap["vae_params"]) == set(agent.vae.state_dict())
    apply_params_snapshot(agent, snap)
    want = bridge.ldp_agent_from_flax(
        _np(JaxCheckpointer(CKPT).restore_raw(CKPT / "agent.ckpt")),
        configs.bench_agent_config(), configs.SHAPE_META, device="cpu")
    for name in ("planner", "idm", "vae"):
        for (k, p), q in zip(getattr(agent, name).state_dict().items(),
                             getattr(want, name).state_dict().values()):
            assert torch.equal(p, q), (name, k)
