"""The port's training half against the JAX package's: the optimizer and
schedule against optax, the LDP losses, gradients and one update against
``LDPAgent`` with JAX's draws handed in, the bench checkpoint's losses at
full width, the checkpoint round trip and a short CPU ``Workspace`` run.

Both sides are fp32 on the CPU with JAX's matmuls at "highest" precision.
Tolerances are stated per test: the schedule is arithmetic on one scalar
(1e-9); an Adam step moves each weight by at most the learning rate, and
the two frameworks' moments differ in the last bit (1e-6); losses and
gradients sum differently ordered fp32 products (1e-5 relative, and 1e-5 of
the largest gradient entry); the full-width checkpoint sums longer products
(1e-4 relative).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from latent_diffusion_planning_tpu.models.agents import LDPAgent as JaxLDPAgent
from latent_diffusion_planning_tpu.models.agents import common as jcommon
from latent_diffusion_planning_tpu.train import state as jstate
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
from latent_diffusion_planning_tpu_torch.models.nets.mlp import MLPDiffusion
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
from latent_diffusion_planning_tpu_torch.train import state
from latent_diffusion_planning_tpu_torch.train.checkpoint import (
    Checkpointer, apply_params_snapshot)

CKPT = Path(__file__).resolve().parent.parent / "assets" / "bench"


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


# ---------------------------------------------------------------------------
# schedule and optimizer against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 1, 2, 199, 200, 201, 1000, 29999, 30000,
                                   40000])
def test_schedule_matches_optax(count):
    """The bench's schedule at the counts where an off-by-one would show:
    the first update uses end_lr, the warm-up ends at 200."""
    want = jstate.warmup_cosine_lr(3e-4, 1e-6, 200, 30000)(count)
    got = state.warmup_cosine_lr(3e-4, 1e-6, 200, 30000)(count)
    assert abs(got - float(want)) <= 1e-9


class _Two(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Linear(5, 4)
        self.b = nn.Linear(4, 3)


def _tree(module):
    return {"a": {"kernel": module.a.weight.detach().numpy().T.copy(),
                  "bias": module.a.bias.detach().numpy().copy()},
            "b": {"kernel": module.b.weight.detach().numpy().T.copy(),
                  "bias": module.b.bias.detach().numpy().copy()}}


@pytest.mark.parametrize("grad_clip,ema", [(None, 0.0), (0.5, 0.0),
                                           (None, 0.9), (2.0, 0.99)])
def test_train_state_matches_optax(grad_clip, ema):
    """Four Adam steps (± global-norm clipping, ± EMA) on seeded weights and
    gradients; some steps' gradients are big enough to be clipped."""
    torch.manual_seed(0)
    net = _Two()
    tx, _ = jstate.make_optimizer(1e-2, 1e-3, 2, 10, grad_clip)
    jst = jstate.EMATrainState.create(apply_fn=None, params=_tree(net), tx=tx,
                                      ema_decay=ema)
    st = state.TrainState(net, lr=1e-2, end_lr=1e-3, warmup_steps=2,
                          decay_steps=10, grad_clip=grad_clip, ema_decay=ema)
    rng = np.random.default_rng(1)
    for i in range(4):
        g = {k: {kk: (rng.normal(size=v.shape) * (3.0 if i % 2 else 0.1)
                      ).astype(np.float32) for kk, v in d.items()}
             for k, d in _tree(net).items()}
        jst = jst.apply_gradients(g)
        for name in ("a", "b"):
            lin = getattr(net, name)
            lin.weight.grad = torch.from_numpy(g[name]["kernel"].T.copy())
            lin.bias.grad = torch.from_numpy(g[name]["bias"].copy())
        st.apply_gradients()
        assert st.step == int(jst.step)
        for mine, theirs in ((net, jst.params), (st.ema, jst.ema_params)):
            if mine is None:
                assert theirs is None
                continue
            got = _tree(mine)
            for k in got:
                for kk in got[k]:
                    np.testing.assert_allclose(got[k][kk],
                                               np.asarray(theirs[k][kk]),
                                               atol=1e-6, rtol=0)
    assert st.inference_module is (st.ema if ema else net)
    assert all(p.grad is None for p in net.parameters())


def test_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2))]
    want = float(jstate.global_norm(xs))
    got = float(state.global_norm([torch.from_numpy(x) for x in xs]))
    assert abs(got - want) <= 1e-6 * want


def test_schedule_forward_process_matches_jax():
    from latent_diffusion_planning_tpu.ops import diffusion as jdlib
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(5, 4, 3)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 3, 17, 49, 25])
    for pt in ("epsilon", "sample", "v_prediction"):
        js = jdlib.DiffusionSchedule.create(50, "squaredcos_cap_v2",
                                            prediction_type=pt)
        ts = dlib.DiffusionSchedule.create(50, prediction_type=pt)
        args = (torch.from_numpy(x0), torch.from_numpy(noise),
                torch.from_numpy(t))
        np.testing.assert_allclose(ts.add_noise(*args).numpy(),
                                   np.asarray(js.add_noise(x0, noise, t)),
                                   atol=1e-6)
        np.testing.assert_allclose(ts.training_target(*args).numpy(),
                                   np.asarray(js.training_target(x0, noise, t)),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the LDP losses, gradients and update against JAX
# ---------------------------------------------------------------------------

def _small_config(**over):
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


def _jax_agent(cfg, shape_meta=configs.SHAPE_META):
    pkg = "latent_diffusion_planning_tpu.models.nets."
    train_keys = ("lr", "end_lr", "idm_lr", "idm_end_lr", "warmup_steps",
                  "decay_steps", "grad_clip", "ema_decay", "alpha_planner",
                  "alpha_idm", "action_loss_weights", "update_planner_every",
                  "update_idm_every", "update_idm_after",
                  "update_planner_until", "update_planner_after")
    return JaxLDPAgent.create(
        jax.random.PRNGKey(0), None, shape_meta,
        planner={"_target_": pkg + "unet1d.ConditionalUnet1D", **cfg["planner"]},
        idm_net={"_target_": pkg + "mlp.MLPDiffusion", **cfg["idm_net"]},
        vae=cfg["vae"], vae_feature_dim=16, lowdim_obs=cfg["lowdim_obs"],
        rgb_obs=cfg["rgb_obs"], obs_normalization=cfg["obs_normalization"],
        obs_horizon=1, pred_horizon=8, action_horizon=4,
        planner_n_diffusion_steps=cfg["planner_n_diffusion_steps"],
        idm_n_diffusion_steps=cfg["idm_n_diffusion_steps"],
        planner_inference_steps=cfg["planner_inference_steps"],
        idm_inference_steps=cfg["idm_inference_steps"], fused_sampler=False,
        **{k: cfg[k] for k in train_keys if k in cfg})


def _bridged(jagent, cfg):
    snap = {"planner_params": _np(jagent.planner_state.params),
            "idm_params": _np(jagent.idm_state.params),
            "vae_params": _np(jagent.vae_params)}
    return bridge.ldp_agent_from_flax(snap, cfg, configs.SHAPE_META,
                                      device="cpu")


def _batch(B=4, H=9, seed=0):
    """A raw latent-form training batch (the VAE passes latents through)."""
    rng = np.random.default_rng(seed)
    return {"obs": {
        "robot0_eef_pos": (rng.normal(size=(B, H, 3)) * 0.1
                           + [0, 0, 1.0]).astype(np.float32),
        "robot0_eef_quat": rng.uniform(-1, 1, (B, H, 4)).astype(np.float32),
        "robot0_gripper_qpos": (rng.uniform(size=(B, H, 2))
                                * [0.05, -0.05]).astype(np.float32),
        "latent_agentview_image": rng.normal(0, 3, (B, H, 16)).astype(
            np.float32)},
        "actions": rng.uniform(-1.2, 1.2, (B, H, 7)).astype(np.float32)}


def _torch_batch(batch):
    return {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
            "actions": torch.from_numpy(batch["actions"])}


def _jax_loss_draws(rng, jagent, B, H, A=7, use_planner=True, use_idm=True):
    """The draws JAX ``_loss`` takes from ``rng``: split once per used net,
    then ``t`` and ``noise`` from a split of that key."""
    out = {}
    D = jagent.config.obs_dim
    if use_planner:
        rng, sub = jax.random.split(rng)
        t_rng, n_rng = jax.random.split(sub)
        out["plan_t"] = np.array(jax.random.randint(
            t_rng, (B,), 0, jagent.planner_sched.num_steps))
        out["plan_noise"] = np.array(jax.random.normal(n_rng, (B, H - 1, D)))
    if use_idm:
        rng, sub = jax.random.split(rng)
        t_rng, n_rng = jax.random.split(sub)
        n = B * (H - 1)
        out["idm_t"] = np.array(jax.random.randint(
            t_rng, (n,), 0, jagent.idm_sched.num_steps))
        out["idm_noise"] = np.array(jax.random.normal(n_rng, (n, A)))
    return out


def _jit_loss(jagent):
    """JAX ``_loss`` under ``jit`` (compiling beats op-by-op dispatch here);
    the use flags and obs_horizon are static."""
    return jax.jit(jagent._loss, static_argnums=(4, 5, 6))


def _jax_prepared(jagent, batch):
    b = jcommon.prepare_batch(jax.tree_util.tree_map(jnp.asarray, batch),
                              jagent.obs_normalization)
    b["obs"] = jagent._encode_obs(b["obs"])
    return b


@pytest.fixture(scope="module")
def small_pair():
    cfg = _small_config()
    jagent = _jax_agent(cfg)
    return cfg, jagent


def _assert_metrics_close(got, want, rtol=1e-5):
    for k, v in want.items():
        assert k in got, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("use_planner,use_idm", [(True, True), (True, False),
                                                 (False, True)])
def test_losses_match_jax(small_pair, use_planner, use_idm):
    cfg, jagent = small_pair
    agent = _bridged(jagent, cfg)
    batch = _batch()
    rng = jax.random.PRNGKey(4)
    params = {"planner": jagent.planner_state.params,
              "idm": jagent.idm_state.params}
    _, want = _jit_loss(jagent)(params, _jax_prepared(jagent, batch), None,
                                rng, use_planner, use_idm, 1)
    draws = _jax_loss_draws(rng, jagent, 4, 9, use_planner=use_planner,
                            use_idm=use_idm)
    with torch.no_grad():
        loss, got = agent._loss(agent._prepare_train_batch(_torch_batch(batch)),
                                use_planner, use_idm, draws=draws)
    _assert_metrics_close(got, want)
    assert float(want["loss"]) > 0.1


def test_weighted_idm_loss_matches_jax(small_pair):
    import dataclasses
    cfg, jagent = small_pair
    weights = (1.0,) * 6 + (4.0,)
    jagent = jagent.replace(config=jagent.config.replace(
        action_loss_weights=weights))
    agent = _bridged(jagent, cfg)
    agent.config = dataclasses.replace(agent.config,
                                       action_loss_weights=weights)
    batch = _batch(seed=1)
    rng = jax.random.PRNGKey(5)
    _, want = _jit_loss(jagent)({"idm": jagent.idm_state.params},
                                _jax_prepared(jagent, batch), None, rng,
                                False, True, 1)
    draws = _jax_loss_draws(rng, jagent, 4, 9, use_planner=False)
    with torch.no_grad():
        _, got = agent._loss(agent._prepare_train_batch(_torch_batch(batch)),
                             False, True, draws=draws)
    _assert_metrics_close(got, {"idm_loss": want["idm_loss"]})
    with pytest.raises(ValueError, match="positive"):
        LDPAgent.create(_small_config(action_loss_weights=[1] * 6 + [0]),
                        configs.SHAPE_META, device="cpu")


def test_gradients_match_jax(small_pair):
    """JAX's gradient pytree goes through the same bridge loaders as the
    params (Dense transposed, conv taps reordered, ConvTranspose flipped), so
    a wrong mapping shows here even where a square layer's forward hides it."""
    cfg, jagent = small_pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=2)
    rng = jax.random.PRNGKey(6)
    params = {"planner": jagent.planner_state.params,
              "idm": jagent.idm_state.params}
    grads, _ = jax.jit(jax.grad(jagent._loss, has_aux=True),
                       static_argnums=(4, 5, 6))(
        params, _jax_prepared(jagent, batch), None, rng, True, True, 1)
    draws = _jax_loss_draws(rng, jagent, 4, 9)
    metrics = agent.backward(_torch_batch(batch), True, True, draws=draws)
    want_norm = float(jstate.global_norm(grads))
    np.testing.assert_allclose(float(metrics["g_norm"]), want_norm, rtol=1e-5)
    obs_dim = agent.config.obs_dim
    p = cfg["planner"]
    gp = bridge.load_unet1d(ConditionalUnet1D(
        obs_dim, obs_dim, p["diffusion_step_embed_dim"], p["down_dims"],
        p["kernel_size"], p["n_groups"]), _np(grads["planner"]))
    i = cfg["idm_net"]
    gi = bridge.load_mlp_diffusion(MLPDiffusion(
        2 * obs_dim, 7, i["time_dim"], i["cond_hidden_dims"], "swish",
        i["n_blocks"], i["hidden_dim"]), _np(grads["idm"]))
    for want_net, net in ((gp, agent.planner), (gi, agent.idm)):
        scale = max(float(w.detach().abs().max())
                    for w in want_net.parameters())
        for (name, w), g in zip(want_net.named_parameters(), net.parameters()):
            np.testing.assert_allclose(g.grad.numpy(), w.detach().numpy(),
                                       atol=1e-5 * scale, rtol=0,
                                       err_msg=name)


def test_one_update_matches_jax(small_pair):
    """One ``update`` at step 0 (the schedule's end_lr, 1e-4, so every
    weight moves by up to 1e-4): the updated weights through the bridge and
    the metrics, lr and step included."""
    cfg, jagent = small_pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=3)
    rng = jax.random.PRNGKey(7)
    new, want = jagent.update(jax.tree_util.tree_map(jnp.asarray, batch),
                              rng, 0)
    draws = _jax_loss_draws(rng, jagent, 4, 9)
    got = agent.update(_torch_batch(batch), 0, draws=draws)
    _assert_metrics_close(got, want)
    moved = _bridged(new, cfg)
    for mine, theirs in ((agent.planner, moved.planner),
                         (agent.idm, moved.idm)):
        for (name, p), q in zip(mine.named_parameters(), theirs.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)
    assert agent.planner_state.step == agent.idm_state.step == 1


@pytest.mark.parametrize("step", [0, 1, 2, 3, 6, 9])
def test_gates_match_jax(small_pair, step):
    """Planner from step 2 until 6, IDM every 3rd step from 3."""
    import dataclasses
    cfg, jagent = small_pair
    gates = dict(update_idm_every=3, update_idm_after=3,
                 update_planner_until=6, update_planner_after=2)
    jagent = jagent.replace(config=jagent.config.replace(**gates))
    agent = LDPAgent.create(_small_config(**gates), configs.SHAPE_META,
                            device="cpu")
    want = (2 <= step < 6, step >= 3 and step % 3 == 0)
    assert jagent._gates(step) == agent._gates(step) == want
    assert dataclasses.asdict(agent.config)["update_idm_every"] == 3


def test_sample_plan_stats_matches_jax(small_pair):
    cfg, jagent = small_pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=4)
    rng = jax.random.PRNGKey(8)
    want = jagent.sample_plan_stats(jax.tree_util.tree_map(jnp.asarray, batch),
                                    rng)
    x_plan = np.array(jax.random.normal(jax.random.split(rng)[1],
                                        (4, 8, agent.config.obs_dim)))
    got = agent.sample_plan_stats(_torch_batch(batch),
                                  draws={"planner": x_plan})
    _assert_metrics_close(got, want, rtol=1e-4)


def test_bench_checkpoint_losses_match_jax():
    """The committed bench checkpoint at full width, restored by the JAX
    package's Checkpointer and bridged: the losses on a fixed batch with
    JAX's draws (forward only)."""
    import yaml
    from latent_diffusion_planning_tpu.train.checkpoint import (
        Checkpointer as JaxCheckpointer, apply_params_snapshot as japply)
    from latent_diffusion_planning_tpu.utils.config import _configify, instantiate
    cfg_j = _configify(yaml.safe_load((CKPT / "config.yaml").read_text()))
    shape_meta = configs.SHAPE_META
    agent_cfg = dict(cfg_j.agent)
    agent_cfg.pop("vae_pretrain_path", None)
    snap = JaxCheckpointer(CKPT).restore_raw(CKPT / "agent.ckpt")
    agent_cfg.update(fused_sampler=False, vae_params=snap["vae_params"])
    jagent = instantiate(agent_cfg, jax.random.PRNGKey(0), None, shape_meta)
    jagent = japply(jagent, snap)
    agent = bridge.ldp_agent_from_flax(_np(snap), configs.bench_train_config()
                                       ["agent"], shape_meta, device="cpu")
    batch = _batch(B=2, seed=5)
    rng = jax.random.PRNGKey(9)
    params = {"planner": jagent.planner_state.params,
              "idm": jagent.idm_state.params}
    _, want = _jit_loss(jagent)(params, _jax_prepared(jagent, batch), None,
                                rng, True, True, 1)
    draws = _jax_loss_draws(rng, jagent, 2, 9)
    with torch.no_grad():
        _, got = agent._loss(agent._prepare_train_batch(_torch_batch(batch)),
                             True, True, draws=draws)
    for k in ("plan_loss", "idm_loss", "loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)


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
    """The whole slice at a small size on the CPU: scripted demos on the
    kinematic ``LiftEnv`` (rendered), welded in memory, latents from the
    agent's VAE, 30 steps of ``Workspace.run`` (ending with its snapshot and
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
    port's format; restoring it onto a seeded agent gives the weights the
    bridge gives."""
    import importlib.util
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
    apply_params_snapshot(agent, ck.restore_raw(ck.list_checkpoints()[-1]))
    want = bridge.ldp_agent_from_flax(
        _np(JaxCheckpointer(CKPT).restore_raw(CKPT / "agent.ckpt")),
        configs.bench_agent_config(), configs.SHAPE_META, device="cpu")
    for name in ("planner", "idm", "vae"):
        for (k, p), q in zip(getattr(agent, name).state_dict().items(),
                             getattr(want, name).state_dict().values()):
            assert torch.equal(p, q), (name, k)
