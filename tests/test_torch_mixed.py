"""The port's mixed and action-free data path against the JAX package's:
the mixed window sampler, the mixed dataset facade, ``update_mixed``, policy
data collection with action noise, the ``optimal`` flag, the per-episode
resets, and a short ``Workspace`` run of each arm of the mixed-data study.

Tolerances: exact where neither side computes in floating point (gathers,
welds, loads, flags, measured bounds); 1e-6 for the folded step weights
(float32 weights against float32 logits through a softmax); 1e-5 for the
losses, gradients and one update (the bar of ``tests/test_torch_train.py``:
differently ordered fp32 sums); 1e-5 for the collection on the kinematic
``LiftEnv`` (a few fp32 operations a step over 24 steps) and 1e-3 on
``LiftPhysicsEnv`` (the JAX package's replay tolerance); 0.03 for the
shares of 4096 draws (over six standard deviations of a binomial share).
"""

from pathlib import Path
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.data import datasets as jdatasets
from latent_diffusion_planning_tpu.data import ingest as jingest
from latent_diffusion_planning_tpu.data import synthetic
from latent_diffusion_planning_tpu.data import windows as jwindows
from latent_diffusion_planning_tpu.data.writer import write_trajectories
from latent_diffusion_planning_tpu.envs import lift as jlift
from latent_diffusion_planning_tpu.models.agents import LDPAgent as JaxLDPAgent
from latent_diffusion_planning_tpu.models.agents import common as jcommon
from latent_diffusion_planning_tpu.rollout import engine as jengine
from latent_diffusion_planning_tpu.train import state as jstate
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.data import datasets, ingest, windows
from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
from latent_diffusion_planning_tpu_torch.envs import lift
from latent_diffusion_planning_tpu_torch.models.nets.mlp import MLPDiffusion
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.rollout import engine
from torch_thread import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


# ---------------------------------------------------------------------------
# the mixed window sampler
# ---------------------------------------------------------------------------

def _two_subs(seed=0):
    """Two welded sub-datasets (demos of 6, 1 and 4 steps, then of 3 and
    7), concatenated as JAX and as the port weld them."""
    rng = np.random.default_rng(seed)
    out = []
    for lengths in ([6, 1, 4], [3, 7]):
        lengths = np.array(lengths, np.int64)
        n = int(lengths.sum())
        arrays = {"a": rng.normal(size=(n, 3)).astype(np.float32),
                  "img": rng.integers(0, 256, (n, 2, 2, 3), dtype=np.uint8),
                  "actions": rng.normal(size=(n, 7)).astype(np.float32)}
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
            np.int64)
        out.append((arrays, starts, lengths))
    jparts = [jingest.WeldedDemos(arrays=a, demo_starts=s, demo_lengths=l,
                                  obs_keys=("a", "img"),
                                  dataset_keys=("actions",))
              for a, s, l in out]
    tparts = [ingest.WeldedDemos(
        arrays={k: torch.from_numpy(v) for k, v in a.items()},
        demo_starts=torch.from_numpy(s), demo_lengths=torch.from_numpy(l),
        obs_keys=("a", "img"), dataset_keys=("actions",)) for a, s, l in out]
    return (jingest.concat_welded(jparts), ingest.concat_welded(tparts),
            [p.total_steps for p in jparts])


def _mixed_pair(fs, sl, probs, step_weights=None):
    jcat, tcat, sizes = _two_subs()
    offsets = [0, sizes[0]]
    jmix = jwindows.MixedDeviceDataset.create(
        jwindows.DeviceDataset.from_welded(jcat, fs, sl), offsets, sizes,
        probs, step_weights=step_weights)
    mix = windows.MixedDeviceDataset.create(
        windows.DeviceDataset.from_welded(tcat, fs, sl, device="cpu"),
        offsets, sizes, probs,
        step_weights=None if step_weights is None
        else torch.from_numpy(step_weights))
    return jmix, mix, offsets, sizes


@pytest.mark.parametrize("fs,sl", [(1, 9), (2, 4)])
def test_mixed_batches_match_jax_with_its_draws(fs, sl):
    """JAX's sub-dataset choice and uniform draw handed in: the gathered
    windows are JAX's bit for bit."""
    jmix, mix, _, _ = _mixed_pair(fs, sl, [0.7, 0.3])
    rng = jax.random.PRNGKey(fs + 10 * sl)
    want = jmix.sample(rng, 64)
    d_rng, u_rng = jax.random.split(rng)
    choice = np.array(jax.random.categorical(d_rng, jnp.log(jmix.probs),
                                             shape=(64,)))
    u = np.array(jax.random.uniform(u_rng, (64,)))
    got = mix.sample(64, choice=torch.from_numpy(choice),
                     u=torch.from_numpy(u))
    for k in ("a", "img"):
        np.testing.assert_array_equal(got["obs"][k].numpy(),
                                      np.asarray(want["obs"][k]), err_msg=k)
    np.testing.assert_array_equal(got["actions"].numpy(),
                                  np.asarray(want["actions"]))
    assert 0 < choice.sum() < 64


def test_folded_step_weights_match_jax():
    """Step weights fold into one weight per step that normalises to JAX's
    ``softmax(sample_logits)``."""
    _, _, sizes = _two_subs()
    w = np.random.default_rng(1).uniform(0.5, 5.0, sum(sizes)).astype(
        np.float32)
    jmix, mix, _, _ = _mixed_pair(1, 2, [0.8, 0.2], step_weights=w)
    want = np.asarray(jax.nn.softmax(jmix.dataset.sample_logits))
    got = mix.dataset.sample_weights.double()
    np.testing.assert_allclose((got / got.sum()).numpy(), want, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("weighted", [False, True])
def test_sub_dataset_shares_match_probs(weighted):
    """4096 draws: the share of each sub-dataset, judged by index against
    the offsets, is its probability (step weights do not move it)."""
    _, _, sizes = _two_subs()
    w = (np.random.default_rng(2).uniform(0.5, 5.0, sum(sizes)).astype(
        np.float32) if weighted else None)
    _, mix, offsets, _ = _mixed_pair(1, 2, [0.7, 0.3], step_weights=w)
    idx = mix.indices(4096, torch.Generator().manual_seed(3))
    assert idx.min() >= 0 and idx.max() < sum(sizes)
    share = float((idx >= offsets[1]).float().mean())
    assert abs(share - 0.3) < 0.03, share


# ---------------------------------------------------------------------------
# the mixed dataset facade
# ---------------------------------------------------------------------------

OBS_SHAPES = {"robot0_eef_pos": (3,), "agentview_image": (8, 8, 3)}
MIXED_META = {
    "lowdim_obs": ["robot0_eef_pos", "optimal"],
    "rgb_obs": ["latent_agentview_image"],
    "shape_meta": {"ac_dim": 7, "all_shapes": {}},
    "obs_normalization": {"obs": {}, "actions": {}}}


@pytest.fixture(scope="module")
def mixed_files(tmp_path_factory):
    """An expert file of 4 demos, a suboptimal one of 3, an eval file of 3,
    each with a latent companion."""
    d = tmp_path_factory.mktemp("mixed")
    out = {}
    for name, n, seed in (("expert", 4, 0), ("subopt", 3, 1), ("eval", 3, 2)):
        src = synthetic.write_robomimic_hdf5(
            d / f"{name}.hdf5", n_demos=n, demo_len=9 + seed,
            obs_shapes=OBS_SHAPES, image_keys=("agentview_image",),
            seed=seed)
        lat = synthetic.write_latent_hdf5(d / f"{name}_latent.hdf5", src,
                                          ["agentview_image"], latent_dim=16,
                                          seed=seed)
        out[name] = (str(src), str(lat))
    return out


def _facade_kw(mixed_files):
    return dict(name="m", meta=MIXED_META, batch_size=8, obs_horizon=1,
                seq_length=4, train_split=[0.6, 0.4],
                train_n_episode_overfit=[2, None], eval_n_episode_overfit=2,
                stats_from_data=["robot0_eef_pos", "actions"],
                env_params={"env": {"name": "LiftEnv"}})


def _assert_welded_equal(got, want):
    assert set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        assert _np(got.arrays[k]).dtype == v.dtype, k
        np.testing.assert_array_equal(_np(got.arrays[k]), v, err_msg=k)
    np.testing.assert_array_equal(_np(got.demo_starts), want.demo_starts)
    np.testing.assert_array_equal(_np(got.demo_lengths), want.demo_lengths)
    assert tuple(got.obs_keys) == tuple(want.obs_keys)


def test_mixed_offline_data_matches_jax(mixed_files):
    """From the HDF5 files: the concatenated train subs, the ``optimal``
    flags (1 on the expert sub, 0 on the other), the bounds measured over
    the concatenation, the mixture's offsets, sizes and probabilities, and
    the eval split equal JAX's."""
    (e, el), (s, sl), (v, vl) = (mixed_files[k] for k in
                                 ("expert", "subopt", "eval"))
    kw = _facade_kw(mixed_files)
    want = jdatasets.MixedOfflineData(
        train_paths=[e, s], eval_paths=v, train_latent_paths=[el, sl],
        eval_latent_paths=vl, **kw)
    got = datasets.MixedOfflineData(
        train_paths=[e, s], eval_paths=[v], train_latent_paths=[el, sl],
        eval_latent_paths=[vl], device="cpu", **kw)
    _assert_welded_equal(got.welded("train"), want._cat_welded)
    flags = got.welded("train").arrays["optimal"][:, 0]
    n_expert = int(got.welded("train").demo_lengths[:2].sum())
    assert flags[:n_expert].eq(1).all() and flags[n_expert:].eq(0).all()
    assert got.meta == want.meta
    jmix, mix = want._train_mixed(), got.device_dataset("train")
    for a, b in ((mix.sub_offsets, jmix.sub_offsets),
                 (mix.sub_sizes, jmix.sub_sizes), (mix.probs, jmix.probs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want._eval_dataset()
    _assert_welded_equal(got.welded("eval"), want._eval_welded)
    assert got.welded("eval").arrays["optimal"].eq(1).all()
    np.testing.assert_array_equal(
        got.sample_traj("eval", 1)["obs"]["robot0_eef_pos"].numpy(),
        jwindows.sample_traj(want._eval_welded, 1)["obs"]["robot0_eef_pos"])
    with pytest.raises(ValueError, match="eval split"):
        got.sample_traj("train", 0)


def test_mixed_offline_data_from_welded_parts(mixed_files):
    """Parts handed in welded (each with ``optimal`` 1, as
    ``weld_collection`` writes it) give the facade of the files: the flag
    is set per sub, and the loaders draw the same batches from ``seed`` and
    ``seed + 1``."""
    (e, el), (s, sl), (v, vl) = (mixed_files[k] for k in
                                 ("expert", "subopt", "eval"))
    keys = ("robot0_eef_pos", "agentview_image", "latent_agentview_image",
            "optimal")
    load = lambda p, lat: ingest.load_robomimic(p, keys, latent_path=lat)
    kw = _facade_kw(mixed_files)
    by_path = datasets.MixedOfflineData(
        train_paths=[e, s], eval_paths=v, train_latent_paths=[el, sl],
        eval_latent_paths=vl, device="cpu", **kw)
    welded = datasets.MixedOfflineData(
        train=[load(e, el), load(s, sl)], eval=load(v, vl), device="cpu",
        **kw)
    for split in ("train", "eval"):
        a, b = welded.welded(split), by_path.welded(split)
        assert set(a.arrays) == set(b.arrays)
        for k in a.arrays:
            assert torch.equal(a.arrays[k], b.arrays[k]), (split, k)
    assert welded.meta == by_path.meta
    for a, b in ((welded.train_dataloader(), by_path.train_dataloader()),
                 (welded.eval_dataloader(), by_path.eval_dataloader())):
        x, y = next(a), next(b)
        for k in x["obs"]:
            assert torch.equal(x["obs"][k], y["obs"][k]), k
        assert torch.equal(x["actions"], y["actions"])
    # the train loader draws from a generator seeded with ``seed``
    first = welded.device_dataset("train").sample(
        8, torch.Generator().manual_seed(0))
    assert torch.equal(next(welded.train_dataloader())["actions"],
                       first["actions"])
    assert welded.env_meta is None


def test_mixed_offline_data_refuses_what_jax_refuses(mixed_files):
    (e, _), (s, _) = mixed_files["expert"], mixed_files["subopt"]
    kw = dict(name="m", meta=MIXED_META, eval_paths=e, device="cpu")
    with pytest.raises(ValueError, match="pair"):
        datasets.MixedOfflineData(train_paths=[e, s],
                                  train_latent_paths=[e], **kw)
    with pytest.raises(ValueError, match="scalar"):
        datasets.MixedOfflineData(train_paths=[e, s],
                                  train_latent_paths=e, **kw)
    with pytest.raises(ValueError, match="sum"):
        datasets.MixedOfflineData(train_paths=[e, s],
                                  train_split=[0.5, 0.6], **kw)
    d = datasets.MixedOfflineData(train_paths=[e, s], train_split=0.25, **kw)
    assert d.train_split == [0.25, 0.75]


# ---------------------------------------------------------------------------
# update_mixed against the JAX agent
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
               warmup_steps=2, decay_steps=10, ema_decay=0.5)
    cfg.update(over)
    return cfg


def _seeded_params(shapes, seed):
    """Weights for a Flax tree of shapes, drawn with numpy: kernels at
    variance 1 / fan_in, norm scales about 1, biases about 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(
                int(np.prod(leaf.shape[:-1])))
        elif name == "scale":
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        else:
            v = 0.2 * rng.normal(size=leaf.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX LDPAgent of ``_small_config`` (weights drawn with numpy
    through ``jax.eval_shape`` in place of Flax's eager ``init``) and its
    config."""
    cfg = _small_config()
    orig = flax.linen.Module.init

    def init(module, rngs, *args, **kwargs):
        shapes = jax.eval_shape(
            lambda r, *a: orig(module, r, *a, **kwargs), rngs, *args)
        return {"params": _seeded_params(shapes["params"], 0)}
    pkg = "latent_diffusion_planning_tpu.models.nets."
    train_keys = ("lr", "end_lr", "idm_lr", "idm_end_lr", "warmup_steps",
                  "decay_steps", "grad_clip", "ema_decay", "alpha_planner",
                  "alpha_idm", "update_planner_every", "update_idm_every",
                  "update_idm_after", "update_planner_until",
                  "update_planner_after")
    with mock.patch.object(flax.linen.Module, "init", init):
        jagent = JaxLDPAgent.create(
            jax.random.PRNGKey(0), None, configs.SHAPE_META,
            planner={"_target_": pkg + "unet1d.ConditionalUnet1D",
                     **cfg["planner"]},
            idm_net={"_target_": pkg + "mlp.MLPDiffusion", **cfg["idm_net"]},
            vae=cfg["vae"], vae_feature_dim=16, lowdim_obs=cfg["lowdim_obs"],
            rgb_obs=cfg["rgb_obs"], obs_normalization=cfg["obs_normalization"],
            obs_horizon=1, pred_horizon=8, action_horizon=4,
            planner_n_diffusion_steps=cfg["planner_n_diffusion_steps"],
            idm_n_diffusion_steps=cfg["idm_n_diffusion_steps"],
            planner_inference_steps=cfg["planner_inference_steps"],
            idm_inference_steps=cfg["idm_inference_steps"],
            fused_sampler=False,
            **{k: cfg[k] for k in train_keys if k in cfg})
    return cfg, jagent


def _bridged(jagent, cfg):
    snap = {"planner_params": _tree_np(jagent.planner_state.params),
            "idm_params": _tree_np(jagent.idm_state.params),
            "vae_params": _tree_np(jagent.vae_params)}
    return bridge.ldp_agent_from_flax(snap, cfg, configs.SHAPE_META,
                                      device="cpu")


def _batch(B, H=9, seed=0):
    """A raw latent-form training batch."""
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


def _jax_mixed_draws(rng, jagent, B, H, Bm, Hm, A=7):
    """The draws JAX ``_loss`` takes from ``rng`` with a mixed batch: the
    planner's sized by the expert batch, the IDM's by the mixed batch's
    transition pairs."""
    D = jagent.config.obs_dim
    rng, sub = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(sub)
    out = {"plan_t": np.array(jax.random.randint(
               t_rng, (B,), 0, jagent.planner_sched.num_steps)),
           "plan_noise": np.array(jax.random.normal(n_rng, (B, H - 1, D)))}
    rng, sub = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(sub)
    n = Bm * (Hm - 1)
    out["idm_t"] = np.array(jax.random.randint(
        t_rng, (n,), 0, jagent.idm_sched.num_steps))
    out["idm_noise"] = np.array(jax.random.normal(n_rng, (n, A)))
    return out


def _jax_prepared(jagent, batch):
    b = jcommon.prepare_batch(jax.tree_util.tree_map(jnp.asarray, batch),
                              jagent.obs_normalization)
    b["obs"] = jagent._encode_obs(b["obs"])
    return b


def _assert_metrics_close(got, want, rtol=1e-5):
    for k, v in want.items():
        assert k in got, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                   atol=1e-6, err_msg=k)


def test_mixed_losses_and_gradients_match_jax(jax_pair):
    """An expert batch of 4 windows and a mixed one of 6: the losses,
    ``action_min``/``action_max`` (the mixed batch's), the global norm and
    every gradient through the bridge's loaders."""
    cfg, jagent = jax_pair
    agent = _bridged(jagent, cfg)
    batch, mixed = _batch(4, seed=1), _batch(6, seed=2)
    mixed["actions"] *= 0.5     # inside the clip, unlike the expert batch's
    rng = jax.random.PRNGKey(6)
    params = {"planner": jagent.planner_state.params,
              "idm": jagent.idm_state.params}
    grads, want = jax.jit(jax.grad(jagent._loss, has_aux=True),
                          static_argnums=(4, 5, 6))(
        params, _jax_prepared(jagent, batch), _jax_prepared(jagent, mixed),
        rng, True, True, 1)
    draws = _jax_mixed_draws(rng, jagent, 4, 9, 6, 9)
    got = agent.backward(_torch_batch(batch), True, True, draws=draws,
                         mixed_batch=_torch_batch(mixed))
    _assert_metrics_close(got, want)
    np.testing.assert_allclose(float(got["action_max"]),
                               float(mixed["actions"].max()), rtol=1e-6)
    np.testing.assert_allclose(float(got["g_norm"]),
                               float(jstate.global_norm(grads)), rtol=1e-5)
    obs_dim = agent.config.obs_dim
    p, i = cfg["planner"], cfg["idm_net"]
    gp = bridge.load_unet1d(ConditionalUnet1D(
        obs_dim, obs_dim, p["diffusion_step_embed_dim"], p["down_dims"],
        p["kernel_size"], p["n_groups"]), _tree_np(grads["planner"]))
    gi = bridge.load_mlp_diffusion(MLPDiffusion(
        2 * obs_dim, 7, i["time_dim"], i["cond_hidden_dims"], "swish",
        i["n_blocks"], i["hidden_dim"]), _tree_np(grads["idm"]))
    for want_net, net in ((gp, agent.planner), (gi, agent.idm)):
        scale = max(float(w.detach().abs().max())
                    for w in want_net.parameters())
        for (name, w), g in zip(want_net.named_parameters(), net.parameters()):
            np.testing.assert_allclose(g.grad.numpy(), w.detach().numpy(),
                                       atol=1e-5 * scale, rtol=0,
                                       err_msg=name)


def test_one_update_mixed_matches_jax(jax_pair):
    """``update_mixed`` at step 0: the metrics, and each net's weights and
    EMA weights after the step."""
    cfg, jagent = jax_pair
    agent = _bridged(jagent, cfg)
    batch, mixed = _batch(4, seed=3), _batch(5, seed=4)
    rng = jax.random.PRNGKey(7)
    new, want = jagent.update_mixed(
        jax.tree_util.tree_map(jnp.asarray, batch),
        jax.tree_util.tree_map(jnp.asarray, mixed), rng, 0)
    draws = _jax_mixed_draws(rng, jagent, 4, 9, 5, 9)
    got = agent.update_mixed(_torch_batch(batch), _torch_batch(mixed), 0,
                             draws=draws)
    _assert_metrics_close(got, want)
    for attr, ema in (("params", False), ("ema_params", True)):
        moved = bridge.ldp_agent_from_flax(
            {"planner_params": _tree_np(getattr(new.planner_state, attr)),
             "idm_params": _tree_np(getattr(new.idm_state, attr)),
             "vae_params": _tree_np(new.vae_params)}, cfg, configs.SHAPE_META,
            device="cpu")
        for name in ("planner", "idm"):
            mine = getattr(agent, f"{name}_state")
            mine = mine.ema if ema else getattr(agent, name)
            for (pname, p), q in zip(mine.named_parameters(),
                                     getattr(moved, name).parameters()):
                np.testing.assert_allclose(p.detach().numpy(),
                                           q.detach().numpy(), atol=1e-5,
                                           rtol=0, err_msg=f"{attr} {pname}")
    assert agent.planner_state.step == agent.idm_state.step == 1


def test_idm_loss_reads_the_mixed_batch_only():
    """With the draws fixed: new actions in the expert batch move neither
    loss; a new mixed batch moves the IDM's loss and not the planner's."""
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import (
        LDPAgent)
    agent = LDPAgent.create(_small_config(), configs.SHAPE_META,
                            device="cpu")
    D = agent.config.obs_dim
    g = torch.Generator().manual_seed(0)
    draws = {"plan_t": torch.randint(0, 12, (4,), generator=g),
             "plan_noise": torch.randn(4, 8, D, generator=g),
             "idm_t": torch.randint(0, 12, (32,), generator=g),
             "idm_noise": torch.randn(32, 7, generator=g)}
    batch, mixed = _batch(4, seed=5), _batch(4, seed=6)
    loss = lambda b, m: agent._loss(
        agent._prepare_train_batch(_torch_batch(b)), True, True, draws=draws,
        mixed_batch=agent._prepare_train_batch(_torch_batch(m)))[1]
    base = loss(batch, mixed)
    other_actions = dict(batch, actions=_batch(4, seed=7)["actions"])
    same = loss(other_actions, mixed)
    moved = loss(batch, _batch(4, seed=8))
    assert float(same["idm_loss"]) == float(base["idm_loss"])
    assert float(same["plan_loss"]) == float(base["plan_loss"])
    assert float(moved["idm_loss"]) != float(base["idm_loss"])
    assert float(moved["plan_loss"]) == float(base["plan_loss"])
    assert float(base["idm_loss"]) > 0 and float(base["plan_loss"]) > 0


# ---------------------------------------------------------------------------
# policy data collection, the optimal flag and the per-episode resets
# ---------------------------------------------------------------------------

def _policy_core(xp, rel, vel, grip, chunk):
    """Servo to the cube (led by its last relative motion), close when on
    it, then lift (xp: jnp or torch); every step of a chunk repeats the
    move at a quarter speed."""
    target = rel + 0.5 * vel
    on_cube = xp.sqrt((rel * rel).sum(-1)) < 0.02
    closed = grip < 0.03
    target = xp.where(closed[:, None], xp.zeros_like(rel) + 0.1, target)
    step = xp.clip(target / 0.2, -1.0, 1.0)
    close = xp.where(on_cube | closed, 1.0, -1.0)
    moves = xp.concatenate([step, xp.zeros_like(step)], -1)[:, None, :]
    grips = xp.zeros_like(moves[..., :1]) + close[:, None, None]
    return xp.concatenate([moves, grips], -1) + xp.zeros((1, chunk, 1))


def _inputs(window):
    obj = window["object"]
    return obj[:, -1, 7:10], obj[:, -1, 7:10] - obj[:, 0, 7:10], \
        window["robot0_gripper_qpos"][:, -1, 0]


def _jax_policy(agent, window, rng):
    return _policy_core(jnp, *_inputs(window), 8)


class _TorchNS:
    sqrt, where, clip, zeros_like = (torch.sqrt, torch.where, torch.clamp,
                                     torch.zeros_like)
    concatenate = staticmethod(torch.cat)
    zeros = staticmethod(torch.zeros)


def _torch_policy(agent, window, gen):
    return _policy_core(_TorchNS, *_inputs(window), 8)


def _lift_state(states):
    return lift.LiftState(**{k: torch.from_numpy(np.array(getattr(states, k)))
                             for k in ("eef_pos", "gripper", "cube_pos",
                                       "cube_yaw", "grasped", "t")})


def _jax_collection(jenv, n, T, rng, obs_horizon, noise):
    """JAX's host-loop collection and what it draws: its resets and the
    action noise of each decision, (n_decisions, N, action_horizon, A)."""
    ref = jengine.run_data_collection(
        jenv, None, n, rng, obs_horizon=obs_horizon, action_horizon=4,
        episode_len=T, action_noise=noise, policy=_jax_policy,
        host_loop=True)
    reset_rng, policy_rng = jax.random.split(rng)
    states, _ = jax.vmap(jenv.reset)(jengine._reset_rngs(
        reset_rng, jnp.arange(n, dtype=jnp.int32)))
    draws = np.stack([np.asarray(jax.random.normal(
        jax.random.split(d)[1], (n, 4, 7)))
        for d in jax.random.split(policy_rng, -(-T // 4))])
    return ref, states, draws


def _assert_collections_close(got, ref, tol):
    for k in ref["obs"]:
        np.testing.assert_allclose(got["obs"][k].numpy(), ref["obs"][k],
                                   atol=tol, err_msg=k)
        np.testing.assert_allclose(got["first_obs"][k].numpy(),
                                   ref["first_obs"][k], atol=tol, err_msg=k)
    np.testing.assert_allclose(got["actions"].numpy(), ref["actions"],
                               atol=tol)
    np.testing.assert_allclose(got["rewards"].numpy(), ref["rewards"],
                               atol=tol)
    np.testing.assert_array_equal(got["success"].numpy(), ref["success"])


@pytest.mark.parametrize("obs_horizon", [1, 2])
def test_run_data_collection_matches_jax(tmp_path, obs_horizon):
    """The kinematic ``LiftEnv`` under a deterministic observation policy
    with noise 0.3, from the JAX engine's resets and with its noise draws
    handed in: observations, the noised actions, rewards and success; then
    the unsuccessful episodes welded in memory equal
    ``write_trajectories`` → ``load_robomimic`` of JAX's collection."""
    n, T = 8, 24
    jenv = jlift.LiftEnv(render_images=False)
    ref, states, draws = _jax_collection(jenv, n, T, jax.random.PRNGKey(3),
                                         obs_horizon, 0.3)
    got = engine.run_data_collection(
        lift.LiftEnv(render_images=False), None, n, obs_horizon=obs_horizon,
        action_horizon=4, episode_len=T, action_noise=0.3,
        policy=_torch_policy, init_states=_lift_state(states),
        noise_draws=torch.from_numpy(draws), device="cpu")
    _assert_collections_close(got, ref, 1e-5)
    ok = ref["success"].any(1)
    assert 0 < ok.sum() < n, ok
    path = tmp_path / "subopt.hdf5"
    keys = ("robot0_eef_pos", "object", "optimal")
    n_kept = write_trajectories(path, ref, unsuccessful_only=True,
                                max_demos=3)
    want = jingest.load_robomimic(str(path), keys)
    welded = weld_collection(got, obs_keys=keys, unsuccessful_only=True,
                             max_demos=3)
    assert welded.n_demos == n_kept == min(3, int((~ok).sum()))
    for k, v in want.arrays.items():
        np.testing.assert_allclose(welded.arrays[k].numpy(), v, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(welded.demo_lengths.numpy(),
                                  want.demo_lengths)


@pytest.mark.slow       # minutes of XLA compile for the JAX physics decision
def test_run_data_collection_on_lift_physics_matches_jax():
    """The same on ``LiftPhysicsEnv``, 2 envs × 8 steps with noise 0.1, at
    the JAX package's replay tolerance (1e-3). The policy plays the golden
    fixture's first 4 actions at every decision whatever it sees (JAX
    traces the decision once, so it must be a pure function): the two
    engines' cubes at rest already differ by up to 7e-4 (contacts feed fp32
    differences forward), and the servo policy would carry that into its
    actions and amplify it at the first finger contact (7e-3 there), as the
    closed-loop eval test notes; the loop's feedback is held on the
    kinematic env."""
    from latent_diffusion_planning_tpu.envs import lift_physics as jlp
    from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
    from latent_diffusion_planning_tpu_torch.envs import physics as ph
    n, T = 2, 8
    golden = np.load(Path(__file__).parent / "fixtures" / "replay_golden.npz")
    chunk = np.repeat(golden["lift_actions"][None, :4], n, 0)

    def replay(asarray):
        return lambda agent, window, rng: asarray(chunk)
    rng = jax.random.PRNGKey(5)
    jenv = jlp.LiftPhysicsEnv(render_images=False)
    ref = jengine.run_data_collection(
        jenv, None, n, rng, action_horizon=4, episode_len=T,
        action_noise=0.1, policy=replay(jnp.asarray), host_loop=True)
    reset_rng, policy_rng = jax.random.split(rng)
    states, _ = jax.vmap(jenv.reset)(jengine._reset_rngs(
        reset_rng, jnp.arange(n, dtype=jnp.int32)))
    draws = np.stack([np.asarray(jax.random.normal(
        jax.random.split(d)[1], (n, 4, 7)))
        for d in jax.random.split(policy_rng, 2)])
    t = lambda a: torch.from_numpy(np.array(a))
    init = lp.LiftPhysState(
        bodies=ph.RigidBody(**{f: t(getattr(states.bodies, f))
                               for f in ("pos", "quat", "linvel", "angvel")}),
        **{f: t(getattr(states, f)) for f in ("qpos", "eef_target", "gripper",
                                              "cube_yaw0", "t")})
    got = engine.run_data_collection(
        lp.LiftPhysicsEnv(render_images=False), None, n, action_horizon=4,
        episode_len=T, action_noise=0.1, policy=replay(torch.from_numpy),
        init_states=init, noise_draws=torch.from_numpy(draws), device="cpu")
    _assert_collections_close(got, ref, 1e-3)


@pytest.mark.parametrize("entry", ["eval", "collection"])
def test_add_optimal_hands_the_policy_ones(entry):
    seen = []

    def policy(agent, window, gen):
        seen.append(window)
        return torch.zeros(3, 4, 7)
    run = (engine.run_batched_eval if entry == "eval"
           else engine.run_data_collection)
    run(lift.LiftEnv(render_images=False), None, 3, obs_horizon=2,
        action_horizon=4, episode_len=8, policy=policy, add_optimal=True,
        policy_obs_keys=("robot0_eef_pos", "optimal"), device="cpu")
    assert len(seen) == 2
    for view in seen:
        assert set(view) == {"robot0_eef_pos", "optimal"}
        assert torch.equal(view["optimal"], torch.ones(3, 2, 1))


def _physics_env():
    from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
    return lp.LiftPhysicsEnv(render_images=False)


ENVS = {"kinematic": lambda: lift.LiftEnv(render_images=False),
        "physics": _physics_env}


def _run(entry, env, n, seed, episode_seeds=None):
    kw = dict(action_horizon=4, episode_len=8, policy=_torch_policy,
              episode_seeds=episode_seeds, device="cpu")
    if entry == "eval":
        return engine.run_batched_eval(env, None, n, seed,
                                       **kw)["per_episode"]
    col = engine.run_data_collection(env, None, n, seed, **kw)
    return {"first": col["first_obs"]["object"],
            "object": col["obs"]["object"], "success": col["success"]}


@pytest.mark.parametrize("env_name", ["kinematic", "physics"])
@pytest.mark.parametrize("entry", ["eval", "collection"])
def test_episode_resets_do_not_depend_on_the_run(entry, env_name):
    """Episode i's reset depends on the seed and its episode seed alone: the
    first 4 episodes of a 16-episode run are a 4-episode run, and episodes
    12–15 replay alone through ``episode_seeds``; another seed moves
    them."""
    env = ENVS[env_name]()
    full = _run(entry, env, 16, 5)
    head = _run(entry, env, 4, 5)
    tail = _run(entry, env, 4, 5, episode_seeds=torch.arange(12, 16))
    for k in full:
        v = torch.as_tensor(full[k])
        assert torch.equal(torch.as_tensor(head[k]), v[:4]), k
        assert torch.equal(torch.as_tensor(tail[k]), v[12:]), k
    other = _run(entry, env, 4, 6)
    key = "reward_sum" if entry == "eval" else "first"
    assert not torch.equal(torch.as_tensor(other[key]),
                           torch.as_tensor(head[key]))


def _spawn(state):
    pos = state.cube_pos if hasattr(state, "cube_pos") else (
        state.bodies.pos[:, 0])
    return torch.cat([pos[:, :2], (state.cube_yaw if hasattr(
        state, "cube_yaw") else state.cube_yaw0)[:, None]], 1)


@pytest.mark.parametrize("env_name", ["kinematic", "physics"])
def test_the_old_single_generator_draw_breaks_it(env_name):
    """The reset the port drew before: one generator seeded with the run's
    seed draws every env's spawn in order. A spawn is then a function of
    the episode's place in the draw, not of the episode: a run that holds
    episodes 12–15 only (4 envs) draws the spawns of episodes 0–3, so no
    episode outside a run's first ones can be replayed alone, and dropping
    or reordering episodes moves every spawn after it. (On the CPU the
    generator fills serially, so the old prefixes happen to agree; what
    breaks is the episode's identity.) The engine's hash keeps it."""
    env = ENVS[env_name]()
    old = lambda n: _spawn(env.reset_state(
        n, torch.Generator().manual_seed(5)))
    seeds = torch.arange(12, 16)

    def new(n, episode_seeds=None):
        return _spawn(engine._initial_states(
            env, n, 5, episode_seeds, None, torch.Generator()))
    full_old, full_new = old(16), new(16)
    assert not torch.equal(old(4), full_old[12:])
    assert torch.equal(new(4, seeds), full_new[12:])
    assert torch.equal(new(4), full_new[:4])
    # the order of the episodes does not matter either
    perm = torch.tensor([9, 2, 15, 0])
    assert torch.equal(new(4, perm), full_new[perm])


def test_reset_uniforms_are_uniform_and_bounded():
    u = engine.reset_uniforms(3, torch.arange(20000), 3)
    assert u.dtype == torch.float32 and u.min() >= 0 and u.max() < 1
    np.testing.assert_allclose(u.mean(0).numpy(), 0.5, atol=0.01)
    np.testing.assert_allclose(u.std(0).numpy(), 12 ** -0.5, atol=0.01)
    corr = np.corrcoef(u.numpy().T)
    assert np.abs(corr - np.eye(3)).max() < 0.03
    assert not torch.equal(u, engine.reset_uniforms(4, torch.arange(20000), 3))


# ---------------------------------------------------------------------------
# the three arms of the mixed-data study in the Workspace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def study_data():
    """Expert demos (the scripted kinematic expert, successes kept), a
    suboptimal corpus (the servo policy with noise 0.3, failures kept) and
    eval demos, rendered 64×64 and welded in memory."""
    env = lift.LiftEnv(episode_len=24)
    meta = {"env_name": "LiftEnv", "env_kwargs": {"episode_len": 24}}
    expert = weld_collection(engine.run_scripted_collection(
        env, 6, 0, device="cpu"), env_meta=meta, successful_only=True)
    evals = weld_collection(engine.run_scripted_collection(
        env, 2, 1, device="cpu"), env_meta=meta, successful_only=True)
    subopt = weld_collection(engine.run_data_collection(
        env, None, 6, 2, action_noise=0.3, policy=_torch_policy,
        device="cpu"), env_meta=meta, unsuccessful_only=True)
    assert expert.n_demos >= 4 and subopt.n_demos >= 1
    return {"expert": expert, "eval": evals, "subopt": subopt}


def _study_workspace(tmp_path, study_data, arm):
    from latent_diffusion_planning_tpu_torch.data.latents import encode_latents
    from latent_diffusion_planning_tpu_torch.train.loop import (Workspace,
                                                               make_data)
    cfg = configs.lift_mixed_study_config(arm, n_expert=4)
    cfg["agent"].update({k: v for k, v in _small_config(
        warmup_steps=5, decay_steps=200).items()
        if k in ("planner", "idm_net", "vae", "warmup_steps", "decay_steps",
                 "planner_n_diffusion_steps", "idm_n_diffusion_steps",
                 "planner_inference_steps", "idm_inference_steps")})
    cfg.update(n_grad_steps=10, batch_size=8, log_every=5, save_every=0,
               eval_every=0, n_eval_episodes=2)
    given = {"expert": dict(train=study_data["expert"],
                            eval=study_data["eval"]),
             "mixed": dict(train=[study_data["expert"], study_data["subopt"]],
                           eval=study_data["eval"])}
    facades = {}
    for section in ("data", "mixed_data"):
        if section in cfg:
            sec = cfg[section]
            sec.update(batch_size=8, eval_n_episode_overfit=None)
            sec["env_params"]["env"].update(episode_len=8)
            facades[section] = make_data(
                sec, "cpu", **given["mixed" if sec.get("mixed") else "expert"])
    ws = Workspace(cfg, tmp_path, data=facades["data"],
                   mixed_data=facades.get("mixed_data"), device="cpu")
    ws.init_agent()
    for w in study_data.values():
        if "latent_agentview_image" not in w.arrays:
            encode_latents(w, ws.agent.vae, ["agentview_image"])
    return ws


@pytest.mark.parametrize("arm", configs.MIXED_STUDY_ARMS)
def test_study_arm_trains_in_the_workspace(tmp_path, study_data, arm):
    """10 steps of each arm at small widths: the planner's stream is
    ``data`` and the IDM's ``mixed_data`` (``update_mixed`` on one batch of
    each), the action-free arm's planner stream is the mixed facade; every
    loss finite; the run ends with its snapshot and eval (a closed loop of
    2 episodes)."""
    from latent_diffusion_planning_tpu_torch.data.datasets import (
        MixedOfflineData, OfflineData)
    ws = _study_workspace(tmp_path, study_data, arm)
    kinds = {"expert": (OfflineData, type(None)),
             "mixed": (OfflineData, MixedOfflineData),
             "actionfree": (MixedOfflineData, OfflineData)}[arm]
    assert (type(ws.data), type(ws.mixed_data)) == kinds
    calls = []
    update_mixed = ws.agent.update_mixed

    def spy(batch, mixed_batch, step, generator=None, draws=None):
        calls.append((batch["actions"].shape[0],
                      mixed_batch["actions"].shape[0]))
        return update_mixed(batch, mixed_batch, step, generator, draws)
    ws.agent.update_mixed = spy
    ws.run()
    assert len(calls) == (0 if arm == "expert" else 10)
    curve = ws.loss_curve()
    for k in ("plan_loss", "idm_loss"):
        assert curve[k].shape == (10,) and torch.isfinite(curve[k]).all(), k
    ev = ws.last_eval
    assert ev["n_episodes"] == 2 and 0.0 <= ev["success"] <= 1.0
    assert np.isfinite(ev["eval_action_mse"])
    assert ws._env.episode_len == 8
    if arm == "actionfree":
        mix = ws.data.device_dataset("train")
        assert mix.sub_sizes.tolist() == [
            int(study_data["expert"].first_demos(4).total_steps),
            study_data["subopt"].total_steps]


def test_workspace_eval_hands_the_optimal_flag(tmp_path, study_data,
                                               monkeypatch):
    """When ``optimal`` is among the policy's observation keys, the
    closed loop hands it to the policy (``add_optimal``), as the JAX
    Workspace does; the study's meta does not name it."""
    from latent_diffusion_planning_tpu_torch.train import loop
    ws = _study_workspace(tmp_path, study_data, "mixed")
    assert "optimal" not in ws._policy_obs_keys()
    seen = {}

    def fake(*args, **kwargs):
        seen.update(kwargs)
        return {"metrics": {"success": 0.0, "reward": 0.0, "horizon": 8.0,
                            "avg_reward": 0.0, "n_episodes": 2}}
    monkeypatch.setattr(loop.rollout_engine, "run_batched_eval", fake)
    ws.eval()
    assert seen["add_optimal"] is False
    ws.data.meta = dict(ws.data.meta,
                        lowdim_obs=list(ws.data.meta["lowdim_obs"])
                        + ["optimal"])
    monkeypatch.setattr(ws.agent, "sample_action",
                        lambda batch, gen=None: torch.zeros(8, 8, 7))
    monkeypatch.setattr(ws.agent, "get_metrics", lambda batch, gen=None: {})
    monkeypatch.setattr(ws.agent, "sample_plan_stats",
                        lambda batch, gen=None: {})
    ws.eval()
    assert seen["add_optimal"] is True
    assert "optimal" in seen["policy_obs_keys"]
