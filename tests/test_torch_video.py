"""Eval videos in the port: ``run_batched_eval(video_envs=K)`` against the
JAX engine's ``videos``, ``save_video``'s animated PNG decoded here with
zlib alone, the ``Workspace`` eval's video files, and the refusals.

The engine comparison drives both engines with the deterministic
observation policy of ``tests/test_torch_ldp.py`` from the JAX engine's
resets (handed to the port as ``init_states``), so the two runs take the
same actions and every frame is the same state rendered by each package;
the bar is the render tests': more than 98% of the pixels of every frame
within 2.0 (on 0..255).
"""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.envs import lift as jlift
from latent_diffusion_planning_tpu.rollout import engine as jengine
from latent_diffusion_planning_tpu_torch import configs
from latent_diffusion_planning_tpu_torch.envs import lift
from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
from latent_diffusion_planning_tpu_torch.rollout import engine
from latent_diffusion_planning_tpu_torch.utils import media
from test_torch_ldp import _jax_policy, _torch_policy
from test_torch_train import _small_config
from torch_thread import one_torch_thread  # noqa: F401


def _frac_close(a, b) -> float:
    return (np.abs(a.astype(np.float32) - b.astype(np.float32)).max(-1)
            < 2.0).mean()


def _jax_init(jenv, rng, n):
    """The JAX engine's resets, as the port's ``LiftState``."""
    reset_rng = jax.random.split(rng)[0]
    keys = jax.vmap(lambda s: jax.random.fold_in(reset_rng, s))(
        jnp.arange(n, dtype=jnp.int32))
    states, _ = jax.vmap(jenv.reset)(keys)
    return lift.LiftState(**{k: torch.from_numpy(np.array(getattr(states, k)))
                             for k in ("eef_pos", "gripper", "cube_pos",
                                       "cube_yaw", "grasped", "t")})


def test_videos_match_jax():
    """4 envs × 8 steps, 2 of them filmed: the same (K, T, H, W, 3) uint8
    frames as the JAX engine's, step by step, and the same episodes."""
    n, T, K = 4, 8, 2
    rng = jax.random.PRNGKey(5)
    jenv = jlift.LiftEnv(render_images=False)
    ref = jengine.run_batched_eval(jenv, None, n, rng, action_horizon=4,
                                   episode_len=T, video_envs=K,
                                   policy=_jax_policy)
    got = engine.run_batched_eval(lift.LiftEnv(render_images=False), None, n,
                                  action_horizon=4, episode_len=T,
                                  video_envs=K, policy=_torch_policy,
                                  init_states=_jax_init(jenv, rng, n),
                                  device="cpu")
    want = np.asarray(ref["videos"])
    assert got["videos"].dtype == np.uint8 and want.dtype == np.uint8
    assert got["videos"].shape == want.shape == (K, T, 64, 64, 3)
    for k in range(K):
        for t in range(T):
            assert _frac_close(got["videos"][k, t], want[k, t]) > 0.98, (k, t)
    # the frames move: the policy drives the arm
    assert np.abs(got["videos"][:, 0].astype(int)
                  - got["videos"][:, -1].astype(int)).max() > 0
    np.testing.assert_array_equal(got["per_episode"]["horizon"],
                                  np.asarray(ref["per_episode"]["horizon"]))


def test_finished_envs_are_filmed_frozen():
    """An env that is done is rendered from its frozen state: with a
    1-step episode every frame after the first repeats it."""
    env = lift.LiftEnv(render_images=False)
    got = engine.run_batched_eval(env, None, 2, action_horizon=4,
                                  episode_len=1, video_envs=1,
                                  policy=_torch_policy, device="cpu")
    v = got["videos"][0]
    assert v.shape == (4, 64, 64, 3)
    for t in range(1, 4):
        np.testing.assert_array_equal(v[t], v[0])


def _decode_apng(raw: bytes) -> np.ndarray:
    """An APNG of unfiltered 8-bit RGB frames, decoded with zlib."""
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, frames, chunks = 8, [], []
    while pos < len(raw):
        n, kind = struct.unpack_from(">I4s", raw, pos)
        body = raw[pos + 8:pos + 8 + n]
        crc, = struct.unpack_from(">I", raw, pos + 8 + n)
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks.append(kind)
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack_from(">IIBB", body)
            assert (depth, color) == (8, 2)
        elif kind == b"acTL":
            n_frames, _ = struct.unpack(">II", body)
        elif kind in (b"IDAT", b"fdAT"):
            data = zlib.decompress(body if kind == b"IDAT" else body[4:])
            rows = np.frombuffer(data, np.uint8).reshape(h, 1 + 3 * w)
            assert not rows[:, 0].any()
            frames.append(rows[:, 1:].reshape(h, w, 3))
    assert chunks[:2] == [b"IHDR", b"acTL"] and chunks[-1] == b"IEND"
    assert chunks.count(b"fcTL") == n_frames == len(frames)
    return np.stack(frames)


def test_save_video_round_trips_bit_for_bit(tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (5, 12, 16, 3),
                                               dtype=np.uint8)
    path = media.save_video(tmp_path / "clip" / "0_0.mp4", frames, fps=10)
    assert path == tmp_path / "clip" / "0_0.png"
    np.testing.assert_array_equal(_decode_apng(path.read_bytes()), frames)
    np.testing.assert_array_equal(media.read_video(path), frames)
    # float frames in [0, 255] are truncated as the engine's uint8 cast is
    again = media.save_video(tmp_path / "f.png", frames.astype(np.float32))
    np.testing.assert_array_equal(media.read_video(again), frames)


def test_workspace_eval_writes_two_videos(tmp_path):
    """A ``Workspace`` eval films ``min(2, n_eval_episodes)`` episodes into
    ``video/<step>_<i>.png``, each ``n_decisions · action_horizon`` frames
    of the eval env's camera."""
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
    cfg["agent"].update({k: v for k, v in _small_config().items()
                         if k in ("planner", "idm_net", "vae",
                                  "planner_n_diffusion_steps",
                                  "idm_n_diffusion_steps",
                                  "planner_inference_steps",
                                  "idm_inference_steps")})
    cfg.update(n_grad_steps=2, batch_size=4, log_every=0, save_every=0,
               eval_every=0, n_eval_episodes=3)
    cfg["data"].update(batch_size=4, eval_n_episode_overfit=None)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device="cpu")
    ws = Workspace(cfg, tmp_path, data=data, device="cpu")
    ws.init_agent()
    for w in welded.values():
        encode_latents(w, ws.agent.vae, ["agentview_image"])
    ws.run()
    files = sorted(p.name for p in (tmp_path / "video").iterdir())
    assert files == ["2_0.png", "2_1.png"]
    clip = media.read_video(tmp_path / "video" / "2_0.png")
    ah = cfg["action_horizon"]
    steps = -(-ws._env.episode_len // ah) * ah
    assert clip.shape == (steps, 64, 64, 3)


def test_viz_policy_and_refusals():
    """``agent_sample_viz_policy`` drives an LDP agent through
    ``sample_viz``; ``run_batched_eval_multi`` refuses videos."""
    agent = LDPAgent.create(_small_config(), configs.SHAPE_META, device="cpu")
    env = lift.LiftEnv(episode_len=4)
    res = engine.run_batched_eval(
        env, agent, 2, 3, action_horizon=4, episode_len=4,
        policy_obs_keys=configs.BENCH_POLICY_KEYS, video_envs=1,
        policy=engine.agent_sample_viz_policy, device="cpu")
    assert res["videos"].shape == (1, 4, 64, 64, 3)
    with pytest.raises(ValueError, match="no videos"):
        engine.run_batched_eval_multi(env, [agent], 2, [0], video_envs=1,
                                      device="cpu")
