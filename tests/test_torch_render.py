"""The port's renderer and kinematic Lift env vs the JAX package.

Renders are held at the JAX package's own renderer bar
(``tests/test_pallas_raycast.py``): more than 98% of pixels within 2.0 of
255, the rest being silhouette pixels whose nearest-hit ties resolve
differently in float. Env states and low-dim observations are fp32
arithmetic on the same inputs: atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.envs import lift as jlift
from latent_diffusion_planning_tpu.envs import mjcf
from latent_diffusion_planning_tpu.ops import render as JR
from latent_diffusion_planning_tpu_torch.envs import lift
from latent_diffusion_planning_tpu_torch.ops import render as R
from latent_diffusion_planning_tpu_torch.ops.kernels import raycast

STATE_ATOL = 1e-5


def _frac_close(a, b):
    return (np.abs(np.asarray(a) - np.asarray(b)).max(-1) < 2.0).mean()


def _jax_states(n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    states, _ = jax.vmap(jlift.LiftEnv(render_images=False).reset)(keys)
    return states


def _to_torch(states) -> lift.LiftState:
    return lift.LiftState(**{k: torch.from_numpy(np.array(getattr(states, k)))
                             for k in ("eef_pos", "gripper", "cube_pos",
                                       "cube_yaw", "grasped", "t")})


def test_lift_renders_match_jax():
    """LiftEnv scenes through the twin of the ray-cast kernel (what a CPU
    tensor runs) vs the JAX renderer; grasp and lift states included."""
    states = _jax_states(4)
    # move some envs: lift the cube with the eef, close the gripper
    states = states.replace(
        eef_pos=states.eef_pos.at[2].set(states.cube_pos[2]),
        cube_pos=states.cube_pos.at[2:, 2].add(0.1),
        gripper=states.gripper.at[1].set(0.2))
    ref = jax.vmap(jlift.LiftEnv().render)(states)
    got = lift.LiftEnv().render(_to_torch(states))
    assert got.shape == (4, 64, 64, 3)
    assert _frac_close(got.numpy(), ref) > 0.98


def _convex_scenes():
    dirs = mjcf.kdop_directions(26)
    verts = np.asarray([[0.04, 0, 0], [-0.04, 0, 0], [0, 0.04, 0],
                        [0, -0.04, 0], [0, 0, 0.05], [0, 0, -0.05]],
                       np.float32)
    hull = np.asarray(mjcf.fit_kdop(verts, dirs), np.float32)
    pad = np.zeros((26, 4), np.float32)
    pad[:, 3] = 1.0
    jscene = JR.Scene(
        pos=jnp.asarray([[0.05, 0.0, 0.88], [0.0, 0.1, 0.9]]),
        rot=jnp.stack([JR.euler_z(jnp.asarray(0.4)), jnp.eye(3)]),
        size=jnp.asarray([[0.04, 0.04, 0.05], [0.03, 0.0, 0.0]]),
        color=jnp.asarray([[0.85, 0.1, 0.1], [0.2, 0.4, 0.8]]),
        kind=jnp.asarray([2, 1], jnp.int32),
        plane_z=jnp.asarray(0.8, jnp.float32),
        planes=jnp.stack([jnp.asarray(hull), jnp.asarray(pad)]))
    t = lambda a, dt=torch.float32: torch.from_numpy(np.array(a)).to(dt)[None]
    scene = R.Scene(pos=t(jscene.pos), rot=t(jscene.rot), size=t(jscene.size),
                    color=t(jscene.color), kind=t(jscene.kind, torch.int32),
                    plane_z=t(jscene.plane_z),
                    plane_color=t(jscene.plane_color),
                    planes=t(jscene.planes))
    return jscene, scene


def test_convex_render_matches_jax():
    jscene, scene = _convex_scenes()
    jcam = JR.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    cam = R.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    ref = JR.render(jscene, jcam, 32, 64)
    got = raycast.render_batch_cuda(scene, cam, 32, 64, n_convex=1)
    assert got.shape == (1, 32, 64, 3)
    assert _frac_close(got[0].numpy(), ref) > 0.98


def test_camera_rays_match_jax():
    jcam = JR.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    cam = R.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    np.testing.assert_allclose(R.camera_rays(cam, 16, 24).numpy(),
                               np.asarray(JR._camera_rays(jcam, 16, 24)),
                               atol=1e-6)


def test_lift_env_steps_match_jax():
    """reset_to, then 50 steps of one numpy action sequence per env, in both
    envs: states, rewards, success and low-dim obs agree at every step."""
    n, steps = 6, 50
    states = _jax_states(n, seed=1)
    jenv = jlift.LiftEnv(render_images=False)
    env = lift.LiftEnv(render_images=False)
    tstate, tobs = env.reset_to(_to_torch(states))
    _, jobs = jax.vmap(jenv.reset_to)(states)
    rng = np.random.default_rng(0)
    acts = rng.uniform(-1.2, 1.2, size=(steps, n, 7)).astype(np.float32)
    # a descend-and-close phase so grasps engage
    acts[10:25, :, :2] = 0.0
    acts[10:25, :, 2] = -1.0
    acts[18:, :, 6] = 1.0
    jstep = jax.jit(jax.vmap(jenv.step))
    for i in range(steps):
        for k in jobs:
            np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]),
                                       atol=STATE_ATOL, err_msg=f"{k} @ {i}")
        states, jobs, jr, js = jstep(states, jnp.asarray(acts[i]))
        tstate, tobs, r, s = env.step(tstate, torch.from_numpy(acts[i]))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=STATE_ATOL)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tstate.grasped.numpy(),
                                      np.asarray(states.grasped))
        np.testing.assert_allclose(tstate.cube_pos.numpy(),
                                   np.asarray(states.cube_pos),
                                   atol=STATE_ATOL)


def test_reset_draws_in_range():
    env = lift.LiftEnv(render_images=False)
    gen = torch.Generator().manual_seed(3)
    state, obs = env.reset(256, gen)
    xy = state.cube_pos[:, :2]
    assert float(xy.abs().max()) <= 0.1
    assert float(state.cube_yaw.abs().max()) <= np.pi / 6
    assert obs["object"].shape == (256, 10)
    assert not state.grasped.any()


def test_reset_takes_its_device_from_the_generator():
    """``reset`` and ``reset_state`` have no device of their own to default
    to the CPU with: every field of the state, and the observation, lies on
    the device of the generator the caller passes."""
    import inspect
    env = lift.LiftEnv(image_size=8, episode_len=4)
    for fn in (env.reset, env.reset_state):
        assert "device" not in inspect.signature(fn).parameters
    gen = torch.Generator(device="cpu").manual_seed(3)
    state, obs = env.reset(5, gen)
    for f in dataclasses.fields(state):
        assert getattr(state, f.name).device == gen.device, f.name
    assert all(v.device == gen.device for v in obs.values())
    again = env.reset_state(5, torch.Generator(device="cpu").manual_seed(3))
    assert torch.equal(again.cube_pos, state.cube_pos)
    with pytest.raises(AttributeError):
        env.reset_state(5, None)
